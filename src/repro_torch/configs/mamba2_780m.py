"""mamba2-780m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]. Constant-size state ⇒ long_500k runs."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=0, vocab_size=50280, head_dim=64,
    pattern=("ssm",),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True,
    subquadratic=True,
)
