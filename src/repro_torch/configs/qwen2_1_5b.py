"""qwen2-1.5b [dense] — GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    pattern=("attn",),
    qkv_bias=True, tie_embeddings=True,
)
