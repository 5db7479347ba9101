"""hubert-xlarge [audio] — encoder-only, w2v2-style backbone
[arXiv:2106.07447; unverified]. Frontend (conv feature extractor) is a STUB:
input_specs() provides precomputed frame embeddings (B, S, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    pattern=("attn",),
    causal=False, decoder=False,
    norm="layernorm", act="gelu", glu=False,
    frontend="audio",
)
