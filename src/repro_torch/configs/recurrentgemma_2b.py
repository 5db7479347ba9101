"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427; hf]. Recurrent state + windowed cache ⇒ long_500k runs."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    pattern=("rglru", "rglru", "swa"), window=2048,
    rglru_width=2560,
    act="gelu", tie_embeddings=True,
    subquadratic=True,
)
