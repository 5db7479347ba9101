"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    pattern=("attn",),
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    use_fsdp=True,
)
