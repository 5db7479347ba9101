"""llama-3.2-vision-90b [vlm] — cross-attn image layers (1 per 5)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. Vision tower is a STUB:
input_specs() provides precomputed patch embeddings (B, n_img, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    frontend="patch", n_frontend_tokens=1600,
    use_fsdp=True,
)
