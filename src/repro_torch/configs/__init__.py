"""Config registry of the port (copy of `repro.configs`, yi-9b only).

The LM side of the port runs dense GQA models so far. The reference's
other architectures need layers the port does not have yet (MoE, SSM,
RG-LRU, sliding-window and cross-attention, audio and patch frontends):
`get` and `reduced` raise `NotImplementedError` for them, naming
ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.yi_9b import CONFIG as yi_9b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [yi_9b]}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise NotImplementedError(
            f"config {name!r} is not ported: the port runs "
            f"{sorted(ARCHS)}; the other architectures' layers are "
            f"ROADMAP.md queue 1 item 7")
    return ARCHS[name]


def reduced(name: str) -> ArchConfig:
    """Smoke-test-scale config of the same family (the reference's rule,
    `repro.configs.reduced`, field for field)."""
    c = get(name)
    pat = len(c.pattern)
    kv = max(1, min(c.n_kv_heads, 2))
    heads = max(kv, 4 - (4 % kv))
    return dataclasses.replace(
        c,
        name=c.name + "-reduced",
        n_layers=pat + min(2, max(1, c.n_layers % pat or 2)),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if c.d_ff == 0 else 128,
        moe_d_ff=0 if c.moe_d_ff == 0 else 96,
        vocab_size=256,
        n_experts=0 if c.n_experts == 0 else 4,
        capacity_factor=8.0,
        window=32,
        ssm_state=0 if c.ssm_state == 0 else 16,
        ssm_head_dim=16,
        ssm_chunk=8,
        rglru_width=0 if c.rglru_width == 0 else 64,
        n_frontend_tokens=0 if c.n_frontend_tokens == 0 else 16,
        param_dtype="float32",
        use_fsdp=False,
        remat=False,
    )


__all__ = ["ArchConfig", "ARCHS", "get", "reduced"]
