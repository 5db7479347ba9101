"""Config registry of the port: the reference's ten architectures and the
paper's own graph configs, and the dry run's input shapes (copies of
`repro.configs`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import flasheigen
from repro_torch.configs.arctic_480b import CONFIG as arctic_480b
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.configs.grok_1_314b import CONFIG as grok_1_314b
from repro_torch.configs.h2o_danube_3_4b import CONFIG as h2o_danube_3_4b
from repro_torch.configs.hubert_xlarge import CONFIG as hubert_xlarge
from repro_torch.configs.llama_3_2_vision_90b import \
    CONFIG as llama_3_2_vision_90b
from repro_torch.configs.mamba2_780m import CONFIG as mamba2_780m
from repro_torch.configs.mistral_large_123b import \
    CONFIG as mistral_large_123b
from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2_1_5b
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.yi_9b import CONFIG as yi_9b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        grok_1_314b, arctic_480b, hubert_xlarge, llama_3_2_vision_90b,
        yi_9b, qwen2_1_5b, h2o_danube_3_4b, mistral_large_123b,
        recurrentgemma_2b, mamba2_780m,
    ]
}

GRAPHS = flasheigen.GRAPHS


def get(name: str) -> ArchConfig:
    return ARCHS[name]


def reduced(name: str) -> ArchConfig:
    """Smoke-test-scale config of the same family (the reference's rule,
    `repro.configs.reduced`, field for field)."""
    c = ARCHS[name]
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
        capacity_factor=8.0,   # no token dropping at smoke scale
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


__all__ = ["ArchConfig", "ARCHS", "GRAPHS", "SHAPES", "ShapeConfig", "get",
           "reduced", "shape_applicable"]
