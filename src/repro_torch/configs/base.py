"""Architecture config schema: a copy of `repro.configs.base.ArchConfig`.

The port keeps its own copy so that it imports nothing of the JAX
package. `ShapeConfig` and `SHAPES` (the dry-run's input shapes) wait
for the compile-analysis tooling, ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads
    # attention
    attn_kind: str = "full"          # full | swa
    window: int = 4096
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    # layer pattern, repeated to n_layers (remainder applied unscanned)
    pattern: Tuple[str, ...] = ("attn",)   # attn | swa | cross | ssm | rglru
    # moe
    n_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0                # expert hidden size (0 → d_ff)
    dense_residual: bool = False     # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_conv: int = 4
    # rglru
    rglru_width: int = 0             # 0 → d_model
    # frontend stubs
    frontend: str | None = None      # patch | audio | None
    n_frontend_tokens: int = 0       # image tokens (vlm)
    # norm / act
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    glu: bool = True
    tie_embeddings: bool = False
    # numerics / distribution
    param_dtype: str = "bfloat16"
    use_fsdp: bool = False           # shard params over 'data' too (big archs)
    remat: bool = True
    # long-context eligibility (sub-quadratic attention)
    subquadratic: bool = False
    decoder: bool = True             # False → encoder-only (no decode shapes)
    # scan unrolling (1 = while-loop; n_super = fully unrolled — used by the
    # dry-run's FLOP-accounting lowering, where while bodies would be
    # counted once by HloCostAnalysis)
    scan_unroll: int = 1
    # §Perf hillclimb knobs (baseline = paper-faithful-naive = all off)
    moe_decode_regroup: bool = False   # single-group MoE dispatch at S==1
    prefill_last_only: bool = False    # prefill emits last-position logits
    shard_cache_seq: bool = False      # seq-shard KV cache when kv∤model
    bf16_residual: bool = False        # pin residual stream to param dtype
    # (baseline leaks f32 from attention einsums → 2× TP-psum/act bytes)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers % len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        per_layer = {}
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        ffw = d * self.d_ff * (3 if self.glu else 2)
        dff_e = self.moe_d_ff or self.d_ff
        moe = self.n_experts * d * dff_e * (3 if self.glu else 2) \
            + d * self.n_experts
        if self.dense_residual:
            moe += ffw
        d_in = self.ssm_expand * d
        ssm = d * (2 * d_in + 2 * self.ssm_state) + d_in * d \
            + d_in * self.ssm_conv
        rw = self.rglru_width or d
        rglru = 2 * d * rw + rw * d + 3 * rw + rw * self.ssm_conv
        per_layer = {"attn": attn + ffw, "swa": attn + ffw,
                     "cross": attn + ffw,
                     "moe_attn": attn + moe,
                     "ssm": ssm + ffw if self.d_ff else ssm,
                     "rglru": rglru + ffw}
        kinds = [("moe_attn" if self.n_experts and k == "attn" else k)
                 for k in self.pattern]
        full_reps = [per_layer[k] for k in kinds]
        total += self.n_super * sum(full_reps)
        total += sum(full_reps[:self.n_remainder])
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D roofline)."""
        if not self.n_experts:
            return self.param_count()
        dff_e = self.moe_d_ff or self.d_ff
        unused = (self.n_experts - self.top_k) * self.d_model * dff_e \
            * (3 if self.glu else 2)
        return self.param_count() - self.n_layers * unused
