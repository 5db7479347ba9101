"""Compressed cross-pod reduction (paper §3.4: trade a little precision
for a lot of slow-link I/O). Port of `repro.dist.compress`.

Inter-pod links are the "SSD" of the collective hierarchy, so the small
dense reductions of the eigensolver (Gram matrices, projection
coefficients) cross pods as scaled int8 instead of float32: 4× fewer wire
bytes for a bounded, tested error. The codes and their int32 sum are
exact, so the result is the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def compressed_psum_pod(v: torch.Tensor, mesh) -> torch.Tensor:
    """int8-scaled sum of v over the mesh's pod axis (every rank calls it).

    Every participant quantizes to round(v / scale) with the shared scale
    absmax/127 (absmax taken over the whole group, so no participant
    clips); the int8 payloads are summed exactly in int32 and rescaled.
    Per-element error is at most scale/2 per participant, i.e.
    n_pods · absmax / 254 in all. A pod axis of one rank still rounds, as
    in the reference.
    """
    absmax = mesh.all_reduce(torch.max(torch.abs(v)).reshape(1), "pod",
                             op="max")[0]
    # XLA compiles the reference's absmax / 127.0 into a product with the
    # float32 reciprocal; the same product gives the same scale, bit for bit
    scale = absmax * torch.tensor(1.0 / 127.0, dtype=absmax.dtype,
                                  device=absmax.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(v / safe).to(torch.int8)
    total = mesh.all_reduce(q.to(torch.int32), "pod")
    return total.to(v.dtype) * safe


# ----------------------------------------------------- point compression
def int8_quantize(x: torch.Tensor):
    """x -> (int8 codes, scalar scale), |dequantize - x| <= scale / 2."""
    scale = torch.max(torch.abs(x)) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(x / safe).to(torch.int8), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class TopKState(NamedTuple):
    """Error-feedback residual: mass not yet transmitted."""
    error: torch.Tensor


def topk_init(g: torch.Tensor) -> TopKState:
    return TopKState(error=torch.zeros_like(g))


def topk_compress(g: torch.Tensor, state: TopKState, *, k: int):
    """Top-k sparsification with error feedback (memory-compensated SGD).

    The untransmitted residual is folded into the next call, so a constant
    gradient is fully delivered over time even with k << n.
    Returns (values, indices, new_state).
    """
    corrected = g + state.error
    _, idx = torch.topk(torch.abs(corrected), k)
    vals = corrected[idx]
    sent = torch.zeros_like(corrected).index_put_((idx,), vals)
    return vals, idx, TopKState(error=corrected - sent)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor,
                    shape: tuple) -> torch.Tensor:
    return torch.zeros(shape, dtype=vals.dtype,
                       device=vals.device).index_put_((idx,), vals)
