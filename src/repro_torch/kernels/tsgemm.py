"""Tall-skinny GEMM  C = alpha*A@B + beta*C0  on the card: wrapper over
`csrc/tsgemm.cu` (replaces the Pallas `repro.kernels.tsgemm`).

One kernel launch per call, one thread per row of C; B is copied to
shared memory and read into registers, and at the solver's widths, (4, 4)
and (4, 8), rows of A, C0 and C move as float4s. `c0=None` means no C0
term (beta is then ignored). Its plain version is `tsgemm_ref.tsgemm_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require_cuda_f32

LAUNCHES = 0   # kernel launches by this process (chip_smoke reads it)

MAX_B_BYTES = 48 << 10   # B lives in static-size shared memory


def tsgemm(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor | None = None,
           alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """C = alpha*A@B + beta*C0 with A (n, m), B (m, b), C0 (n, b)."""
    global LAUNCHES
    tensors = {"a": a, "b": b} if c0 is None else {"a": a, "b": b, "c0": c0}
    dev = require_cuda_f32("tsgemm", **tensors)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tsgemm: A {tuple(a.shape)} and B {tuple(b.shape)} "
                         f"must be (n, m) and (m, b)")
    n, m = a.shape
    bc = b.shape[1]
    if c0 is not None and tuple(c0.shape) != (n, bc):
        raise ValueError(f"tsgemm: C0 {tuple(c0.shape)} must be ({n}, {bc})")
    if m * bc * 4 > MAX_B_BYTES:
        raise ValueError(f"tsgemm: B ({m}, {bc}) exceeds {MAX_B_BYTES} bytes "
                         f"of shared memory")
    out = torch.empty((n, bc), dtype=torch.float32, device=dev)
    if n * bc == 0:
        return out
    device, stream = _build.device_and_stream(a)
    err = _build.lib().repro_tsgemm_f32(
        a.data_ptr(), b.data_ptr(), 0 if c0 is None else c0.data_ptr(),
        out.data_ptr(), n, m, bc, float(alpha), float(beta), device, stream)
    _build.check(err, "tsgemm")
    LAUNCHES += 1
    return out
