"""Tall-skinny GEMM  C = alpha*A@B + beta*C0  on the card: wrapper over
`csrc/tsgemm.cu` (replaces the Pallas `repro.kernels.tsgemm`).

One kernel launch per call; B is copied to shared memory and read into
registers. `variant` picks the kernel from B's shape and the alignment
of A, C0 and C: "vec4x4", "vec4x8" (Krylov–Schur) and "vec8x8" (LOBPCG)
take one row of C per thread with rows of A, C0 and C moved as float4s;
"pair2x2" (the SVD) takes two rows per thread, one float4 each; any
other call takes "generic", one row per thread with scalar loads. Every
variant gives the generic kernel's bits. The C side launches the variant
it is given and refuses one that does not fit. `c0=None` means no C0
term (beta is then ignored). Its plain version is `tsgemm_ref.tsgemm_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require_cuda_f32

LAUNCHES = 0   # kernel launches by this process (chip_smoke reads it)
LAUNCHES_BY_SHAPE: dict[tuple[int, int], int] = {}   # by B's shape (m, b)
LAUNCHES_BY_VARIANT: dict[str, int] = {}             # by `variant`

MAX_B_BYTES = 48 << 10   # B lives in static-size shared memory

# the kernels of csrc/tsgemm.cu, by the id its entry point takes
VARIANTS = {"generic": 0, "vec4x4": 1, "vec4x8": 2, "vec8x8": 3,
            "pair2x2": 4}
_FAST = {(4, 4): "vec4x4", (4, 8): "vec4x8", (8, 8): "vec8x8",
         (2, 2): "pair2x2"}


def variant(m: int, b: int, aligned: bool) -> str:
    """The kernel that computes A (n, m) · B (m, b): a compiled width needs
    A, C0 and C on 16-byte boundaries; anything else takes "generic"."""
    return _FAST.get((m, b), "generic") if aligned else "generic"


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
    kind = variant(m, bc, _build.aligned16(
        a, out, *(() if c0 is None else (c0,))))
    device, stream = _build.device_and_stream(a)
    err = _build.lib().repro_tsgemm_f32(
        a.data_ptr(), b.data_ptr(), 0 if c0 is None else c0.data_ptr(),
        out.data_ptr(), n, m, bc, float(alpha), float(beta), VARIANTS[kind],
        device, stream)
    _build.check(err, f"tsgemm ({kind})")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[m, bc] = LAUNCHES_BY_SHAPE.get((m, bc), 0) + 1
    LAUNCHES_BY_VARIANT[kind] = LAUNCHES_BY_VARIANT.get(kind, 0) + 1
    return out
