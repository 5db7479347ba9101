"""Gram / projection  G = alpha * AᵀB  on the card: wrapper over
`csrc/gram.cu` (replaces the Pallas `repro.kernels.gram`).

One kernel launch per call. Rows are split into at most `MAX_PARTS`
contiguous intervals of at least `MIN_ROWS_PER_PART` rows, one CTA each;
each CTA writes its (m×b) partial to scratch, and the CTA that draws the
last ticket from an integer counter sums the partials in a fixed order.
The counter is one int32 per (device, stream), made here at the first
call on that stream and set back to 0 by every launch. Any n is allowed:
the reference's `n % row_interval == 0` rule was a TPU tiling rule.

`variant` picks the kernel from G's shape and the pointers' alignment:
"vec4x4" (Krylov–Schur), "tile2x2" / "tile8x8" / "tile16x16" /
"tile24x24" (the SVD's and LOBPCG's Grams: every row read once, staged
through shared memory), else "generic". The C side launches the variant
it is given and refuses one that does not fit. Its plain version is
`gram_ref.gram_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require_cuda_f32

LAUNCHES = 0   # kernel launches by this process (chip_smoke reads it)
LAUNCHES_BY_SHAPE: dict[tuple[int, int], int] = {}   # by G's shape (m, b)
LAUNCHES_BY_VARIANT: dict[str, int] = {}             # by `variant`

# the kernels of csrc/gram.cu, by the id its entry point takes
VARIANTS = {"generic": 0, "vec4x4": 1, "tile2x2": 2, "tile8x8": 3,
            "tile16x16": 4, "tile24x24": 5}
_FAST = {(4, 4): "vec4x4", (2, 2): "tile2x2", (8, 8): "tile8x8",
         (16, 16): "tile16x16", (24, 24): "tile24x24"}

MIN_ROWS_PER_PART = 1024
MAX_PARTS = 256

# (device index, raw stream) -> int32 ticket counter at 0 between launches
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def row_partition(n: int) -> tuple[int, int]:
    """(n_parts, rows_per_part) for n rows — a function of n alone, so the
    order of summation, and the result's bits, depend on the shape only."""
    n_parts = min(-(-n // MIN_ROWS_PER_PART), MAX_PARTS)
    rows_per_part = -(-n // n_parts)
    return -(-n // rows_per_part), rows_per_part


def variant(m: int, b: int, aligned: bool) -> str:
    """The kernel that computes an (m, b) Gram: a compiled width needs A
    and B on 16-byte boundaries; anything else takes "generic"."""
    return _FAST.get((m, b), "generic") if aligned else "generic"


def _counter(device: int, stream: int) -> torch.Tensor:
    """This stream's ticket counter. Made by a fill on the current stream,
    the one the kernel then launches on, so the kernel sees the zero."""
    c = _COUNTERS.get((device, stream))
    if c is None:
        c = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda",
                                                                  device))
        _COUNTERS[(device, stream)] = c
    return c


def gram(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0
         ) -> torch.Tensor:
    """G = alpha * AᵀB with A (n, m), B (n, b), float32 → (m, b)."""
    global LAUNCHES
    dev = require_cuda_f32("gram", a=a, b=b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"gram: A {tuple(a.shape)} and B {tuple(b.shape)} "
                         f"must be (n, m) and (n, b)")
    n, m = a.shape
    bc = b.shape[1]
    if n == 0 or m * bc == 0:
        return torch.zeros((m, bc), dtype=torch.float32, device=dev)
    n_parts, rows_per_part = row_partition(n)
    partials = torch.empty(n_parts * m * bc, dtype=torch.float32, device=dev)
    out = torch.empty((m, bc), dtype=torch.float32, device=dev)
    kind = variant(m, bc, _build.aligned16(a, b))
    device, stream = _build.device_and_stream(a)
    err = _build.lib().repro_gram_f32(
        a.data_ptr(), b.data_ptr(), partials.data_ptr(),
        _counter(device, stream).data_ptr(), out.data_ptr(), n, m, bc,
        n_parts, rows_per_part, float(alpha), VARIANTS[kind], device,
        stream)
    _build.check(err, f"gram ({kind})")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[m, bc] = LAUNCHES_BY_SHAPE.get((m, bc), 0) + 1
    LAUNCHES_BY_VARIANT[kind] = LAUNCHES_BY_VARIANT.get(kind, 0) + 1
    return out
