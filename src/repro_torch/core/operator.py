"""LinearOperator — matrix-free "multiply a TAS block by A".

Port of `repro.core.operator`: `capabilities`, `GraphOperator` (without
the SSD-streamed image) and `DenseOperator`. NormalOperator, HvpOperator
and the spectral transforms come with the rest of the solver family
(ROADMAP queue 1 items 4 and 8).

Operators declare what they can do through `capabilities()`; solvers
dispatch on the declared set instead of sniffing attributes.
"""
from __future__ import annotations

import copy
from typing import Protocol

import torch

from repro_torch.core.tiered import TieredStore
from repro_torch.device import resolve_device
from repro_torch.graphs.tiles import TiledMatrix
from repro_torch.kernels import ops as kops
from repro_torch.kernels import spmm_tile
from repro_torch.kernels.spmm_ref import coo_spmm_ref
from repro_torch.obs import trace


class LinearOperator(Protocol):
    n: int  # problem size (rows of padded operand)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for a TAS block X (n, b)."""
        ...


#   CAP_FUSED_EXPAND        the operator runs one whole expansion step
#                           (SpMM + CGS2 + CholQR2) itself via
#                           `fused_expand(v, q)` — the sharded operator.
#   CAP_SPECTRAL_TRANSFORM  matmat applies f(A), not A.
CAP_FUSED_EXPAND = "fused_expand"
CAP_SPECTRAL_TRANSFORM = "spectral_transform"


def capabilities(op) -> frozenset:
    """The operator's declared capability set (a `capabilities` method or
    attribute; none declared is the empty set)."""
    declared = getattr(op, "capabilities", None)
    if declared is None:
        return frozenset()
    return frozenset(declared() if callable(declared) else declared)


class GraphOperator:
    """Semi-external-memory SpMM operator over a TiledMatrix image.

    The dense blocks, their block columns, the block-row CSR `row_ptr`
    and the COO remainder are copied once to the operator's device and
    stay there. Every matmat accounts the whole image as one slow-tier
    read against the store, exactly as the reference's default
    (non-streamed) mode does, so the two packages' I/O counters agree.
    The dense part runs the `spmm_blocksparse` kernel on CUDA, with the
    image's work plan (`spmm_tile.plan`) built once here; the COO side
    path is plain PyTorch (`coo_spmm_ref`, a segment sum whose
    `index_add_` uses atomics on CUDA, so its sum order, and the last
    bits of Y, change from run to run).

    The blocks keep the image's type, float32 or bf16 (numpy's `bfloat16`
    extension type, uploaded as its raw 16-bit words), as in the
    reference; matmat takes and returns float32 either way. `astype`
    makes the bf16 operator of an uploaded float32 image on its device.

    `device=None` takes the store's device, or the CUDA card when there
    is no store (raising when there is none).
    """

    def __init__(self, tm: TiledMatrix, *, store: TieredStore | None = None,
                 impl: kops.Impl = "auto", stream_image: bool = False,
                 device=None):
        if stream_image:
            raise NotImplementedError(
                "GraphOperator(stream_image=True) needs the SAFS tier: "
                "ROADMAP.md queue 1 item 3")
        if device is None and store is not None:
            device = store.device
        self.device = resolve_device(device)
        self.n = tm.shape[0]
        self.store = store
        self.impl = impl
        self._image_bytes = tm.nbytes_image()
        dev = self.device
        self._blocks = kops.from_numpy(tm.blocks).to(dev)
        self._block_cols = torch.from_numpy(tm.block_cols).to(dev)
        self._row_ptr = torch.from_numpy(tm.row_ptr).to(dev)
        # the SpMM kernel's work plan: heavy block rows split over CTAs
        self._plan = spmm_tile.plan(self._row_ptr)
        self._coo = (torch.from_numpy(tm.coo_rows).to(dev),
                     torch.from_numpy(tm.coo_cols).to(dev),
                     torch.from_numpy(tm.coo_vals).to(dev))

    def astype(self, dtype: torch.dtype) -> "GraphOperator":
        """This operator over its blocks cast to `dtype` (round to nearest
        even, as numpy's bf16 `astype`) on its device: the operator that
        `GraphOperator` builds from the cast image, sharing this one's
        block columns, row_ptr, plan, COO side path and store, with no
        copy through the host. Its image bytes count the cast blocks."""
        op = copy.copy(self)
        op._blocks = self._blocks.to(dtype)
        op._image_bytes = self._image_bytes + (
            op._blocks.numel() * op._blocks.element_size()
            - self._blocks.numel() * self._blocks.element_size())
        return op

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="GraphOperator",
                        k=int(x.shape[1]), n=self.n, streamed=False,
                        bytes=self._image_bytes):
            if self.store is not None:  # account the matrix image stream
                self.store.account_read(self._image_bytes)
            y = kops.spmm_blocks(self._blocks, self._block_cols,
                                 self._row_ptr, x, impl=self.impl,
                                 plan=self._plan)
            rows, cols, vals = self._coo
            if vals.shape[0]:
                y = y + coo_spmm_ref(rows, cols, vals, x, self.n)
            return y


class DenseOperator:
    """Small dense operator (oracle in tests)."""

    def __init__(self, a, *, device=None):
        self.device = resolve_device(device)
        self.a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self.n = self.a.shape[0]

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="DenseOperator",
                        k=int(x.shape[1]), n=self.n):
            return self.a @ x
