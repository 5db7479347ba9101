"""LinearOperator — matrix-free "multiply a TAS block by A".

Port of `repro.core.operator`: `capabilities`, `GraphOperator` (with the
SSD-streamed image) and `DenseOperator`. NormalOperator, HvpOperator
and the spectral transforms come with the rest of the solver family
(ROADMAP queue 1 items 3 and 7).

Operators declare what they can do through `capabilities()`; solvers
dispatch on the declared set instead of sniffing attributes.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Protocol

import torch

from repro_torch.core.tiered import HOST, TieredStore
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


@dataclasses.dataclass
class _ImageSpan:
    """One streamed span of the matrix image: the dense blocks of block
    rows [br_lo, br_hi) live in the store under `name`; its index (block
    columns, rebased row_ptr, the SpMM work plan) stays on the device —
    the paper's split of §3.3.1 (matrix index in fast memory, edge tiles
    on SSD)."""
    name: str
    n_block_rows: int
    n_blocks: int
    block_cols: torch.Tensor
    row_ptr: torch.Tensor
    plan: spmm_tile.Plan


class GraphOperator:
    """Semi-external-memory SpMM operator over a TiledMatrix image.

    Two residency modes for the image, as in the reference:

      * default (stream_image=False): the dense blocks, their block
        columns, the block-row CSR `row_ptr` and the COO remainder are
        copied once to the operator's device and stay there. Every
        matmat accounts the whole image as one slow-tier read against
        the store, so the two packages' I/O counters agree;
      * stream_image=True (requires a store): the image really lives in
        the store's host tier, as read-only entries — block-row spans of
        about `image_chunk_bytes` of dense blocks
        (`TiledMatrix.chunk_block_rows`) and the COO triple as three
        entries. Every matmat walks the spans through
        `TieredStore.stream` (the readahead pool stages the next
        `image_readahead` spans) and runs the SpMM on each span as it
        arrives on the device. Each span's work plan is built once here
        with the whole image's `chunk`, so a span's heavy rows split
        exactly as in the resident plan, and a streamed matmat equals
        the resident one bit for bit. With `TieredStore(backend="safs")`
        subspace and matrix bytes traverse the same page cache.

    The dense part runs the `spmm_blocksparse` kernel on CUDA with the
    image's work plan (`spmm_tile.plan`); the COO side path is plain
    PyTorch (`coo_spmm_ref`, a segment sum whose `index_add_` uses
    atomics on CUDA, so its sum order, and the last bits of Y, change
    from run to run unless deterministic algorithms are on).

    The blocks keep the image's type, float32 or bf16 (numpy's `bfloat16`
    extension type, uploaded as its raw 16-bit words), as in the
    reference; matmat takes and returns float32 either way. `astype`
    makes the bf16 operator of an uploaded float32 image on its device.

    `device=None` takes the store's device, or the CUDA card when there
    is no store (raising when there is none).
    """

    _counter = 0

    def __init__(self, tm: TiledMatrix, *, store: TieredStore | None = None,
                 impl: kops.Impl = "auto", stream_image: bool = False,
                 image_chunk_bytes: int = 4 << 20, image_readahead: int = 2,
                 name: str | None = None, device=None):
        if device is None and store is not None:
            device = store.device
        self.device = resolve_device(device)
        self.n = tm.shape[0]
        self.store = store
        self.impl = impl
        self._image_bytes = tm.nbytes_image()
        self.stream_image = bool(stream_image)
        if self.stream_image:
            if store is None:
                raise ValueError("stream_image=True requires a TieredStore")
            self._init_streamed(tm, image_chunk_bytes, image_readahead, name)
            return
        dev = self.device
        self._blocks = kops.from_numpy(tm.blocks).to(dev)
        self._block_cols = torch.from_numpy(tm.block_cols).to(dev)
        self._row_ptr = torch.from_numpy(tm.row_ptr).to(dev)
        # the SpMM kernel's work plan: heavy block rows split over CTAs
        self._plan = spmm_tile.plan(self._row_ptr)
        self._coo = (torch.from_numpy(tm.coo_rows).to(dev),
                     torch.from_numpy(tm.coo_cols).to(dev),
                     torch.from_numpy(tm.coo_vals).to(dev))

    # ------------------------------------------------- SSD-streamed image
    def _init_streamed(self, tm: TiledMatrix, chunk_bytes: int,
                       readahead: int, name: str | None) -> None:
        GraphOperator._counter += 1
        self._name = name or f"Aimg{GraphOperator._counter}"
        self._bm = tm.block_shape[0]
        self._readahead = int(readahead)
        dev = self.device
        # the whole image's chunk: every span's heavy rows split as in the
        # resident plan, so the partial sums run in the same order
        chunk = spmm_tile.default_chunk(tm.nblocks, spmm_tile.sm_count(dev))
        self._spans: List[_ImageSpan] = []
        for k, (r0, r1, b0, b1) in enumerate(tm.chunk_block_rows(chunk_bytes)):
            sname = f"{self._name}/tiles/c{k}"
            # readonly: the streamed image has no per-span dirty tracking,
            # so writing through a span name must raise, not diverge
            self.store.put(sname, kops.from_numpy(tm.blocks[b0:b1]),
                           tier=HOST, readonly=True)
            row_ptr = torch.from_numpy(tm.row_ptr[r0:r1 + 1]
                                       - tm.row_ptr[r0]).to(dev)
            self._spans.append(_ImageSpan(
                name=sname, n_block_rows=r1 - r0, n_blocks=b1 - b0,
                block_cols=torch.from_numpy(tm.block_cols[b0:b1]).to(dev),
                row_ptr=row_ptr, plan=spmm_tile.plan(row_ptr, chunk=chunk)))
        self._has_coo = tm.coo_vals.size > 0
        if self._has_coo:
            for part in ("coo_rows", "coo_cols", "coo_vals"):
                self.store.put(f"{self._name}/{part}", getattr(tm, part),
                               tier=HOST, readonly=True)

    def _matmat_streamed(self, x: torch.Tensor) -> torch.Tensor:
        k = x.shape[1]
        parts: List[torch.Tensor] = []
        names = [c.name for c in self._spans]
        for c, blocks in zip(self._spans, self.store.stream(
                names, readahead=self._readahead)):
            if c.n_blocks == 0:          # span of empty block rows
                parts.append(torch.zeros((c.n_block_rows * self._bm, k),
                                         dtype=torch.float32,
                                         device=x.device))
                continue
            parts.append(kops.spmm_blocks(blocks, c.block_cols, c.row_ptr,
                                          x, impl=self.impl, plan=c.plan))
        y = (torch.cat(parts) if parts else
             torch.zeros((self.n, k), dtype=torch.float32, device=x.device))
        if self._has_coo:
            y = y + coo_spmm_ref(self.store.get(f"{self._name}/coo_rows"),
                                 self.store.get(f"{self._name}/coo_cols"),
                                 self.store.get(f"{self._name}/coo_vals"),
                                 x, self.n)
        return y

    def delete_image(self) -> None:
        """Drop the spilled image entries (streamed mode only)."""
        if not self.stream_image:
            return
        for c in self._spans:
            self.store.delete(c.name)
        if self._has_coo:
            for part in ("coo_rows", "coo_cols", "coo_vals"):
                self.store.delete(f"{self._name}/{part}")

    def astype(self, dtype: torch.dtype) -> "GraphOperator":
        """This operator over its blocks cast to `dtype` (round to nearest
        even, as numpy's bf16 `astype`) on its device: the operator that
        `GraphOperator` builds from the cast image, sharing this one's
        block columns, row_ptr, plan, COO side path and store, with no
        copy through the host. Its image bytes count the cast blocks.
        A streamed image is cast by building the operator anew."""
        if self.stream_image:
            raise ValueError("astype casts a resident image; build a "
                             "streamed operator from the cast TiledMatrix")
        op = copy.copy(self)
        op._blocks = self._blocks.to(dtype)
        op._image_bytes = self._image_bytes + (
            op._blocks.numel() * op._blocks.element_size()
            - self._blocks.numel() * self._blocks.element_size())
        return op

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="GraphOperator",
                        k=int(x.shape[1]), n=self.n,
                        streamed=self.stream_image,
                        bytes=self._image_bytes):
            if self.stream_image:   # reads counted by the store itself
                return self._matmat_streamed(x)
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
