"""Fused streamed subspace passes — §3.4.3's pass minimization made a type.

Port of `repro.core.stream`. Reorthogonalization dominates the solver's
cost, and its cost is streamed reads of the subspace held in the slow
tier. `SubspacePass` attaches any number of consumers (Gram against a
device-resident operand, multi-accumulator TSGEMM, a fused project-out
update, dot/norm reductions, per-block visitors), then `run()` streams
each block of the MultiVector exactly once, handing it to every consumer
in attachment order.

I/O discipline per pass, as in the reference:
  * the pass's block list is announced to `TieredStore.prefetch` up
    front and the window is re-offered as the walk advances;
  * one `TieredStore.get` per block per pass, shared by all consumers
    (lazy MvScale factors are applied once, to the shared value);
  * `TieredStore.begin_pass()` once per run, so `IOStats.passes` counts
    streamed subspace reads and `pass_bytes_read` their bytes.

Peers: a pass may walk other MultiVectors in lockstep (mv_dot,
mv_add_mv); their blocks are interleaved into the announced list and
read at the same visit. `block_ids` restricts the walk to a subset of
blocks (LOBPCG's residual pass reads only X of its [X, W, P] basis).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs import trace


class Handle:
    """Result slot for one consumer; filled when the pass runs."""

    __slots__ = ("_value", "_ready")

    def __init__(self):
        self._ready = False
        self._value = None

    def _set(self, v) -> None:
        self._value = v
        self._ready = True

    @property
    def value(self):
        if not self._ready:
            raise RuntimeError("SubspacePass consumer read before run()")
        return self._value


class _Consumer:
    handle: Handle

    def visit(self, i: int, block: torch.Tensor,
              peers: Sequence[torch.Tensor]) -> None:
        raise NotImplementedError

    def finalize(self):
        raise NotImplementedError


class _Gram(_Consumer):
    """MvTransMv: alpha * Vᵀ @ other, other device-resident (§3.4.3 shared
    I/O — the right operand is read zero times from the slow tier)."""

    def __init__(self, other, alpha, impl):
        self.other, self.alpha, self.impl = other, alpha, impl
        self.parts: List[torch.Tensor] = []
        self.handle = Handle()

    def visit(self, i, block, peers):
        self.parts.append(kops.gram(block, self.other, alpha=self.alpha,
                                    impl=self.impl))

    def finalize(self):
        if not self.parts:
            return torch.zeros((0, self.other.shape[1]), dtype=torch.float32,
                               device=self.other.device)
        return torch.cat(self.parts, dim=0)


class _Matmul(_Consumer):
    """MvTimesMatAddMv with N output accumulators: one streamed read
    computes every column group of `small` (restart compression computes
    all k_keep/b output blocks in the same visit)."""

    def __init__(self, small, row_offsets, out_widths, alpha, n, impl):
        self.small = small
        self.row_offsets = row_offsets      # block index -> row offset
        self.alpha, self.impl = alpha, impl
        self.out_cols: List[slice] = []
        off = 0
        for w in out_widths:
            self.out_cols.append(slice(off, off + w))
            off += w
        self.accs = [torch.zeros((n, w), dtype=torch.float32,
                                 device=small.device) for w in out_widths]
        self.handle = Handle()

    def visit(self, i, block, peers):
        r0 = self.row_offsets[i]
        rows = self.small[r0:r0 + block.shape[1], :]
        for j, cols in enumerate(self.out_cols):
            self.accs[j] = kops.tsgemm(block, rows[:, cols].contiguous(),
                                       alpha=self.alpha, beta=1.0,
                                       c0=self.accs[j], impl=self.impl)

    def finalize(self):
        return self.accs


class _Project(_Consumer):
    """Fused BCGS pass: per visit h_i = V_iᵀw, then w ← w − V_i h_i in the
    same read — one streamed pass where the unfused CGS pass pays two.
    Block-MGS update order; the telescoping w₀ = Σ V_i h_i + w_final keeps
    the Krylov invariant exact."""

    def __init__(self, w, impl):
        self.w, self.impl = w, impl
        self.parts: List[torch.Tensor] = []
        self.handle = Handle()

    def visit(self, i, block, peers):
        h_i = kops.gram(block, self.w, impl=self.impl)
        self.parts.append(h_i)
        self.w = kops.tsgemm(block, h_i, alpha=-1.0, beta=1.0, c0=self.w,
                             impl=self.impl)

    def finalize(self):
        if not self.parts:
            h = torch.zeros((0, self.w.shape[1]), dtype=torch.float32,
                            device=self.w.device)
        else:
            h = torch.cat(self.parts, dim=0)
        return h, self.w


class _Visit(_Consumer):
    """Generic per-block visitor: fn(i, block, peers) -> part or None;
    finalize concatenates collected parts along `axis` (or returns them
    raw with axis=None)."""

    def __init__(self, fn, axis: Optional[int]):
        self.fn, self.axis = fn, axis
        self.parts: List = []
        self.handle = Handle()

    def visit(self, i, block, peers):
        part = self.fn(i, block, peers)
        if part is not None:
            self.parts.append(part)

    def finalize(self):
        if self.axis is None:
            return self.parts
        return torch.cat(self.parts, dim=self.axis)


class SubspacePass:
    """One planned streamed read of a MultiVector feeding many consumers.

    Usage::

        p = SubspacePass(v)
        h = p.add_gram(w)          # handles fill at run()
        p.run()
        g = h.value

    `peers` are MultiVectors with the same block structure walked in
    lockstep. `readahead` is the number of store names kept announced
    ahead of the walk (default: the MultiVector's group-level readahead).

    `block_ids` restricts the walk to a subset of blocks (in the given
    order); visitors still receive the original block index.
    """

    def __init__(self, mv, *, peers: Sequence = (),
                 readahead: int | None = None,
                 block_ids: Sequence[int] | None = None):
        self.mv = mv
        self.peers = list(peers)
        for p in self.peers:
            if p.nblocks != mv.nblocks:
                raise ValueError(f"peer has {p.nblocks} blocks, "
                                 f"pass has {mv.nblocks}")
        self.block_ids = (list(range(mv.nblocks)) if block_ids is None
                          else [int(i) for i in block_ids])
        for i in self.block_ids:
            if not 0 <= i < mv.nblocks:
                raise ValueError(f"block id {i} outside [0, {mv.nblocks})")
        self.store = mv.store
        if readahead is None:
            readahead = mv.readahead * mv.group_size * (1 + len(self.peers))
        self.readahead = max(0, int(readahead))
        self._consumers: List[_Consumer] = []
        self._ran = False

    # ------------------------------------------------------------ consumers
    def _attach(self, c: _Consumer) -> Handle:
        self._consumers.append(c)
        return c.handle

    def add_gram(self, other: torch.Tensor, *, alpha: float = 1.0) -> Handle:
        """h = alpha * selfᵀ @ other → (m, k)."""
        return self._attach(_Gram(other, alpha, self.mv.impl))

    def add_matmul(self, small: torch.Tensor,
                   out_widths: Sequence[int] | None = None, *,
                   alpha: float = 1.0) -> Handle:
        """accs[j] = alpha * self @ small[:, cols_j] — one output
        accumulator per entry of out_widths (default: one output of
        small's full width), all device-resident for the pass. On a
        restricted walk (`block_ids`), `small`'s rows span the visited
        blocks only, stacked in walk order."""
        m, k = small.shape
        widths = self.mv.block_widths()
        m_visited = sum(widths[i] for i in self.block_ids)
        if m != m_visited:
            raise ValueError(f"small has {m} rows, the walk {m_visited}")
        if out_widths is None:
            out_widths = [k]
        if sum(out_widths) != k:
            raise ValueError(f"out_widths {list(out_widths)} != {k} columns")
        offsets, off = {}, 0
        for i in self.block_ids:
            offsets[i] = off
            off += widths[i]
        return self._attach(_Matmul(small, offsets, out_widths, alpha,
                                    self.mv.n, self.mv.impl))

    def add_project(self, w: torch.Tensor) -> Handle:
        """Fused CGS step: returns (h, w − self @ h) from one read."""
        return self._attach(_Project(w, self.mv.impl))

    def add_dot(self) -> Handle:
        """Columnwise dots against peer 0 (MvDot)."""
        if not self.peers:
            raise ValueError("add_dot needs a peer MultiVector")
        return self.add_visit(
            lambda i, blk, peers: torch.sum(blk * peers[0], dim=0), axis=0)

    def add_norm(self) -> Handle:
        """Column 2-norms (MvNorm)."""
        return self.add_visit(
            lambda i, blk, peers: torch.sqrt(torch.sum(blk ** 2, dim=0)),
            axis=0)

    def add_visit(self, fn: Callable, *, axis: Optional[int] = 0) -> Handle:
        """fn(i, block, peers) -> part or None per visit; the parts are
        concatenated along `axis`, or returned as a list with
        axis=None."""
        return self._attach(_Visit(fn, axis))

    # ------------------------------------------------------------------ run
    def _names(self) -> List[str]:
        names = []
        for i in self.block_ids:
            names.append(self.mv._block_name(i))
            for p in self.peers:
                names.append(p._block_name(i))
        return names

    def run(self) -> None:
        """Stream every block once; fill all consumer handles. Single-use:
        consumers accumulate state across visits."""
        if self._ran:
            raise RuntimeError("SubspacePass already ran; build a new pass")
        self._ran = True
        mv = self.mv
        names = self._names()
        read0 = self.store.begin_pass()
        with trace.span("pass.subspace", blocks=len(self.block_ids),
                        consumers=len(self._consumers),
                        peers=len(self.peers)) as sp:
            if names:
                self.store.prefetch(names)  # whole pass announced up front
            pos = 0
            for i in self.block_ids:
                if self.readahead:
                    self.store.prefetch(
                        names[pos + 1:pos + 1 + self.readahead])
                block = mv.block(i)         # lazy MvScale applied once
                pos += 1
                pblocks = []
                for p in self.peers:
                    pblocks.append(p.block(i))
                    pos += 1
                for c in self._consumers:
                    c.visit(i, block, pblocks)
            self.store.end_pass(read0)
            sp.set(bytes=self.store.stats.host_bytes_read - read0)
        for c in self._consumers:
            c.handle._set(c.finalize())
