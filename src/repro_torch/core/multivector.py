"""Out-of-core tall-and-skinny MultiVector — the paper's §3.4 subspace.

Port of `repro.core.multivector`. The subspace S ∈ R^{n×m} is stored as
column blocks of width b, each a separate entry in the TieredStore (one
SAFS file per matrix in the paper, §3.4.1), and Table 1's Anasazi
operations are block-streamed. Every whole-subspace operation is one
`core.stream.SubspacePass`:

  * MvScale is lazy — a scalar per block folded into the block's read
    (the paper's lazy evaluation, §3.4.4), zero I/O;
  * `project_out` fuses a whole CGS step (h = Vᵀw, w ← w − V h) into one
    read, so `ortho.bcgs2(fused=True)` runs CGS2 in 2 subspace reads
    where the unfused path pays 4;
  * `compress` computes all restart output blocks in one streamed read
    (multi-accumulator TSGEMM) instead of one pass per output block;
  * the newest block is pinned in the device tier and the just-demoted
    predecessor is host-pinned (§3.4.4).

`mv_random` draws from an explicit `torch.Generator` (the reference's
`jax.random` draws cannot be reproduced in torch; a parity test fills
the blocks with the reference's draw through `set_block`).
"""
from __future__ import annotations

import dataclasses
import re
import threading
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.stream import SubspacePass
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops


# Transient device-accumulator budget for one fused compress pass: every
# output block of the pass stays resident (k·n·4 bytes for k columns).
# Under this cap a compress is exactly one pass; past it the output
# column groups chunk into ceil(k_keep·n·4 / cap) passes.
COMPRESS_PASS_ACC_BYTES = 1 << 30


@dataclasses.dataclass
class _Block:
    name: str
    ncols: int
    scale: float = 1.0   # lazy MvScale factor


class MultiVector:
    """A tall-and-skinny (n × m) matrix as a sequence of column blocks.

    `store=None` builds the MultiVector its own `TieredStore` on
    `backend` ("ram" | "safs") with `backend_opts`, on `device` (the CUDA
    card unless `device="cpu"`). Auto names are `mv<N>`; a name of that
    form given explicitly (a resumed solve's) raises the counter past it,
    so no later auto name takes a live one."""

    _counter = 0
    _counter_lock = threading.Lock()   # concurrent sessions auto-name MVs

    def __init__(self, store: TieredStore | None, n: int, *,
                 name: str | None = None, group_size: int = 8,
                 readahead: int = 2, impl: kops.Impl = "auto",
                 backend="ram", backend_opts: dict | None = None,
                 device=None):
        if name is None:
            with MultiVector._counter_lock:
                MultiVector._counter += 1
                name = f"mv{MultiVector._counter}"
        else:
            # A resumed solve recreates MultiVectors under their
            # checkpointed auto-names; keep the counter ahead of them so
            # later auto-named instances can't collide in a shared store.
            m = re.fullmatch(r"mv(\d+)", name)
            if m:
                with MultiVector._counter_lock:
                    MultiVector._counter = max(MultiVector._counter,
                                               int(m.group(1)))
        if store is None:  # own store on the requested backend ("ram"|"safs")
            store = TieredStore(backend=backend, backend_opts=backend_opts,
                                device=device)
        self.store = store
        self.n = n
        self.name = name
        self.group_size = group_size
        self.readahead = max(1, int(readahead))  # groups announced ahead
        self.impl = impl
        self._blocks: List[_Block] = []

    # ------------------------------------------------------------------ basics
    @property
    def ncols(self) -> int:
        return sum(b.ncols for b in self._blocks)

    @property
    def nblocks(self) -> int:
        return len(self._blocks)

    def block_widths(self) -> List[int]:
        return [b.ncols for b in self._blocks]

    def block_names(self) -> List[str]:
        """Store names of the blocks, in column order."""
        return [b.name for b in self._blocks]

    def _block_name(self, i: int) -> str:
        return self._blocks[i].name

    def _offsets(self) -> List[int]:
        """First column of each block."""
        offs, off = [], 0
        for b in self._blocks:
            offs.append(off)
            off += b.ncols
        return offs

    def block(self, i: int) -> torch.Tensor:
        """Materialize block i: one store read, with any lazy scale
        applied."""
        b = self._blocks[i]
        val = self.store.get(b.name)
        if b.scale != 1.0:
            val = b.scale * val
        return val

    def append_block(self, arr, *, pin_recent: bool = True) -> None:
        """Append a new rightmost block; pins it (most-recent-block cache)
        and demotes the previously pinned block to the host tier, pinning
        the demoted block's pages in the backend page cache (§3.4.4) until
        the next append supersedes it."""
        t = self.store.as_tensor(arr).float().contiguous()
        if t.shape[0] != self.n:
            raise ValueError(f"block has {t.shape[0]} rows, expected {self.n}")
        idx = len(self._blocks)
        name = f"{self.name}/b{idx}"
        self.store.put(name, t)
        if pin_recent:
            if idx > 0:
                prev = self._blocks[-1].name
                self.store.unpin(prev)
                self.store.demote(prev)
                self.store.host_pin(prev)
            self.store.pin(name)
        self._blocks.append(_Block(name, int(t.shape[1])))

    def set_block(self, i: int, arr) -> None:
        """Anasazi SetBlock: overwrite one block in place (its lazy scale
        is reset)."""
        b = self._blocks[i]
        t = self.store.as_tensor(arr).float().contiguous()
        if tuple(t.shape) != (self.n, b.ncols):
            raise ValueError(f"block {i} is ({self.n}, {b.ncols}), got "
                             f"{tuple(t.shape)}")
        self.store.put(b.name, t)
        b.scale = 1.0

    def delete(self) -> None:
        for b in self._blocks:
            self.store.delete(b.name)
        self._blocks.clear()

    # --------------------------------------------------------------- Table 1
    def mv_random(self, generator: torch.Generator,
                  widths: Sequence[int]) -> None:
        """MvRandom: (re)initialize blocks with standard normal values
        drawn from `generator` (on the store's device), block by block."""
        self.delete()
        for w in widths:
            self.append_block(torch.randn(
                (self.n, w), generator=generator, dtype=torch.float32,
                device=self.store.device))

    def mv_scale(self, factors: Sequence[float] | float) -> None:
        """MvScale1 — lazy: fold the scalar into block metadata (zero
        I/O)."""
        if np.isscalar(factors):
            for b in self._blocks:
                b.scale *= float(factors)
            return
        if len(factors) != self.nblocks:
            raise ValueError(f"{len(factors)} factors for {self.nblocks} "
                             f"blocks")
        for b, f in zip(self._blocks, factors):
            b.scale *= float(f)

    def mv_scale_diag(self, vec) -> None:
        """MvScale2: BB <- AA diag(vec) — materializes (per-column
        scales). One streamed pass; each visit writes its scaled block
        back in place."""
        if self.nblocks == 0:
            return
        vec = self.store.as_tensor(vec).float()
        offs = self._offsets()
        p = SubspacePass(self)

        def scale(i, blk, peers):
            w = self._blocks[i].ncols
            self.set_block(i, blk * vec[offs[i]:offs[i] + w][None, :])

        p.add_visit(scale, axis=None)
        p.run()

    def mv_times_mat(self, small: torch.Tensor, *, alpha: float = 1.0,
                     beta: float = 0.0, c0: torch.Tensor | None = None
                     ) -> torch.Tensor:
        """MvTimesMatAddMv: returns alpha * self @ small + beta * c0, where
        small is (m, k). One streamed pass over the blocks."""
        m, k = small.shape
        if m != self.ncols:
            raise ValueError(f"small has {m} rows, subspace {self.ncols}")
        if self.nblocks == 0:
            acc = torch.zeros((self.n, k), dtype=torch.float32,
                              device=self.store.device)
        else:
            p = SubspacePass(self)
            h = p.add_matmul(small, alpha=alpha)
            p.run()
            (acc,) = h.value
        if c0 is not None and beta != 0.0:
            acc = acc + beta * c0
        return acc

    def mv_trans_mv(self, other: torch.Tensor, *, alpha: float = 1.0
                    ) -> torch.Tensor:
        """MvTransMv: alpha * selfᵀ @ other → (m, k), one streamed pass;
        the right operand stays in the device tier."""
        p = SubspacePass(self)
        h = p.add_gram(other, alpha=alpha)
        p.run()
        return h.value

    def project_out(self, w: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One fused CGS step in a single streamed read: per block visit
        h_i = V_iᵀw then w ← w − V_i h_i. Returns (h, w)."""
        p = SubspacePass(self)
        h = p.add_project(w)
        p.run()
        return h.value

    def mv_add_mv(self, alpha: float, other: "MultiVector", beta: float
                  ) -> "MultiVector":
        """MvAddMv: C <- alpha*A + beta*B (blockwise, same block
        structure), both operands streamed in lockstep."""
        if self.block_widths() != other.block_widths():
            raise ValueError("mv_add_mv needs the same block structure")
        out = MultiVector(self.store, self.n, group_size=self.group_size,
                          readahead=self.readahead, impl=self.impl)
        p = SubspacePass(self, peers=[other])

        def emit(i, blk, peers):
            out.append_block(alpha * blk + beta * peers[0], pin_recent=False)

        p.add_visit(emit, axis=None)
        p.run()
        return out

    def mv_dot(self, other: "MultiVector") -> torch.Tensor:
        """MvDot: columnwise dot products vec[i] = selfᵀ[:,i] · other[:,i]."""
        if self.block_widths() != other.block_widths():
            raise ValueError("mv_dot needs the same block structure")
        p = SubspacePass(self, peers=[other])
        h = p.add_dot()
        p.run()
        return h.value

    def mv_norm(self) -> torch.Tensor:
        """MvNorm: column 2-norms."""
        p = SubspacePass(self)
        h = p.add_norm()
        p.run()
        return h.value

    def clone_view(self, idxs: Sequence[int]) -> torch.Tensor:
        """CloneView: gather a set of columns (materialized, one pass)."""
        want = set(int(i) for i in idxs)
        offs = self._offsets()
        p = SubspacePass(self)

        def pick(i, blk, peers):
            local = [j for j in range(blk.shape[1]) if offs[i] + j in want]
            return blk[:, local] if local else None

        h = p.add_visit(pick, axis=1)
        p.run()
        return h.value

    def conv_layout(self) -> torch.Tensor:
        """ConvLayout: column-major subspace block → row-major operand for
        SpMM. A no-op for row-major tensors, kept for API fidelity:
        returns the most recent block materialized."""
        return self.block(self.nblocks - 1)

    # ------------------------------------------------------------ restart ops
    def compress(self, q: torch.Tensor, new_widths: Sequence[int], *,
                 fused: bool = True, pass_acc_bytes: int | None = None
                 ) -> "MultiVector":
        """V_new = V @ Q for restart compression (Krylov–Schur). Q is
        (m, m_new), a tensor or a numpy array; output blocks of widths
        new_widths.

        fused=True: one streamed read computes every output block (chunked
        only past `pass_acc_bytes` of accumulators, default the smaller of
        COMPRESS_PASS_ACC_BYTES and the store's `compress_acc_bytes()`).
        fused=False: one full pass per output block (k_keep/b subspace
        reads), kept for parity tests."""
        q = self.store.as_tensor(q).float()
        if q.shape[0] != self.ncols or sum(new_widths) != q.shape[1]:
            raise ValueError(f"q {tuple(q.shape)} does not map {self.ncols} "
                             f"columns onto {list(new_widths)}")
        out = MultiVector(self.store, self.n, group_size=self.group_size,
                          readahead=self.readahead, impl=self.impl)
        if fused and self.nblocks:
            budget = pass_acc_bytes
            if budget is None:
                # a namespace under a device budget caps the transient
                # accumulators at its share (`compress_acc_bytes`); a
                # plain store keeps the global default
                cap = self.store.compress_acc_bytes()
                budget = (COMPRESS_PASS_ACC_BYTES if cap is None
                          else min(COMPRESS_PASS_ACC_BYTES, cap))
            groups: List[List[int]] = [[]]
            acc = 0
            for w in new_widths:
                if groups[-1] and (acc + w) * self.n * 4 > budget:
                    groups.append([])
                    acc = 0
                groups[-1].append(w)
                acc += w
            off = 0
            for gw in groups:
                k = sum(gw)
                p = SubspacePass(self)
                h = p.add_matmul(q[:, off:off + k], gw)
                p.run()
                for blk in h.value:
                    out.append_block(blk, pin_recent=False)
                off += k
        else:
            off = 0
            for w in new_widths:
                blk = self.mv_times_mat(q[:, off:off + w])
                out.append_block(blk, pin_recent=False)
                off += w
        return out

    def to_dense(self) -> torch.Tensor:
        if self.nblocks == 0:
            return torch.zeros((self.n, 0), dtype=torch.float32,
                               device=self.store.device)
        p = SubspacePass(self)
        h = p.add_visit(lambda i, blk, peers: blk, axis=1)
        p.run()
        return h.value
