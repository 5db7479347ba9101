"""Out-of-core tall-and-skinny MultiVector — the paper's §3.4 subspace.

Port of `repro.core.multivector`, with the operations the Krylov–Schur
path uses. The subspace S ∈ R^{n×m} is stored as column blocks of width b,
each a separate entry in the TieredStore (one SAFS file per matrix in the
paper, §3.4.1). Every whole-subspace operation is one
`core.stream.SubspacePass`:

  * `project_out` fuses a whole CGS step (h = Vᵀw, w ← w − V h) into one
    read, so `ortho.bcgs2(fused=True)` runs CGS2 in 2 subspace reads
    where the unfused path pays 4;
  * `compress` computes all restart output blocks in one streamed read
    (multi-accumulator TSGEMM) instead of one pass per output block;
  * the newest block is pinned in the device tier and the just-demoted
    predecessor is host-pinned (§3.4.4).

Still to port with the rest of the solver family (ROADMAP queue 1 item
4): mv_random, the lazy MvScale factors, mv_scale_diag, mv_add_mv,
set_block, clone_view and the restricted (`block_ids`) walk.
"""
from __future__ import annotations

import threading
from typing import List, Sequence

import torch

from repro_torch.core.stream import SubspacePass
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops


# Transient device-accumulator budget for one fused compress pass: every
# output block of the pass stays resident (k·n·4 bytes for k columns).
# Under this cap a compress is exactly one pass; past it the output
# column groups chunk into ceil(k_keep·n·4 / cap) passes.
COMPRESS_PASS_ACC_BYTES = 1 << 30


class MultiVector:
    """A tall-and-skinny (n × m) matrix as a sequence of column blocks."""

    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(self, store: TieredStore | None, n: int, *,
                 name: str | None = None, group_size: int = 8,
                 readahead: int = 2, impl: kops.Impl = "auto"):
        if name is None:
            with MultiVector._counter_lock:
                MultiVector._counter += 1
                name = f"mv{MultiVector._counter}"
        self.store = store if store is not None else TieredStore()
        self.n = n
        self.name = name
        self.group_size = group_size
        self.readahead = max(1, int(readahead))  # groups announced ahead
        self.impl = impl
        self._names: List[str] = []
        self._widths: List[int] = []

    # ------------------------------------------------------------------ basics
    @property
    def ncols(self) -> int:
        return sum(self._widths)

    @property
    def nblocks(self) -> int:
        return len(self._names)

    def block_widths(self) -> List[int]:
        return list(self._widths)

    def block_names(self) -> List[str]:
        """Store names of the blocks, in column order."""
        return list(self._names)

    def _block_name(self, i: int) -> str:
        return self._names[i]

    def block(self, i: int) -> torch.Tensor:
        """Materialize block i (one store read)."""
        return self.store.get(self._names[i])

    def append_block(self, arr, *, pin_recent: bool = True) -> None:
        """Append a new rightmost block; pins it (most-recent-block cache)
        and demotes the previously pinned block to the host tier, pinning
        the demoted block's pages in the backend page cache (§3.4.4) until
        the next append supersedes it."""
        t = self.store.as_tensor(arr).float().contiguous()
        if t.shape[0] != self.n:
            raise ValueError(f"block has {t.shape[0]} rows, expected {self.n}")
        idx = len(self._names)
        name = f"{self.name}/b{idx}"
        self.store.put(name, t)
        if pin_recent:
            if idx > 0:
                prev = self._names[-1]
                self.store.unpin(prev)
                self.store.demote(prev)
                self.store.host_pin(prev)
            self.store.pin(name)
        self._names.append(name)
        self._widths.append(int(t.shape[1]))

    def delete(self) -> None:
        for name in self._names:
            self.store.delete(name)
        self._names.clear()
        self._widths.clear()

    # --------------------------------------------------------------- Table 1
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

    # ------------------------------------------------------------ restart ops
    def compress(self, q: torch.Tensor, new_widths: Sequence[int], *,
                 fused: bool = True, pass_acc_bytes: int | None = None
                 ) -> "MultiVector":
        """V_new = V @ Q for restart compression (Krylov–Schur). Q is
        (m, m_new); output blocks of widths new_widths.

        fused=True: one streamed read computes every output block (chunked
        only past `pass_acc_bytes` of accumulators, default
        COMPRESS_PASS_ACC_BYTES). fused=False: one full pass per output
        block (k_keep/b subspace reads), kept for parity tests."""
        if q.shape[0] != self.ncols or sum(new_widths) != q.shape[1]:
            raise ValueError(f"q {tuple(q.shape)} does not map {self.ncols} "
                             f"columns onto {list(new_widths)}")
        out = MultiVector(self.store, self.n, group_size=self.group_size,
                          readahead=self.readahead, impl=self.impl)
        if fused and self.nblocks:
            budget = (COMPRESS_PASS_ACC_BYTES if pass_acc_bytes is None
                      else pass_acc_bytes)
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
