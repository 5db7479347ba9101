"""DistOperator — the sharded SEM-SpMM step driven by the core restart loop.

Port of `repro.dist.dist_operator` onto `torch.distributed`. `core.eigsh`
owns the Krylov–Schur restart logic and the out-of-core subspace, while
one expansion — SpMM over the edge panels, CGS2 against V, CholQR2 — runs
as one fused step on every rank of a `comm.Mesh`
(`dspmm.build_eigen_step`).

The reference has one controller process driving a shard_mapped program.
Here every rank is a process, and rank 0 is the controller:

  * every rank constructs the operator with the same arguments (each
    packs its own panel, `dspmm.pack_local_panel`, as the solver's block
    image on its device; `variant` shares it between options) and then
    calls `drive(fn)`: rank 0 runs fn, the unchanged
    restart loop (`solve`/`eigsh`), and owns the `MultiVector` and its
    `TieredStore`, so `IOStats` are counted in one place; every other
    rank serves rank 0's commands (matmat, fused step, reset) until rank
    0 sends shutdown, which it does in a `finally`;
  * each command is a 3-word header broadcast from rank 0; the vectors
    follow as scatters of rank 0's (n_pad, b) blocks into row shards and
    a gather of the result;
  * the *subspace history* V is mirrored on the ranks as their row shards
    of a (nb_v, n_pad, b) stack, reconciled against
    `MultiVector.block_names()`: an append sends only q's shard, and any
    other change (restart compression replaced every block, a fresh
    solve) rebuilds the stack from the store, reading `v.block(i)` as the
    reference does — the only point where subspace bytes come back from
    the store to the ranks;
  * h and r are replicated: every rank all-reduces the same b×b data and
    factors it alike, so they are the same bits everywhere.

`eigsh` discovers the fused path through the declared `fused_expand`
capability (`core.operator.capabilities`; the legacy
`supports_fused_expand` attribute is kept for external callers) and calls
`fused_expand(v, q)`.

Options, as in the reference:

  * `pod_compressed=True` — int8-compressed cross-pod reductions inside
    CGS2/CholQR2 (`compress.compressed_psum_pod`);
  * `compressed=True` — the 6-byte/edge delta-coded panel stream with
    bfloat16 values and subspace stack (sums stay float32).

Trace spans `operator.matmat` and `operator.fused_expand` carry
`collective_bytes`: the bytes of the step's own collectives on rank 0
(`comm.Mesh.program_bytes`), where the reference reads its compiled HLO.
"""
from __future__ import annotations

import collections
import copy
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.operator import CAP_FUSED_EXPAND
from repro_torch.device import resolve_device
from repro_torch.dist import layout
from repro_torch.dist.comm import Mesh
from repro_torch.dist.dspmm import (CHUNK, CompressedPanel, Panel, _groups,
                                    build_dspmm, build_eigen_step,
                                    build_eigen_step_compressed,
                                    design_bytes,
                                    pack_compressed_panels, pack_local_panel)
from repro_torch.obs import trace

# rank 0's commands to the workers (`DistOperator.serve`)
SHUTDOWN, MATMAT, STEP, RESET = range(4)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def default_shape(nd: int) -> tuple:
    """(pod, data, model) for nd ranks: pod stays 1, model takes a factor
    of 2 when nd is even."""
    model = 2 if nd % 2 == 0 and nd > 1 else 1
    return (1, nd // model, model)


def e2e_shape(nd: int) -> tuple:
    """The end-to-end drivers' layout for nd ranks: a multi-pod (2, d, 2)
    when nd allows one — exercising the pod axis the compressed reductions
    target — else `default_shape`."""
    if nd % 4 == 0 and nd >= 4:
        return (2, nd // 4, 2)
    return default_shape(nd)


def default_mesh(device=None) -> Mesh:
    """`default_shape` over the current world (one rank when none is
    initialized). Every rank calls it."""
    return Mesh(default_shape(_world_size()), device=device)


def e2e_mesh(device=None) -> Mesh:
    """Mesh for the end-to-end drivers (example + bench share it, so the
    two cannot drift): `e2e_shape` over the current world."""
    return Mesh(e2e_shape(_world_size()), device=device)


class DistOperator:
    """LinearOperator over the sharded panel SpMM, with the fused
    SpMM+CGS2/CholQR2 expansion hook that `core.eigsh` dispatches to.

    Every rank of `mesh` constructs it with the same arguments. Vertices
    are permuted (`layout.vertex_permutation`) and padded
    (`layout.padded_n`); the operator works in *position* space of size
    `self.n = n_pad`. `nat_to_pad` / `pad_to_nat` map natural-vertex
    vectors in and out (padding rows are zero rows of A, contributing
    eigenvalue 0). `mesh=None` takes `default_mesh(device)`; the operator
    computes on `mesh.device` (the CUDA card unless `device="cpu"`).
    """

    # legacy attribute kept for external callers; solvers dispatch on the
    # declared capability set below (core.operator.capabilities)
    supports_fused_expand = True

    def capabilities(self) -> frozenset:
        return frozenset({CAP_FUSED_EXPAND})

    def __init__(self, n: int, rows, cols, vals, *, mesh: Mesh | None = None,
                 compressed: bool = False, pod_compressed: bool = False,
                 chunk: int = CHUNK, device=None):
        if mesh is None:
            mesh = default_mesh(device)
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device
        r_groups, m_groups = _groups(mesh)
        self.n_logical = int(n)
        self.n = layout.padded_n(n, r_groups, m_groups)
        self.perm = layout.vertex_permutation(self.n, r_groups, m_groups)
        self.s = layout.shard_size(self.n, r_groups, m_groups)
        self.compressed = bool(compressed)
        self.pod_compressed = bool(pod_compressed)

        self.chunk = chunk
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        # this rank's panel [g, m] alone, as `pack_edge_panels` packs it
        self._local = pack_local_panel(
            self.n, self.perm[rows], self.perm[cols], vals,
            r_groups=r_groups, m_groups=m_groups, g=mesh.g, m=mesh.m)
        pc, pr, pv, self.e_loc = self._local
        # the uncompressed panel always lives: matmat (residual checks)
        # contracts it even when the fused step streams the compressed one
        self.panel = Panel(pr, pc, pv, self.n // r_groups,
                           self.n // m_groups, device=self.device)
        self.cpanel: Optional[CompressedPanel] = (
            self._compressed_panel() if self.compressed else None)
        self._reset_state()

    def _compressed_panel(self) -> CompressedPanel:
        """This rank's 6-byte/edge stream. Its panel alone picks its
        sub-tile length (`pack_compressed_panels`), where the reference's
        grid takes the finest any panel needs: the stream decodes alike
        (`_unpack_edges` reads the length from the shapes)."""
        pc, pr, pv, _ = self._local
        packed, bases, vbf16 = pack_compressed_panels(
            pc[None, None], pr[None, None], pv[None, None], chunk=self.chunk)
        return CompressedPanel(packed[0, 0], bases[0, 0], vbf16[0, 0],
                               self.n // self.mesh.r_groups,
                               device=self.device)

    def variant(self, *, compressed: bool = False,
                pod_compressed: bool = False) -> "DistOperator":
        """The same graph on the same mesh with other options, sharing this
        operator's panel image (packed and uploaded once) and, where both
        stream it, its compressed panel. Every rank calls it alike. Its
        subspace mirror, steps and counts start empty."""
        op = copy.copy(self)
        op.compressed, op.pod_compressed = bool(compressed), bool(
            pod_compressed)
        if not op.compressed:
            op.cpanel = None
        elif self.cpanel is None:
            op.cpanel = self._compressed_panel()
        op._reset_state()
        return op

    def _reset_state(self) -> None:
        self._spmm: Dict[int, Callable] = {}      # b -> SpMM
        self._steps: Dict[tuple, Callable] = {}   # (nb_v, b) -> step
        self._names: List[str] = []               # mirrored block names
        # this rank's (nb_v, s, b) rows of the subspace stack, float32, or
        # bf16 for the compressed stream
        self._vstack: Optional[torch.Tensor] = None
        self.n_fused_steps = 0
        self.last_hr: Optional[tuple] = None      # (h, r) of the last step
        # the program collectives' bytes as the design gives them, per
        # rank, beside which `mesh.bytes` is checked (`_expect`)
        self.analytic_bytes: Dict[str, int] = collections.Counter()

    # ------------------------------------------------------- vertex maps
    def nat_to_pad(self, x):
        """Scatter natural-vertex rows into permuted padded positions
        (numpy in, numpy out; a tensor stays on its device)."""
        idx = self.perm[:self.n_logical]
        if isinstance(x, torch.Tensor):
            out = x.new_zeros((self.n,) + tuple(x.shape[1:]),
                              dtype=torch.float32)
            out[torch.as_tensor(idx, device=x.device)] = x.float()
            return out
        out = np.zeros((self.n,) + np.shape(x)[1:], np.float32)
        out[idx] = x
        return out

    def pad_to_nat(self, x):
        """Gather natural-vertex rows out of a padded position vector."""
        idx = self.perm[:self.n_logical]
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(idx, device=x.device)]
        return np.asarray(x)[idx]

    # ------------------------------------------------------ rank control
    def _require_controller(self, what: str) -> None:
        if self.mesh.rank != 0:
            raise RuntimeError(f"{what} is rank 0's (the controller); the "
                               "other ranks serve it (drive)")

    def _command(self, cmd: int, b: int = 0, k: int = 0) -> None:
        if self.mesh.size > 1:
            self.mesh.broadcast(torch.tensor([cmd, b, k], dtype=torch.int64,
                                             device=self._header_device()))

    def _header_device(self) -> torch.device:
        return self.device if self.mesh.backend == "nccl" else torch.device(
            "cpu")

    def serve(self) -> None:
        """A worker's command loop: run rank 0's commands until shutdown."""
        if self.mesh.rank == 0:
            raise RuntimeError("rank 0 is the controller; it does not serve")
        while True:
            hdr = torch.zeros(3, dtype=torch.int64,
                              device=self._header_device())
            cmd, b, k = self.mesh.broadcast(hdr).tolist()
            if cmd == SHUTDOWN:
                return
            if cmd == MATMAT:
                self._matmat_shards(None, b)
            elif cmd == STEP:
                self.mesh.gather(self._step_shards(None, None, b, k))
            elif cmd == RESET:
                self._reset_local()
            else:
                raise RuntimeError(f"unknown command {cmd}")

    def shutdown(self) -> None:
        """Rank 0 ends the workers' command loops."""
        self._require_controller("shutdown")
        self._command(SHUTDOWN)

    def drive(self, fn: Callable, *args, **kwargs):
        """Every rank calls it: rank 0 runs fn(*args, **kwargs) and returns
        its result, sending shutdown in a `finally` (so a controller that
        raises stops its workers); the other ranks serve rank 0's commands
        until then and return None."""
        if self.mesh.rank != 0:
            self.serve()
            return None
        try:
            return fn(*args, **kwargs)
        finally:
            self.shutdown()

    # ----------------------------------------------------------- matmat
    def _spmm_fn(self, b: int) -> Callable:
        fn = self._spmm.get(b)
        if fn is None:
            fn = self._spmm[b] = build_dspmm(self.mesh, n_pad=self.n,
                                             e_loc=self.e_loc, b=b)
        return fn

    def _expect(self, b: int, x_bytes: int, nb_v: int = 0) -> None:
        """Add one SpMM, or with nb_v one fused step, to the design's
        count (`dspmm.design_bytes`)."""
        for kind, n in design_bytes(self.n, *_groups(self.mesh), b=b,
                                    x_bytes=x_bytes, nb_v=nb_v,
                                    pod_compressed=self.pod_compressed
                                    ).items():
            self.analytic_bytes[kind] += n

    def _matmat_shards(self, x, b: int):
        self._expect(b, 4)
        x_loc = self.mesh.scatter(x, (self.s, b))
        return self.mesh.gather(self._spmm_fn(b)(self.panel, x_loc))

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for rank 0's (n_pad, b) X; the workers take part."""
        self._require_controller("matmat")
        b = int(x.shape[1])
        with trace.span("operator.matmat", op="DistOperator", k=b,
                        n=self.n) as sp:
            before = self.mesh.program_bytes()
            self._command(MATMAT, b)
            y = self._matmat_shards(x, b)
            sp.set(collective_bytes=self.mesh.program_bytes() - before)
            return y

    # ------------------------------------------------------- fused step
    def _step_fn(self, nb_v: int, b: int) -> Callable:
        key = (nb_v, b)
        fn = self._steps.get(key)
        if fn is None:
            kw = dict(n_pad=self.n, e_loc=self.e_loc, b=b, nb_v=nb_v,
                      pod_compressed=self.pod_compressed)
            fn = (build_eigen_step_compressed(self.mesh, **kw)[0]
                  if self.compressed else build_eigen_step(self.mesh, **kw))
            self._steps[key] = fn
        return fn

    def _shard(self, block, b: int) -> torch.Tensor:
        dt = torch.bfloat16 if self.compressed else torch.float32
        return self.mesh.scatter(block, (self.s, b)).to(dt)

    def _step_shards(self, v, q, b: int, k: int):
        """Every rank: bring the stack up to date (k = 0: append q's
        shard; k > 0: rebuild it from the k − 1 stored blocks then q),
        then run the fused step on it."""
        if k == 0:
            self._vstack = torch.cat([self._vstack,
                                      self._shard(q, b)[None]])
        else:
            parts = [self._shard(v.block(i) if v is not None else None, b)
                     for i in range(k - 1)]
            self._vstack = torch.stack(parts + [self._shard(q, b)])
        nb_v = self._vstack.shape[0]
        self._expect(b, self._vstack.element_size(), nb_v)
        panel = self.cpanel if self.compressed else self.panel
        q_loc, h, r = self._step_fn(nb_v, b)(panel, self._vstack,
                                             self._vstack[-1])
        self.n_fused_steps += 1
        self.last_hr = (h, r)
        return q_loc

    def fused_expand(self, v, q: torch.Tensor):
        """One combined SpMM + CGS2 + CholQR2 expansion (q already appended
        to v by the caller). Returns (q_next, h_col, r_next) with the exact
        invariant A·q = V·h_col + q_next·r_next, V including q."""
        self._require_controller("fused_expand")
        b = int(q.shape[1])
        with trace.span("operator.fused_expand", op="DistOperator",
                        k=b) as sp:
            before = self.mesh.program_bytes()
            names = v.block_names()
            append = (self._vstack is not None and len(names) >= 1
                      and self._names == names[:-1])
            k = 0 if append else v.nblocks
            self._command(STEP, b, k)
            q_next = self.mesh.gather(self._step_shards(v, q, b, k))
            self._names = names
            h, r = self.last_hr
            sp.set(nb_v=int(self._vstack.shape[0]),
                   collective_bytes=self.mesh.program_bytes() - before)
            return q_next, h, r

    def _reset_local(self) -> None:
        self._names = []
        self._vstack = None

    def reset_subspace(self) -> None:
        """Drop the mirrored stack on every rank (before reusing the
        operator for an unrelated solve)."""
        self._require_controller("reset_subspace")
        self._command(RESET)
        self._reset_local()


def pod_compressed_deviation(n: int, rows, cols, vals, w_reference, *,
                             mesh: Mesh, nev: int, block_size: int,
                             max_restarts: int = 3, tol: float = 1e-9,
                             x0=None, base: "DistOperator | None" = None):
    """Per-restart eigenvalue deviation of the `pod_compressed=True` solve
    against a reference spectrum — shared by the bench, the e2e example
    and the tests so the methodology cannot drift. Every rank calls it;
    rank 0 returns the list, the others None.

    Deviation is compared by |λ|: "LM" keeps the top magnitudes, and a
    power-law graph's near-±pairs make the smallest kept magnitude's sign
    an arbitrary tie. `tol` defaults far below the int8 reduction floor so
    exactly `max_restarts` full cycles are measured. `x0` is the start
    block in position space (`DistOperator.nat_to_pad` of any operator on
    this mesh); without it eigsh draws its own. `base`, an operator over
    the same graph on this mesh, lends its panel (`DistOperator.variant`)
    so the graph is not packed again.
    """
    from repro_torch.core.krylov_schur import eigsh
    w_abs = np.sort(np.abs(np.asarray(w_reference)))
    devs: list = []

    def cb(k, theta, res):
        devs.append(float(np.abs(np.sort(np.abs(theta)) - w_abs).max()))

    dop = (base.variant(pod_compressed=True) if base is not None else
           DistOperator(n, rows, cols, vals, mesh=mesh, pod_compressed=True))
    done = dop.drive(eigsh, dop, nev, block_size=block_size, tol=tol,
                     max_restarts=max_restarts, callback=cb,
                     x0=x0)
    return devs if done is not None else None
