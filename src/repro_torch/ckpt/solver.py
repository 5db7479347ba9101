"""Checkpoint-suspend/resume of long eigensolves (port of
`repro.ckpt.solver`).

A billion-node spectral solve is hours of wall clock (paper §4) — it WILL
be preempted. The thick-restart compression already shrinks the live
state to k·n vectors plus a few-MB projected problem, so the restart
boundary is the natural (and only) snapshot point: nothing in flight,
subspace freshly compressed.

One checkpoint = one composite directory under `CheckpointPolicy.root`:

    root/pages/step_XXXXXXXXXX/   SAFS page snapshot of the subspace
                                  (`ckpt.save_safs`: flush + kernel-side
                                  file copy) — written FIRST; absent for
                                  the ram backend, whose blocks embed in
                                  the state arrays;
    root/state/step_XXXXXXXXXX/   the solver's small dense state (H, Ritz
                                  values/residuals, coupling block,
                                  counters) via `ckpt.save`'s atomic
                                  manifest — written LAST, so the state
                                  manifest IS the commit point.

A crash between the two leaves an orphaned page snapshot; `load` skips any
state-less step and falls back to the previous committed one.

Resume is a *bit-identical continuation*: the subspace blocks, H, the
in-flight block q and every counter are restored exactly, so a resumed
solve walks the same restart trajectory as an uninterrupted one, as long
as every operation it runs is deterministic (on the card the COO side
path's `index_add_` is not, unless `torch.use_deterministic_algorithms`
is on).

The format is the reference's, so either package resumes the other's
snapshots. Tensors on the card are copied to the host when saved; on
load the blocks are rebuilt on the store's device and demoted, which
puts them in pinned host memory on a CUDA RAM tier. A MultiVector's
`impl` is written as a string both packages take ("auto" or "ref"); the
reference's "pallas" and "interpret" resume as "auto".

`ft.PreemptionGuard` integration: pass the guard in the policy; at each
restart boundary the checkpointer finishes the snapshot and raises
`SolveSuspended` when a SIGTERM arrived mid-restart. Fault-plan
integration: when the store's backend carries a `safs.faults.FaultPlan`,
the checkpointer consults it at its own two sites — `solve.restart` (the
boundary itself) and `ckpt.save` (between the page snapshot and the
state commit).
"""
from __future__ import annotations

import dataclasses
import json
import os
import urllib.parse
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ck
from repro_torch.obs import trace

# a snapshot's MultiVector impl string → the port's Impl
_IMPL_FROM_SNAPSHOT = {"auto": "auto", "ref": "ref", "pallas": "auto",
                       "interpret": "auto"}


@dataclasses.dataclass
class CheckpointPolicy:
    """When/where to checkpoint a solve.

    root: composite checkpoint directory (pages/ + state/ subtrees).
    every_restarts: snapshot cadence in restart boundaries (1 = every
        boundary; 0 disables periodic snapshots, leaving only
        preemption-triggered ones).
    keep: committed checkpoints retained per subtree (`ckpt.gc_old`).
    guard: an `ft.PreemptionGuard` (or anything with `requested()`);
        when it fires, the next boundary checkpoints then raises
        `SolveSuspended`.
    """
    root: str
    every_restarts: int = 1
    keep: int = 3
    guard: Optional[object] = None


class SolveSuspended(RuntimeError):
    """A solve checkpointed and stopped on preemption — not a failure.
    Carries the committed step and the checkpoint root; rerun with
    `solve(..., resume=root)` to continue."""

    def __init__(self, step: int, root: str):
        super().__init__(
            f"solve suspended at step {step}; resume from {root!r}")
        self.step = step
        self.root = root


@dataclasses.dataclass
class ResumeState:
    """What `SolveCheckpointer.load` hands back to the algorithm: the
    committed step, the rebuilt out-of-core MultiVectors (already living
    in the caller's store) and the small dense state (numpy arrays)."""
    step: int
    mvs: Dict[str, Any]
    arrays: Dict[str, np.ndarray]
    extra: Dict[str, Any]


def _state_root(root: str) -> str:
    return os.path.join(root, "state")


def _pages_root(root: str) -> str:
    return os.path.join(root, "pages")


def _load_tree(root: str, step: int) -> tuple:
    """Read one committed `ckpt.save` checkpoint back as a nested dict of
    numpy arrays (manifest names are '/'-joined paths) — no `like`
    template needed: the resuming solver does not have the shapes yet."""
    path = os.path.join(root, f"step_{step:010d}")
    with open(os.path.join(path, ck.MANIFEST)) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, name in enumerate(manifest["names"]):
            parts = name.split("/")
            d = tree
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = z[f"a{i}"]
    return tree, manifest["extra"]


def _snapshot_block(snap_dir: str, data_id: str,
                    integrity=None) -> torch.Tensor:
    """Assemble one subspace block straight out of a page snapshot's
    PageFile, as a CPU tensor. Reads verify against the snapshot's copied
    checksum block: a rotten snapshot page raises CorruptPageError here
    rather than resuming garbage (normally pre-empted by the manifest
    hash check in `load`, which falls back to an older step)."""
    from repro_torch.safs.pagefile import PageFile
    path = os.path.join(snap_dir,
                        urllib.parse.quote(data_id, safe="") + ".pages")
    pf = PageFile(path, integrity=integrity)
    try:
        return pf.assemble(pf.read_pages_batch(list(pf.page_indices())))
    finally:
        pf.close()


def _is_safs(store) -> bool:
    from repro_torch.safs.backend import SafsBackend
    return isinstance(getattr(store, "backend", None), SafsBackend)


class SolveCheckpointer:
    """The solver-side half of checkpoint/suspend/resume.

    Algorithms call `maybe_checkpoint(store, step, state_fn)` at each
    restart boundary with a zero-argument `state_fn` returning

        {"mvs":    {slot: MultiVector, ...},     # out-of-core state
         "arrays": {name: array or tensor},      # small dense state
         "extra":  {name: json-scalar, ...}}     # counters/flags

    — `state_fn` only runs when a snapshot is actually due. `load(store)`
    rebuilds the newest committed checkpoint into `store` (safs snapshots
    rehydrate block by block from the page files, ram checkpoints embed
    the blocks in the state arrays) and refuses a checkpoint written by a
    different method or solve shape (`params` mismatch).
    """

    def __init__(self, policy: Optional[CheckpointPolicy], *, method: str,
                 resume_from: Optional[str] = None,
                 params: Optional[dict] = None):
        if policy is None and resume_from is None:
            raise ValueError("need a CheckpointPolicy and/or resume root")
        if policy is None:
            # resume-only: continue WITHOUT further checkpoints
            policy = CheckpointPolicy(root=resume_from, every_restarts=0)
        self.policy = policy
        self.method = method
        self.resume_from = resume_from
        self.params = dict(params or {})
        self.saved_steps: List[int] = []
        self.resumed_step: Optional[int] = None

    # ------------------------------------------------------------- plumbing
    @staticmethod
    def _plan(store):
        return getattr(getattr(store, "backend", None), "faults", None)

    def _preempted(self) -> bool:
        g = self.policy.guard
        return g is not None and bool(g.requested())

    # ----------------------------------------------------------------- save
    def maybe_checkpoint(self, store, step: int,
                         state_fn: Callable[[], dict]) -> bool:
        """Snapshot at a restart boundary when due (cadence) or demanded
        (preemption). Raises `SolveSuspended` after a preemption-triggered
        snapshot commits. Returns whether a snapshot was written."""
        plan = self._plan(store)
        if plan is not None:
            # the boundary itself is an injectable site: a "crash" rule
            # here simulates a kill between restarts (no snapshot written)
            plan.check("solve.restart", step=step)
        preempt = self._preempted()
        every = self.policy.every_restarts
        due = every > 0 and step % every == 0
        if not (due or preempt):
            return False
        self.save(store, step, state_fn())
        if preempt:
            raise SolveSuspended(step, self.policy.root)
        return True

    def save(self, store, step: int, state: dict) -> None:
        mvs: Dict[str, Any] = state.get("mvs", {})
        arrays: Dict[str, Any] = dict(state.get("arrays", {}))
        extra: Dict[str, Any] = dict(state.get("extra", {}))
        safs = _is_safs(store)
        mv_meta = {
            slot: {"name": mv.name, "n": int(mv.n),
                   "widths": [int(w) for w in mv.block_widths()],
                   "scales": [float(b.scale) for b in mv._blocks],
                   "group_size": int(mv.group_size), "impl": str(mv.impl)}
            for slot, mv in mvs.items()}
        with trace.span("ckpt.save", step=step, backend=(
                "safs" if safs else "ram")) as sp:
            tree: Dict[str, Any] = {"arrays": arrays}
            if safs:
                # pages FIRST: an orphaned page snapshot is harmless, a
                # state manifest pointing at missing pages would not be
                ck.save_safs(_pages_root(self.policy.root), step, store,
                             extra={"mv_meta": mv_meta})
                plan = self._plan(store)
                if plan is not None:
                    # the crash window between snapshot halves
                    plan.check("ckpt.save", step=step)
            else:
                # ram backend: embed the blocks (raw store bytes, copied
                # to the host by ck.save; lazy scales live in mv_meta)
                tree["blocks"] = {
                    slot: {f"b{i}": store.get(name)
                           for i, name in enumerate(mv.block_names())}
                    for slot, mv in mvs.items()}
            ck.save(_state_root(self.policy.root), step, tree, extra={
                "method": self.method, "params": self.params,
                "backend": "safs" if safs else "ram",
                "mv_meta": mv_meta, "solver_extra": extra,
                "io_stats": store.stats.as_dict(),
            })
            sp.set(committed=True)
        self.saved_steps.append(step)
        if self.policy.keep:
            ck.gc_old(_state_root(self.policy.root), keep=self.policy.keep)
            if safs:
                ck.gc_old(_pages_root(self.policy.root),
                          keep=self.policy.keep)

    # ----------------------------------------------------------------- load
    def load(self, store) -> Optional[ResumeState]:
        """Rebuild the newest committed checkpoint into `store`; None when
        not resuming or the root holds no committed checkpoint yet (a
        crash before the first snapshot — the solve just starts over)."""
        if self.resume_from is None:
            return None
        root = self.resume_from
        sroot = _state_root(root)
        # latest_step (not valid_steps) on the commit subtree: the restart
        # path doubles as the stale-tmp garbage collector
        if ck.latest_step(sroot) is None:
            return None
        for step in reversed(ck.valid_steps(sroot)):
            tree, extra = _load_tree(sroot, step)
            if extra.get("method") != self.method:
                raise ValueError(
                    f"checkpoint at {root!r} was written by method "
                    f"{extra.get('method')!r}, not {self.method!r}")
            saved = extra.get("params", {})
            clash = {k: (saved.get(k), v) for k, v in self.params.items()
                     if k in saved and saved[k] != v}
            if clash:
                raise ValueError(
                    f"checkpoint params mismatch at step {step}: {clash}")
            snap = None
            if extra.get("backend") == "safs":
                snap = os.path.join(_pages_root(root), f"step_{step:010d}")
                if not os.path.exists(os.path.join(snap, ck.MANIFEST)):
                    continue    # orphan: state committed, pages gc'd/lost
                problems = ck.verify_safs_snapshot(snap)
                if problems:
                    # corrupt/torn snapshot: never a resume source — fall
                    # back to the next-older verified step
                    trace.event("ckpt.corrupt_snapshot", step=step,
                                problems=list(problems))
                    continue
            mvs = self._rebuild_mvs(store, extra["mv_meta"], tree, snap)
            trace.event("ckpt.resume", step=step, method=self.method,
                        backend=extra.get("backend"))
            self.resumed_step = step
            return ResumeState(step=step, mvs=mvs,
                               arrays=tree.get("arrays", {}),
                               extra={**extra.get("solver_extra", {}),
                                      "io_stats": extra.get("io_stats")})
        return None

    @staticmethod
    def _rebuild_mvs(store, mv_meta: dict, tree: dict,
                     snap: Optional[str]) -> Dict[str, Any]:
        from repro_torch.core.multivector import MultiVector
        mvs: Dict[str, Any] = {}
        for slot, meta in mv_meta.items():
            mv = MultiVector(store, meta["n"], name=meta["name"],
                             group_size=meta["group_size"],
                             impl=_IMPL_FROM_SNAPSHOT[meta["impl"]])
            resolve = getattr(store, "resolve_data_id", lambda n: n)
            for i, _w in enumerate(meta["widths"]):
                if snap is not None:
                    # the snapshot's page files are keyed by the store-
                    # qualified id (a namespaced session prefixes names)
                    arr = _snapshot_block(
                        snap, resolve(f"{meta['name']}/b{i}"),
                        integrity=getattr(getattr(store, "backend", None),
                                          "integrity", None))
                else:
                    arr = tree["blocks"][slot][f"b{i}"]
                mv.append_block(arr, pin_recent=False)
                # resumed blocks start on the slow tier, like the live
                # solve's history blocks; the solver re-promotes what it
                # actually touches
                store.demote(mv._block_name(i))
                mv._blocks[i].scale = float(meta["scales"][i])
            mvs[slot] = mv
        return mvs
