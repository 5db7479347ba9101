"""Checkpoint/resume in the port against the JAX package.

  * the snapshot format crosses packages both ways: a tree of float32,
    float64, int, bool and bf16 leaves in nested dicts and a list, written
    by either package, restores in the other with equal names, dtypes,
    shapes and bytes;
  * cross-package resume: a solve suspended by a stand-in preemption
    guard in one package resumes in the other, on the RAM and the SAFS
    tier, with eigenvalues at rtol 1e-5 of the writer's own resumed run,
    the same `resumed_step` and equal `IOStats` (Krylov–Schur at tol
    1e-6; LOBPCG at tol 1e-4, since at 1e-5 the reference's float32
    floor on this graph changes its iteration count);
  * a port solve suspended and resumed is bit-equal to the uninterrupted
    one (Krylov–Schur and LOBPCG, RAM and SAFS);
  * the reference's kill matrix (`tests/test_faults.py`) and its
    suspend/resume cases, on the port alone: every resumed solve is held
    to the port's own uninterrupted solve (the reference's LOBPCG rows
    fail, because its uninterrupted solve does not converge);
  * `tests/test_checkpoint.py`'s cases that are not about training, and
    `tests/test_integrity.py`'s checkpoint-sourced repair.
"""
import dataclasses
import json
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.ckpt import checkpoint as rck
from repro.ckpt.solver import CheckpointPolicy as RefPolicy
from repro.ckpt.solver import SolveSuspended as RefSuspended
from repro.graphs import normalized_adjacency, pack_tiles, rmat_graph
import repro_torch.core as P
from repro_torch.ckpt import checkpoint as ck
from repro_torch.ckpt import CheckpointPolicy, SolveSuspended
from repro_torch.convert import tiled_from_arrays
from repro_torch.obs import Tracer, tracing
from repro_torch.safs import (CrashPoint, FaultPlan, FaultRule, RetryPolicy,
                              SafsBackend, SafsIOError, Scrubber,
                              WriteBehindError, flip_bit,
                              newest_verified_step, repair_from_checkpoint)
from repro_torch.safs.scrub import main as scrub_main

RTOL = 1e-5
FAST_RETRY = RetryPolicy(max_attempts=3, base_delay=1e-4, max_delay=1e-3)


@pytest.fixture(scope="module")
def tm():
    """The 400-vertex graph of `tests/test_faults.py`, as the reference's
    TiledMatrix (`tm[0]`) and the port's (`tm[1]`)."""
    n = 400
    r, c, v = rmat_graph(n, 4000, seed=5, symmetric=True)
    r, c, v = normalized_adjacency(n, r, c, v)
    ref = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    return ref, tiled_from_arrays(dataclasses.asdict(ref))


class _Guard:
    """Stand-in for ft.PreemptionGuard with a test-armed flag (signal
    handlers can only be installed from the main thread)."""

    def __init__(self, after):
        self.after = after
        self.n = 0
        self.armed = False

    def requested(self):
        return self.armed

    def cb(self, step, theta, res):
        self.n += 1
        if self.n == self.after:
            self.armed = True


def _port_store(backend, root=None, *, plan=None, write_behind=True,
                cache_bytes=1 << 18, **opts):
    if backend == "ram":
        return P.TieredStore(device="cpu")
    return P.TieredStore(backend="safs", device="cpu", backend_opts={
        "root": root, "cache_bytes": cache_bytes,
        "write_behind": write_behind, "faults": plan, "retry": FAST_RETRY,
        **opts})


def _ref_store(backend, root=None):
    if backend == "ram":
        return R.TieredStore()
    return R.TieredStore(backend="safs", backend_opts={
        "root": root, "cache_bytes": 1 << 18})


def _port_solve(tm, method, store, nev=4, **kw):
    return P.solve(P.GraphOperator(tm[1], store=store), nev, method=method,
                   max_iters=100, store=store, **kw)


def _ref_solve(tm, method, store, nev=4, **kw):
    return R.solve(R.GraphOperator(tm[0], store=store, impl="ref"), nev,
                   method=method, max_iters=100, impl="ref", store=store,
                   **kw)


# ------------------------------------------------------ snapshot format
def _tree_values():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "d": rng.standard_normal(5),
            "b": rng.standard_normal(6).astype(np.float32),
            "step": np.int32(3), "ids": np.arange(7, dtype=np.int64),
            "mask": np.array([True, False, True])}


def _ref_tree(vals):
    return {"layer": {"w": jnp.asarray(vals["w"]),
                      "b": jnp.asarray(vals["b"], jnp.bfloat16)},
            "step": jnp.asarray(vals["step"]),
            "hist": [jnp.asarray(vals["d"]), jnp.asarray(vals["ids"]),
                     {"mask": jnp.asarray(vals["mask"]), "none": None}],
            "count": 11}


def _port_tree(vals, ref_tree):
    bf16_bits = np.array(ref_tree["layer"]["b"]).view(np.uint16)
    return {"layer": {"w": torch.from_numpy(vals["w"]),
                      "b": torch.from_numpy(bf16_bits.view(np.int16))
                      .view(torch.bfloat16)},
            "step": torch.tensor(int(vals["step"]), dtype=torch.int32),
            "hist": [torch.from_numpy(vals["d"]),
                     torch.from_numpy(vals["ids"]),
                     {"mask": torch.from_numpy(vals["mask"]), "none": None}],
            "count": 11}


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a.tobytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_format_crosses_packages(tmp_path, writer):
    """Either package's `save` restores in the other, and the two write
    the same manifest (names, dtypes, shapes) and the same array bytes
    for the same tree. (JAX keeps 64-bit leaves only with x64 on.)"""
    with jax.enable_x64(True):
        _check_format_crosses(tmp_path, writer)


def _check_format_crosses(tmp_path, writer):
    vals = _tree_values()
    ref_tree = _ref_tree(vals)
    port_tree = _port_tree(vals, ref_tree)
    rck.save(str(tmp_path / "ref"), 4, ref_tree, extra={"k": 1})
    ck.save(str(tmp_path / "port"), 4, port_tree, extra={"k": 1})
    man = {w: json.load(open(tmp_path / w / "step_0000000004" /
                             ck.MANIFEST)) for w in ("ref", "port")}
    assert man["ref"] == man["port"]
    assert "bfloat16" in man["port"]["dtypes"]
    za = np.load(tmp_path / "ref" / "step_0000000004" / "arrays.npz")
    zb = np.load(tmp_path / "port" / "step_0000000004" / "arrays.npz")
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes()

    root = str(tmp_path / writer)
    if writer == "ref":
        got, extra = ck.restore(root, 4, port_tree)
        want = port_tree
    else:
        got, extra = rck.restore(root, 4, ref_tree)
        want = ref_tree
    assert extra == {"k": 1}
    names_got, leaves_got, _ = ck._flatten_with_paths(got)
    names_want, leaves_want, _ = ck._flatten_with_paths(want)
    assert names_got == names_want == man[writer]["names"]
    for a, b in zip(leaves_got, leaves_want):
        assert _bytes(a) == _bytes(b)
        assert tuple(np.shape(a)) == tuple(np.shape(b))
    assert ck._host(got["layer"]["b"])[1] == "bfloat16"
    assert got["hist"][2]["none"] is None


# ------------------------------------------------ cross-package resume
_XMETHODS = [("krylov_schur", {"tol": 1e-6}),
             ("lobpcg", {"tol": 1e-4, "seed": 3})]


@pytest.mark.disk
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("backend", ["ram", "safs"])
@pytest.mark.parametrize("method,kw", _XMETHODS,
                         ids=[m for m, _ in _XMETHODS])
def test_resume_crosses_packages(tm, disk_tmp, method, kw, backend, writer):
    """A solve suspended in one package resumes in the other: the same
    resumed step, eigenvalues at rtol 1e-5 of the writer's own resumed
    run and equal IOStats."""
    root = os.path.join(disk_tmp, "ck")
    g = _Guard(after=2)
    if writer == "ref":
        with pytest.raises(RefSuspended) as ei:
            _ref_solve(tm, method, _ref_store(backend, os.path.join(
                disk_tmp, "w")), checkpoint=RefPolicy(root=root, guard=g),
                callback=g.cb, **kw)
    else:
        with pytest.raises(SolveSuspended) as ei:
            _port_solve(tm, method, _port_store(backend, os.path.join(
                disk_tmp, "w")), checkpoint=CheckpointPolicy(
                root=root, guard=g), callback=g.cb, **kw)
    ref = _ref_solve(tm, method, _ref_store(backend, os.path.join(
        disk_tmp, "r")), resume=root, **kw)
    port = _port_solve(tm, method, _port_store(backend, os.path.join(
        disk_tmp, "p")), resume=root, **kw)
    assert ref.converged and port.converged
    assert ref.resumed_step == port.resumed_step == ei.value.step
    np.testing.assert_allclose(np.sort(port.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=RTOL)
    assert port.n_restarts == ref.n_restarts
    assert port.io_stats == ref.io_stats


# ------------------------------------------ bit-identical continuation
_METHODS = [("krylov_schur", 4, {"tol": 1e-6}),
            ("lobpcg", 4, {"tol": 1e-5, "seed": 3})]


@pytest.mark.disk
@pytest.mark.parametrize("backend", ["ram", "safs"])
@pytest.mark.parametrize("method,nev,kw", _METHODS,
                         ids=[m[0] for m in _METHODS])
def test_resume_is_bit_identical(tm, disk_tmp, method, nev, kw, backend):
    full = _port_solve(tm, method, _port_store(backend, os.path.join(
        disk_tmp, "full")), nev, **kw)
    assert full.converged and full.resumed_step is None
    root = os.path.join(disk_tmp, "ck")
    g = _Guard(after=5)
    with pytest.raises(SolveSuspended) as ei:
        _port_solve(tm, method, _port_store(backend, os.path.join(
            disk_tmp, "s")), nev, callback=g.cb,
            checkpoint=CheckpointPolicy(root=root, every_restarts=2,
                                        guard=g), **kw)
    assert ei.value.step == 5           # preempted off the cadence
    assert ck.valid_steps(os.path.join(root, "state")) == [2, 4, 5]
    res = _port_solve(tm, method, _port_store(backend, os.path.join(
        disk_tmp, "r")), nev, resume=root, **kw)
    assert res.resumed_step == 5
    assert np.array_equal(res.eigenvalues, full.eigenvalues)
    assert np.array_equal(res.residuals, full.residuals)
    assert res.n_restarts == full.n_restarts and res.n_ops == full.n_ops


# ------------------------------------------------------ suspend / resume
@pytest.mark.parametrize("method,nev,kw", _METHODS,
                         ids=[m[0] for m in _METHODS])
def test_preemption_suspend_resume_ram(tm, tmp_path, method, nev, kw):
    """In-RAM backend: guard fires mid-solve → SolveSuspended after the
    boundary checkpoint commits → resumed solve converges to the clean
    spectrum with ≤ 1 extra step."""
    ref = _port_solve(tm, method, P.TieredStore(device="cpu"), nev, **kw)
    assert ref.converged
    g = _Guard(after=2)
    root = str(tmp_path / "ck")
    with pytest.raises(SolveSuspended) as ei:
        _port_solve(tm, method, P.TieredStore(device="cpu"), nev,
                    checkpoint=CheckpointPolicy(root=root, every_restarts=1,
                                                guard=g),
                    callback=g.cb, **kw)
    assert ei.value.root == root
    res = _port_solve(tm, method, P.TieredStore(device="cpu"), nev,
                      resume=root, **kw)
    assert res.converged
    assert res.resumed_step == ei.value.step
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=RTOL)
    assert res.n_restarts <= ref.n_restarts + 1


def test_resume_rejects_other_solve_shape(tm, tmp_path):
    root = str(tmp_path / "ck")
    g = _Guard(after=1)
    with pytest.raises(SolveSuspended):
        _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"),
                    tol=1e-6, callback=g.cb,
                    checkpoint=CheckpointPolicy(root=root, guard=g))
    with pytest.raises(ValueError, match="params mismatch"):
        _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"), 5,
                    tol=1e-6, resume=root)
    with pytest.raises(ValueError, match="method"):
        _port_solve(tm, "lobpcg", P.TieredStore(device="cpu"), tol=1e-6,
                    resume=root)


def test_checkpoint_unsupported_method_rejected(tm):
    with pytest.raises(ValueError, match="checkpoint/resume"):
        P.solve(P.GraphOperator(tm[1], device="cpu"), 4, method="lanczos",
                checkpoint=CheckpointPolicy(root="/nonexistent"))


def test_resume_from_empty_root_starts_fresh(tm, tmp_path):
    """Crash before the first snapshot: the resume root holds no committed
    checkpoint, so the solve starts from scratch."""
    ref = _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"),
                      tol=1e-6)
    res = _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"),
                      tol=1e-6, resume=str(tmp_path / "never_written"))
    assert res.resumed_step is None
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)


# ------------------------------------------------------------ kill matrix
# every site is hit after several checkpoints committed and well before
# convergence (the reference's schedule, tests/test_faults.py)
_CRASH_SCENARIOS = [
    ("journal.commit", dict(at=30), {"write_behind": False}),
    ("wb.retire", dict(at=30), {"write_behind": True}),
    ("ckpt.save", dict(at=10), {"write_behind": True}),
    ("solve.restart", dict(at=10), {"write_behind": True}),
]


@pytest.mark.disk
@pytest.mark.parametrize("site,sched,bopts", _CRASH_SCENARIOS,
                         ids=[s[0] for s in _CRASH_SCENARIOS])
@pytest.mark.parametrize("method,nev,kw", _METHODS,
                         ids=[m[0] for m in _METHODS])
def test_kill_matrix_crash_anywhere_resume_matches(tm, disk_tmp, site, sched,
                                                   bopts, method, nev, kw):
    """A hard CrashPoint at an I/O or checkpoint boundary mid-solve, then
    a resume from the surviving checkpoint into a FRESH safs root: the
    spectrum matches the port's uninterrupted solve at rtol 1e-5 with at
    most one extra restart."""
    ref = _port_solve(tm, method, _port_store(
        "safs", os.path.join(disk_tmp, "ref"), **bopts), nev, **kw)
    assert ref.converged
    ck_root = os.path.join(disk_tmp, "ck")
    plan = FaultPlan([FaultRule(site=site, kind="crash", **sched)])
    with pytest.raises((CrashPoint, WriteBehindError, SafsIOError)):
        # the write-behind thread's CrashPoint surfaces as
        # WriteBehindError at the next drain barrier (checkpoint flush)
        _port_solve(tm, method, _port_store(
            "safs", os.path.join(disk_tmp, "crash"), plan=plan, **bopts),
            nev, checkpoint=CheckpointPolicy(root=ck_root, every_restarts=1),
            **kw)
    assert plan.fired(kind="crash"), "scheduled crash never fired"
    resumed = _port_solve(tm, method, _port_store(
        "safs", os.path.join(disk_tmp, "fresh"), **bopts), nev,
        resume=ck_root, **kw)
    assert resumed.converged
    assert resumed.resumed_step is not None
    np.testing.assert_allclose(np.sort(resumed.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=RTOL)
    assert resumed.n_restarts <= ref.n_restarts + 1


@pytest.mark.disk
def test_ckpt_save_crash_leaves_previous_checkpoint_usable(tm, disk_tmp):
    """The crash window between the page snapshot and the state commit:
    the orphaned page snapshot is skipped and the previous committed
    checkpoint resumes."""
    ck_root = os.path.join(disk_tmp, "ck")
    plan = FaultPlan([FaultRule(site="ckpt.save", kind="crash", at=3)])
    with pytest.raises(CrashPoint):
        _port_solve(tm, "krylov_schur", _port_store(
            "safs", os.path.join(disk_tmp, "s"), plan=plan), tol=1e-6,
            checkpoint=CheckpointPolicy(root=ck_root, every_restarts=1))
    assert ck.valid_steps(os.path.join(ck_root, "state")) == [1, 2]
    assert 3 in ck.valid_steps(os.path.join(ck_root, "pages"))
    resumed = _port_solve(tm, "krylov_schur", _port_store(
        "safs", os.path.join(disk_tmp, "f")), tol=1e-6, resume=ck_root)
    assert resumed.resumed_step == 2
    assert resumed.converged


# ------------------------------------------------ checkpoint primitives
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": torch.from_numpy(
        rng.standard_normal((8, 4)).astype(np.float32)),
        "b": torch.zeros(4, dtype=torch.bfloat16)},
        "step": torch.tensor(3, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 7, t, extra={"data_step": 7})
    restored, extra = ck.restore(str(tmp_path), 7, t)
    assert extra["data_step"] == 7
    for a, b in zip(ck._flatten_with_paths(t)[1],
                    ck._flatten_with_paths(restored)[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="item 7"):
        ck.restore(str(tmp_path), 7, t, shardings=object())


def test_latest_step_ignores_partial(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 5, t)
    ck.save(str(tmp_path), 10, t)
    os.makedirs(tmp_path / "step_0000000015")   # a crash mid-write
    assert ck.latest_step(str(tmp_path)) == 10


def test_structure_mismatch_rejected(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(str(tmp_path), 1, {"other": torch.zeros(2)})


def test_gc_keeps_newest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, t)
    ck.gc_old(str(tmp_path), keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert ck.valid_steps(str(tmp_path)) == [4, 5]


def test_async_writer_snapshots_at_submit(tmp_path):
    t = _tree()
    w = ck.AsyncWriter()
    w.submit(str(tmp_path), 3, t)
    t["layer"]["w"].fill_(7.0)          # a write after submit is not saved
    w.wait()
    assert ck.latest_step(str(tmp_path)) == 3
    got, _ = ck.restore(str(tmp_path), 3, _tree())
    assert torch.equal(got["layer"]["w"], _tree()["layer"]["w"])


def test_latest_step_gcs_stale_tmp(tmp_path):
    """A stale `.tmp` staging dir is reclaimed, a fresh one is left for
    its (possibly live) writer, and opting out leaves both."""
    ck.save(str(tmp_path), 4, _tree())
    stale = tmp_path / "step_0000000009.tmp"
    fresh = tmp_path / "step_0000000011.tmp"
    os.makedirs(stale)
    os.makedirs(fresh)
    (stale / "leaf.npz").write_bytes(b"partial")
    old = time.time() - 7200
    os.utime(stale, (old, old))
    assert ck.latest_step(str(tmp_path)) == 4
    assert not stale.exists() and fresh.exists()
    os.makedirs(stale)
    os.utime(stale, (old, old))
    assert ck.latest_step(str(tmp_path), gc_stale_tmp=False) == 4
    assert stale.exists()


# ------------------------------------------ checkpoint-sourced repair
def _filled_backend(root):
    b = SafsBackend(root, page_size=4096, cache_bytes=1 << 16,
                    enable_prefetch=False, write_behind=False)
    arr = torch.from_numpy(
        np.random.default_rng(1).standard_normal((3000, 4)).astype(
            np.float32))
    b.store("a", arr)
    b.flush()
    return b, arr


@pytest.mark.disk
def test_scrub_detects_and_repairs_from_snapshot(disk_tmp):
    """An at-rest flip: a scrub quarantines the page, repair re-fills it
    byte-identically from the verified snapshot, a second scrub is clean,
    and the integrity counters reconcile with the trace events."""
    tr = Tracer()
    with tracing(tr):
        b, arr = _filled_backend(os.path.join(disk_tmp, "pages"))
        ckroot = os.path.join(disk_tmp, "ck")
        ck.save_safs(ckroot, 1, types.SimpleNamespace(backend=b), extra={})
        assert newest_verified_step(ckroot) == 1
        flip_bit(b._files["a"].path, 1)
        sc = Scrubber(b, use_pool=False)
        assert sc.run_once()["corrupt"] == [("a", 1)]
        rep = repair_from_checkpoint(b, ckroot)
        assert rep == {"step": 1, "repaired": [("a", 1)], "unrepaired": []}
        assert sc.run_once()["corrupt"] == [] and not b.quarantined()
        assert torch.equal(b.load("a"), arr)
        integ = b.stats_dict()["integrity"]
        b.close()
    names = [r["name"] for r in tr.records() if r["type"] == "event"]
    assert integ["scrub_passes"] == names.count("safs.scrub") == 2
    assert integ["crc_failures"] == names.count("safs.corrupt") == 1
    assert integ["pages_repaired"] == names.count("safs.repair") == 1


@pytest.mark.disk
def test_repair_without_covering_snapshot_stays_quarantined(disk_tmp):
    b, _ = _filled_backend(os.path.join(disk_tmp, "pages"))
    flip_bit(b._files["a"].path, 0)
    assert b.scrub_file("a") == [0]
    rep = repair_from_checkpoint(b, os.path.join(disk_tmp, "no_ck"))
    assert rep["step"] is None and rep["unrepaired"] == [("a", 0)]
    assert b.quarantined() == [("a", 0)]       # never silently cleared
    b.close()


@pytest.mark.disk
def test_restore_safs_refuses_corrupt_snapshot(disk_tmp):
    b, arr = _filled_backend(os.path.join(disk_tmp, "pages"))
    ck.save_safs(os.path.join(disk_tmp, "ck"), 1,
                 types.SimpleNamespace(backend=b), extra={"x": 1})
    b.close()
    back, extra = ck.restore_safs(os.path.join(disk_tmp, "ck"), 1,
                                  os.path.join(disk_tmp, "ok"))
    assert extra == {"x": 1} and torch.equal(back.load("a"), arr)
    back.close()
    snap = os.path.join(disk_tmp, "ck", "step_0000000001")
    flip_bit(os.path.join(snap, "a.pages"), 0)
    with pytest.raises(ck.CorruptSnapshotError):
        ck.restore_safs(os.path.join(disk_tmp, "ck"), 1,
                        os.path.join(disk_tmp, "dest"))
    assert newest_verified_step(os.path.join(disk_tmp, "ck")) is None


@pytest.mark.disk
def test_scrub_cli_detect_and_repair(disk_tmp, capsys):
    root = os.path.join(disk_tmp, "pages")
    ckroot = os.path.join(disk_tmp, "ck")
    b, arr = _filled_backend(root)
    ck.save_safs(ckroot, 1, types.SimpleNamespace(backend=b), extra={})
    b.close()
    flip_bit(os.path.join(root, "a.pages"), 2)
    assert scrub_main([root]) == 1                       # detect only
    assert scrub_main([root, "--repair-from", ckroot]) == 0
    assert "repair: step=1 repaired=1 unrepaired=0" in capsys.readouterr().out
    assert scrub_main([root]) == 0                       # now clean
    b3 = SafsBackend(root, enable_prefetch=False, write_behind=False)
    assert torch.equal(b3.load("a"), arr)
    b3.close()


@pytest.mark.disk
def test_resume_falls_back_past_corrupt_snapshot(tm, disk_tmp):
    """The newest page snapshot is corrupt: resume falls back to the next
    older step that verifies, and still converges to the spectrum of the
    uninterrupted solve."""
    tr = Tracer()
    ck_root = os.path.join(disk_tmp, "ck")
    full = _port_solve(tm, "krylov_schur", _port_store(
        "safs", os.path.join(disk_tmp, "s")), tol=1e-6,
        checkpoint=CheckpointPolicy(root=ck_root, every_restarts=1, keep=3))
    steps = ck.valid_steps(os.path.join(ck_root, "state"))
    assert len(steps) >= 2
    snap = os.path.join(ck_root, "pages", f"step_{steps[-1]:010d}")
    victim = sorted(f for f in os.listdir(snap) if f.endswith(".pages"))[0]
    flip_bit(os.path.join(snap, victim), 0)
    assert ck.verify_safs_snapshot(snap)
    with tracing(tr):
        resumed = _port_solve(tm, "krylov_schur", _port_store(
            "safs", os.path.join(disk_tmp, "f")), tol=1e-6, resume=ck_root)
    assert resumed.resumed_step == steps[-2]
    assert [e["args"]["step"] for e in tr.records()
            if e["name"] == "ckpt.corrupt_snapshot"] == [steps[-1]]
    assert resumed.converged
    np.testing.assert_allclose(np.sort(resumed.eigenvalues),
                               np.sort(full.eigenvalues), rtol=RTOL)
    assert resumed.n_restarts <= full.n_restarts + 1
