"""Checkpoint faults in the port (the second half of
tests/test_torch_ckpt.py, split off so that `--dist loadfile` can run the
halves on two workers; its fixtures and helpers are imported from there):

  * the reference's kill matrix (`tests/test_faults.py`) on the port
    alone: every resumed solve is held to the port's own uninterrupted
    solve, and a crash inside `ckpt.save` leaves the previous checkpoint
    usable;
  * `tests/test_checkpoint.py`'s primitives (round trip, partial and
    stale checkpoints, gc, the async writer) and `restore(shardings=)`
    onto one rank;
  * `tests/test_integrity.py`'s checkpoint-sourced repair and the scrub
    CLI.
"""
import os
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointPolicy
from repro_torch.ckpt import checkpoint as ck
from repro_torch.obs import Tracer, tracing
from repro_torch.safs import (CrashPoint, FaultPlan, FaultRule, SafsBackend,
                              SafsIOError, Scrubber, WriteBehindError,
                              flip_bit, newest_verified_step,
                              repair_from_checkpoint)
from repro_torch.safs.scrub import main as scrub_main

# the first half's fixtures (`tm`, and `_one_thread` for every test) and
# helpers (its module, on pytest's path)
from test_torch_ckpt import (RTOL, _METHODS, _one_thread, _port_solve,
                             _port_store, tm)


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
    # the elastic reshard onto one rank (a (1, 1, 1) mesh, no world): one
    # placement for every leaf, as the reference allows, reads them whole
    from repro_torch.dist import comm
    from repro_torch.models import sharding as shd
    one = shd.Placement((None, "model"), comm.Mesh((1, 1, 1), device="cpu"))
    resharded, _ = ck.restore(str(tmp_path), 7, t, shardings=one)
    for a, b in zip(ck._flatten_with_paths(t)[1],
                    ck._flatten_with_paths(resharded)[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)


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
