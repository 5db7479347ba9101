"""The serve loop's self-healing in the port: the startup orphan-namespace
GC, dead-worker reaping, the watchdog's suspend and abandon, the
scheduler-wide default deadline, corruption recovery within and past its
budget, and the integrity reconciliation of the trace report.

Ports of tests/test_integrity.py's serve cases. The duck-typed sessions
are the reference's; the orphan GC runs the same sequence through both
packages' services; the report reconciliation runs the same records
through both packages' `validate`.
"""
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.obs import report as ref_report
from repro.safs import SafsBackend as RefSafsBackend
from repro.serve import build_service as ref_build_service
from repro_torch.core import TieredStore
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.safs import CorruptPageError, RetryPolicy, SafsBackend
from repro_torch.serve import (BudgetArbiter, JobSpec, PreemptFlag,
                               SolveScheduler, SolveSession, build_service)
from repro_torch.serve import session as sess_mod

FAST_RETRY = RetryPolicy(max_attempts=3, base_delay=1e-4, max_delay=1e-3)


def _tracer():
    return obs_trace.install(obs_trace.Tracer())


def _events(tr, name):
    return [r for r in tr.records()
            if r["type"] == "event" and r["name"] == name]


# =========================================== orphan-namespace GC at start
@pytest.mark.disk
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_orphan_namespace_gc_on_service_startup(disk_tmp, pkg):
    """A serve root reused after a kill: aged per-session subdirs are
    swept at EigenService startup; young ones and live ones survive. The
    same page root, written by either package's backend, is swept by the
    port's service."""
    root = os.path.join(disk_tmp, "pages")
    block = np.zeros(600, np.float32)
    if pkg == "port":
        b = SafsBackend(root, write_behind=False, retry=FAST_RETRY)
        block = torch.from_numpy(block)
    else:
        b = RefSafsBackend(root, write_behind=False, retry=FAST_RETRY)
    b.store("dead-job::V/b0", block)
    b.store("young-job::V/b0", block)
    b.flush()
    b.close()
    old = time.time() - 7200
    os.utime(os.path.join(root, "dead-job"), (old, old))

    svc = build_service(backend="safs", root=root, device_budget=4 << 20,
                        orphan_grace_s=3600.0, device="cpu")
    try:
        assert svc.orphans_swept == ["dead-job"]
        assert not os.path.isdir(os.path.join(root, "dead-job"))
        assert os.path.isdir(os.path.join(root, "young-job"))
        assert svc.report()["orphans_swept"] == ["dead-job"]
    finally:
        svc.close()
    # a second start finds nothing old enough, as the reference's does
    svc = build_service(backend="safs", root=root, device_budget=4 << 20,
                        orphan_grace_s=3600.0, device="cpu")
    ref = ref_build_service(backend="safs", root=root,
                            device_budget=4 << 20, orphan_grace_s=3600.0)
    try:
        assert svc.orphans_swept == ref.orphans_swept == []
    finally:
        svc.close()
        ref.close()


# ========================================== crashed-worker accounting
class _CrashingSession:
    """Duck-typed session whose worker thread dies with an escaped
    BaseException — the bug class `_reap` must account as FAILED."""

    def __init__(self, jid):
        self.spec = types.SimpleNamespace(job_id=jid, priority=0,
                                          preemptible=True)
        self.state = "pending"
        self.guard = None
        self.error = None
        self.preemptions = 0

    def mark_queued(self):
        pass

    def mark_dequeued(self):
        pass

    @property
    def can_preempt(self):
        return False

    def progress(self):
        return {"state": self.state}

    def run(self):
        self.state = "running"
        raise KeyboardInterrupt("worker killed mid-solve")


class _DyingSession(_CrashingSession):
    """A worker whose thread ends with the session still RUNNING (it
    returns without classifying its exit): `_reap`'s own net."""

    def run(self):
        self.state = "running"


def _mini_sched(**kw):
    store = TieredStore(device_budget_bytes=8 << 20, device="cpu")
    arb = BudgetArbiter(store, device_budget=8 << 20)
    return SolveScheduler(store, arb, max_concurrent=1,
                          poll_interval=0.002, **kw)


def _until_completed(sched, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sched.tick()
        if sched.completed:
            return
        time.sleep(0.002)


def test_reap_accounts_dead_worker_as_failed():
    """Single-stepped tick(): the dead worker's session surfaces FAILED
    with the traceback in the report, namespace + arbiter released
    exactly once, nothing left running/pending."""
    sched = _mini_sched()
    s = _CrashingSession("boom")
    sched.submit(s)
    _until_completed(sched)
    assert sched.completed == [s]
    assert s.state == "failed"
    assert "KeyboardInterrupt" in s.error      # full traceback captured
    assert sched.worker_crashes == 1
    assert not sched._running and not sched._pending
    a = sched.arbiter.stats_dict()
    assert a["admits"] == a["releases"] == 1 and not a["live_sessions"]
    assert sched.stats_dict()["worker_crashes"] == 1


def test_reap_fails_a_worker_that_left_its_session_running():
    sched = _mini_sched()
    s = _DyingSession("ghost")
    sched.submit(s)
    _until_completed(sched)
    assert sched.completed == [s] and s.state == "failed"
    assert "died with session in state 'running'" in s.error
    assert sched.worker_crashes == 1
    a = sched.arbiter.stats_dict()
    assert a["admits"] == a["releases"] == 1


# ================================================ the serve watchdog
class _TimedSession:
    """Duck-typed session with a deadline; `cooperative` decides whether
    the guard's suspend request is honored (graceful) or ignored (hung)."""

    def __init__(self, jid, *, deadline_s, cooperative):
        self.spec = types.SimpleNamespace(job_id=jid, priority=0,
                                          preemptible=True,
                                          deadline_s=deadline_s)
        self.state = "pending"
        self.guard = PreemptFlag()
        self.error = None
        self.preemptions = 0
        self.wall_s = 0.0
        self.cooperative = cooperative
        self.stop = threading.Event()

    def mark_queued(self):
        pass

    def mark_dequeued(self):
        pass

    @property
    def can_preempt(self):
        return False                 # watchdog only, no priority preempt

    def progress(self):
        return {"state": self.state}

    def run(self):
        self.state = "running"
        while not self.stop.is_set():
            if self.cooperative and self.guard.requested():
                self.state = "suspended"
                return
            time.sleep(0.002)


def test_watchdog_deadline_suspends_cooperative_worker():
    """Past its deadline a cooperative job checkpoints out SUSPENDED and
    is NOT requeued (deadline-expired suspension is terminal), freeing
    the slot and its shares; the deadline is traced."""
    tr = _tracer()
    try:
        sched = _mini_sched(deadline_grace_s=5.0)
        s = _TimedSession("slow", deadline_s=0.05, cooperative=True)
        sched.submit(s)
        done = sched.drain()
    finally:
        obs_trace.uninstall()
    assert done == [s] and s.state == "suspended"
    assert sched.timeouts == 1 and sched.abandoned == 0
    assert sched.requeues == 0                 # not resurrected
    a = sched.arbiter.stats_dict()
    assert a["admits"] == a["releases"] == 1
    (ev,) = _events(tr, "serve.deadline")
    assert ev["args"]["job"] == "slow" and ev["args"]["deadline_s"] == 0.05


def test_watchdog_abandons_hung_worker():
    """A worker that ignores the suspend request past the grace is
    abandoned: FAILED with a deadline error, shares released exactly
    once, and drain() terminates instead of spinning forever."""
    tr = _tracer()
    try:
        sched = _mini_sched(deadline_grace_s=0.05)
        hung = _TimedSession("hung", deadline_s=0.05, cooperative=False)
        sched.submit(hung)
        t0 = time.monotonic()
        done = sched.drain()
    finally:
        obs_trace.uninstall()
    assert time.monotonic() - t0 < 10
    assert done == [hung] and hung.state == "failed"
    assert "deadline exceeded" in hung.error
    assert sched.timeouts == 1 and sched.abandoned == 1
    a = sched.arbiter.stats_dict()
    assert a["admits"] == a["releases"] == 1 and not a["live_sessions"]
    assert len(_events(tr, "serve.abandoned")) == 1
    hung.stop.set()                            # let the daemon thread die


def test_scheduler_default_deadline_applies_when_spec_has_none():
    sched = _mini_sched(default_deadline_s=0.05, deadline_grace_s=0.05)
    s = _TimedSession("d", deadline_s=None, cooperative=True)
    sched.submit(s)
    sched.drain()
    assert s.state == "suspended" and sched.timeouts == 1


# ====================================== session corruption retry
def _corrupting_session(tmp_path, budget, fail_times, monkeypatch):
    """Real SolveSession against a CPU RAM store, with build_problem
    patched to raise CorruptPageError the first `fail_times` runs —
    exercising the recovery path without a disk solve."""
    spec = JobSpec("c", kind="eigsh", n=120, nnz=800, nev=2, tol=1e-3,
                   max_iters=20, max_corruption_retries=budget)
    store = TieredStore(device_budget_bytes=8 << 20, device="cpu")
    sess = SolveSession(spec, store, str(tmp_path))
    calls = {"n": 0}
    real = sess_mod.build_problem

    def flaky(spec_, store_):
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise CorruptPageError(site="pread", file="V/b0", page=3)
        return real(spec_, store_)

    monkeypatch.setattr(sess_mod, "build_problem", flaky)
    return sess


def test_session_corruption_recovery_within_budget(tmp_path, monkeypatch):
    tr = _tracer()
    try:
        sess = _corrupting_session(tmp_path, 1, 1, monkeypatch)
        assert sess.run() == "suspended"       # recovery, not failure
        assert sess.corruption_recoveries == 1
        assert sess.preemptions == 0           # distinct counters
        assert len(_events(tr, "serve.corruption_recovery")) == 1
        assert sess.run() == "done"            # requeued run succeeds
        assert sess.resumes == 1               # resumed via ckpt_root
        assert sess.report()["corruption_recoveries"] == 1
    finally:
        obs_trace.uninstall()


def test_session_corruption_budget_exhausted_fails_typed(tmp_path,
                                                         monkeypatch):
    sess = _corrupting_session(tmp_path, 1, 5, monkeypatch)
    assert sess.run() == "suspended"
    assert sess.run() == "failed"              # budget of 1 exhausted
    assert "CorruptPageError" in sess.error
    sess2 = _corrupting_session(tmp_path / "z", 0, 5, monkeypatch)
    assert sess2.run() == "failed"             # zero budget: typed at once
    assert "CorruptPageError" in sess2.error


def test_session_without_checkpoint_root_fails_typed(monkeypatch):
    spec = JobSpec("c", kind="eigsh", n=120, nnz=800, nev=2, tol=1e-3,
                   max_iters=20)
    sess = SolveSession(spec, TieredStore(device="cpu"), None)

    def corrupt(spec_, store_):
        raise CorruptPageError(site="pread", file="V/b0", page=0)

    monkeypatch.setattr(sess_mod, "build_problem", corrupt)
    assert sess.run() == "failed" and "CorruptPageError" in sess.error
    assert sess.corruption_recoveries == 0


# ================================== report --validate: integrity reconcile
def _trace_records(schema, integrity, n_corrupt, n_scrub, n_repair):
    recs = [{"type": "meta", "schema": schema, "unit": "us",
             "threads": {}},
            {"type": "span", "name": "pass.subspace", "ts": 0.0,
             "dur": 1.0, "args": {}},
            {"type": "metrics", "name": "solve", "ts": 1.0,
             "data": {"end": {"backend": {"integrity": integrity}}}}]
    for name, n in (("safs.corrupt", n_corrupt), ("safs.scrub", n_scrub),
                    ("safs.repair", n_repair)):
        recs += [{"type": "event", "name": name, "ts": 2.0, "args": {}}
                 for _ in range(n)]
    recs.append({"type": "summary", "spans": 1,
                 "events": n_corrupt + n_scrub + n_repair,
                 "metrics": 1, "dropped": 0})
    return recs


@pytest.mark.parametrize("mod", [obs_report, ref_report],
                         ids=["port", "ref"])
def test_report_validate_integrity_reconciliation(mod):
    integ = {"crc_failures": 2, "scrub_passes": 1, "pages_repaired": 2}
    good = _trace_records(mod.SCHEMA, integ, 2, 1, 2)
    assert mod.validate(good) == []
    rec = mod.integrity_reconcile(good)
    assert rec["exact"] and rec["lossless"]
    bad = _trace_records(mod.SCHEMA, integ, 1, 1, 2)   # one unannounced
    assert any("integrity accounting mismatch" in p
               for p in mod.validate(bad))
    # ram backend (integrity: None) → reconciliation is simply absent
    none = _trace_records(mod.SCHEMA, None, 0, 0, 0)
    assert mod.integrity_reconcile(none) is None
    assert mod.validate(none) == []
    # both packages read the same records the same way
    other = ref_report if mod is obs_report else obs_report
    for recs in (good, bad, none):
        assert mod.validate(recs) == other.validate(recs)
        assert mod.integrity_reconcile(recs) == \
            other.integrity_reconcile(recs)


# ============================ a store-wide flush beside another's delete
@pytest.mark.disk
def test_flush_beside_a_delete_in_another_namespace(disk_tmp):
    """A checkpoint's flush is a barrier over every page file of the
    shared store; another session may delete one of its files between the
    flush's listing and its fsync. The closed file is skipped (it has
    nothing left to make durable), the others are synced, and their bytes
    read back."""
    b = SafsBackend(os.path.join(disk_tmp, "pages"), write_behind=False,
                    retry=FAST_RETRY)
    kept = torch.arange(600, dtype=torch.float32)
    b.store("embed::V/b0", kept)
    b.store("lobpcg::X/b0", torch.ones(600))
    b.flush()                        # pages written: the next flush syncs
    pf = b._files["embed::V/b0"]
    real_sync = pf.sync

    def sync_then_delete():          # the other session, mid-flush
        b.delete("lobpcg::X/b0")
        real_sync()

    pf.sync = sync_then_delete
    b.flush()
    assert not b.has("lobpcg::X/b0")
    assert torch.equal(b.load("embed::V/b0"), kept)
    pf.close()
    pf.sync()                        # a closed file: nothing to do
    b.close()
