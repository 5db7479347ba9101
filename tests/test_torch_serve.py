"""The serving layer of the port against the reference: the arbiter's
splits, JobSpecs, the scheduler's decisions (stub sessions), the service
report and its validation, the sessions' `impl="auto"`, and the paged KV
cache.

Ports of tests/test_serve.py (arbiter, job specs, scheduler, service,
paged KV) and of tests/test_extensions.py's paged-KV cases. Where a case
is cheap in both packages it runs the same sequence through both and
compares; the scheduler's cases drive duck-typed sessions and hold the
port to the reference's expectations.
"""
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro.core.tiered as R
import repro.serve as RS
from repro_torch.core.tiered import TieredStore
from repro_torch.serve import (AdmissionError, BudgetArbiter, JobSpec,
                               PagedConfig, PagedKVCache, PreemptFlag,
                               SolveScheduler, SolveSession, build_service,
                               validate_report)
from repro_torch.serve import session as session_mod
from repro_torch.serve.session import DONE, PENDING, RUNNING, SUSPENDED


def _cpu_store(budget, **kw):
    return TieredStore(device_budget_bytes=budget, device="cpu", **kw)


# ======================================================= arbiter + budgets
def _arbiter_pair(budget, **kw):
    """The reference's and the port's arbiter over stores of the same
    budget."""
    ref_store = R.TieredStore(device_budget_bytes=budget)
    port_store = _cpu_store(budget)
    return ((ref_store, RS.BudgetArbiter(ref_store, device_budget=budget,
                                         **kw)),
            (port_store, BudgetArbiter(port_store, device_budget=budget,
                                       **kw)))


def test_arbiter_priority_split_and_recompute():
    pairs = _arbiter_pair(12 << 20)
    for store, arb in pairs:
        s_lo = arb.admit("lo", priority=0)
        assert s_lo == 12 << 20                  # alone: the whole budget
        s_hi = arb.admit("hi", priority=3)
        # weights 1:4 over 12 MiB (floor division per share)
        assert arb.allotment("lo") == (12 << 20) * 1 // 5
        assert arb.allotment("hi") == (12 << 20) * 4 // 5
        assert s_hi == arb.allotment("hi")
        assert store.namespace_budget("lo") == arb.allotment("lo")
        arb.release("hi")
        assert arb.allotment("lo") == 12 << 20   # share redistributed
        assert store.namespace_budget("hi") is None
        st = arb.stats_dict()
        assert st["admits"] == 2 and st["releases"] == 1
    assert pairs[1][1].stats_dict() == pairs[0][1].stats_dict()


def test_arbiter_min_share_floor():
    pairs = _arbiter_pair(4 << 20, min_share=1 << 20)
    for _, arb in pairs:
        arb.admit("lo", priority=0)
        arb.admit("hi", priority=100)
        assert arb.allotment("lo") == 1 << 20    # floored, not starved
        assert arb.stats_dict()["oversubscribed"] in (True, False)
    assert pairs[1][1].stats_dict() == pairs[0][1].stats_dict()


# ============================================================== job specs
def test_jobspec_validation():
    with pytest.raises(ValueError, match="unknown kind"):
        JobSpec("j", kind="svd")
    with pytest.raises(ValueError, match="unknown job-spec fields"):
        JobSpec.from_dict({"job_id": "j", "frobnicate": 1})
    with pytest.raises(ValueError, match="job_id"):
        JobSpec.from_dict({"kind": "eigsh"})
    assert JobSpec("c", kind="cluster").graph == "planted"
    assert JobSpec("l", kind="lobpcg").method == "lobpcg"


def test_jobspec_dict_round_trips_across_packages():
    d = {"job_id": "x", "kind": "cluster", "n": 300, "k_classes": 3,
         "nev": 3, "priority": 2, "options": {"num_blocks": 6}}
    port, ref = JobSpec.from_dict(dict(d)), RS.JobSpec.from_dict(dict(d))
    assert port.as_dict() == ref.as_dict()
    assert RS.JobSpec.from_dict(port.as_dict()).as_dict() == ref.as_dict()
    assert JobSpec.from_dict(ref.as_dict()) == port


@pytest.mark.parametrize("n,k", [(400, 4), (301, 4), (90, 3)])
def test_planted_partition_draws_the_reference_graph(n, k):
    from repro.serve.session import planted_partition as ref_pp
    got = session_mod.planted_partition(n, k, seed=3)
    want = ref_pp(n, k, seed=3)
    assert got[0].size == n                      # labels padded to n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_spherical_kmeans_purity_matches_reference():
    from repro.serve.session import spherical_kmeans_purity as ref_p
    rng = np.random.default_rng(0)
    labels = np.repeat(np.arange(3), 50)
    emb = (np.eye(3)[labels] + 0.3 * rng.standard_normal((150, 3))
           ).astype(np.float32)
    assert session_mod.spherical_kmeans_purity(emb, labels, 3) == \
        ref_p(emb, labels, 3)


def test_spectrum_digest_matches_reference():
    vals = [0.9, 0.123456789, -0.5, 0.7]
    assert session_mod.spectrum_digest(vals) == RS.spectrum_digest(vals)


# ============================================== scheduler (stub sessions)
class _StubSession:
    """Duck-typed SolveSession: runs until released (or preempted), so
    scheduler decisions can be single-stepped deterministically."""

    def __init__(self, jid, priority, *, instant=False):
        self.spec = types.SimpleNamespace(job_id=jid, priority=priority,
                                          preemptible=True)
        self.state = PENDING
        self.guard = PreemptFlag()
        self.ckpt_root = "stub"
        self.preemptions = 0
        self.release = threading.Event()
        if instant:
            self.release.set()

    def mark_queued(self):
        pass

    def mark_dequeued(self):
        pass

    @property
    def can_preempt(self):
        return self.state == RUNNING and not self.guard.requested()

    def progress(self):
        return {"state": self.state}

    def run(self):
        self.state = RUNNING
        while not self.release.is_set():
            if self.guard.requested():
                self.preemptions += 1
                self.state = SUSPENDED
                return
            time.sleep(0.002)
        self.state = DONE


def _mini_sched(max_concurrent=1, max_queued=64):
    store = _cpu_store(8 << 20)
    arb = BudgetArbiter(store, device_budget=8 << 20)
    return SolveScheduler(store, arb, max_concurrent=max_concurrent,
                          max_queued=max_queued, poll_interval=0.002)


def test_scheduler_loads_cuda_linalg_before_its_workers(monkeypatch):
    """Two workers' first CUDA linalg calls race in torch's lazy loader
    ("lazy wrapper should be called at most once"), so the scheduler
    loads it on the caller's thread, for its store's device."""
    from repro_torch.serve import scheduler as sched_mod
    seen = []
    monkeypatch.setattr(sched_mod, "load_cuda_linalg", seen.append)
    store = _cpu_store(8 << 20)
    SolveScheduler(store, BudgetArbiter(store, device_budget=8 << 20))
    assert seen == [torch.device("cpu")]
    from repro_torch.device import load_cuda_linalg
    load_cuda_linalg("cpu")                      # a no-op off CUDA


def test_scheduler_runs_in_priority_order():
    sched = _mini_sched(max_concurrent=1)
    jobs = {p: _StubSession(f"p{p}", p, instant=True) for p in (0, 2, 1)}
    for s in jobs.values():
        sched.submit(s)
    done = sched.drain()
    assert [s.spec.job_id for s in done] == ["p2", "p1", "p0"]


def test_scheduler_admission_control():
    sched = _mini_sched(max_queued=2)
    sched.submit(_StubSession("a", 0, instant=True))
    sched.submit(_StubSession("b", 0, instant=True))
    with pytest.raises(AdmissionError):
        sched.submit(_StubSession("c", 0, instant=True))


def test_scheduler_preempts_for_higher_priority():
    sched = _mini_sched(max_concurrent=1)
    low = _StubSession("low", 0)
    sched.submit(low)
    for _ in range(200):                 # let the low job occupy the slot
        sched.tick()
        if low.state == RUNNING:
            break
        time.sleep(0.002)
    assert low.state == RUNNING
    high = _StubSession("high", 5, instant=True)
    sched.submit(high)
    deadline = time.monotonic() + 5
    while high.state != DONE and time.monotonic() < deadline:
        sched.tick()
        time.sleep(0.002)
    assert high.state == DONE            # jumped the queue via preemption
    assert sched.preempt_requests == 1 and sched.requeues == 1
    assert low.preemptions == 1
    low.release.set()                    # let the requeued victim finish
    done = sched.drain()
    assert {s.spec.job_id for s in done} == {"low", "high"}
    assert low.state == DONE
    # every admit was released (namespace + share teardown balanced)
    a = sched.arbiter.stats_dict()
    assert a["admits"] == a["releases"] == 3 and not a["live_sessions"]


def test_equal_priority_never_preempts():
    sched = _mini_sched(max_concurrent=1)
    a = _StubSession("a", 1)
    sched.submit(a)
    for _ in range(200):
        sched.tick()
        if a.state == RUNNING:
            break
        time.sleep(0.002)
    sched.submit(_StubSession("b", 1, instant=True))
    for _ in range(20):
        sched.tick()
        time.sleep(0.002)
    assert sched.preempt_requests == 0 and a.state == RUNNING
    a.release.set()
    sched.drain()


# ===================================================== service (ram, fast)
@pytest.fixture(scope="module")
def ram_service_report():
    svc = build_service(backend="ram", device_budget=8 << 20,
                        max_concurrent=2, device="cpu")
    svc.submit(JobSpec("embed", kind="eigsh", n=300, nnz=3000, nev=3,
                       tol=1e-6, max_iters=60))
    svc.submit(JobSpec("pcg", kind="lobpcg", n=200, nnz=2000, nev=2,
                       tol=1e-4, max_iters=50, priority=1))
    svc.drain()
    rep = svc.report()
    svc.close()
    return rep


def test_service_report_valid_and_json(ram_service_report):
    rep = ram_service_report
    assert validate_report(rep) == []
    assert RS.validate_report(rep) == []         # the reference's too
    assert {j["job_id"] for j in rep["jobs"]} == {"embed", "pcg"}
    for j in rep["jobs"]:
        assert j["state"] == DONE and j["spectrum"]["sha"]
        assert j["wall_s"] > 0 and j["queue_wait_s"] >= 0
    assert rep["arbiter"]["admits"] == 2
    # JSON-clean without a fallback: no tensor, no torch.device
    assert json.loads(json.dumps(rep)) == rep


def test_validate_report_catches_violations(ram_service_report):
    rep = json.loads(json.dumps(ram_service_report, default=str))
    rep["jobs"][0]["state"] = "failed"
    rep["backend"]["namespaces"]["embed"]["host_bytes_written"] = \
        rep["backend"]["namespaces"].get("embed", {}).get(
            "host_bytes_written", 0) + 7
    for validate in (validate_report, RS.validate_report):
        errs = validate(rep)
        assert any("lost" in e for e in errs)
        assert any("accounting leak" in e for e in errs)
        assert validate({"jobs": [], "scheduler": {}}) != []
    assert validate_report(rep) == RS.validate_report(rep)


def test_service_rejects_duplicate_job_id():
    svc = build_service(backend="ram", device_budget=4 << 20, device="cpu")
    svc.submit(JobSpec("a", n=100, nnz=600, nev=2, tol=1e-3, max_iters=10))
    with pytest.raises(ValueError, match="duplicate"):
        svc.submit(JobSpec("a"))
    svc.drain()
    svc.close()


# ============================================ the sessions run the kernels
def test_session_solves_with_impl_auto(monkeypatch):
    """The reference's sessions force `impl="ref"` (its plain path); the
    port's pass "auto" to the operator and to solve(), so a CUDA store
    launches the SpMM, gram and tsgemm kernels."""
    seen = []
    real = session_mod.solve

    def spy(op, nev, **kw):
        seen.append({"solve_impl": kw.get("impl"),
                     "op_impl": op.impl,
                     "op_device": op.device,
                     "store_device": kw["store"].device})
        return real(op, nev, **kw)

    monkeypatch.setattr(session_mod, "solve", spy)
    store = _cpu_store(8 << 20)
    for spec in (JobSpec("e", kind="eigsh", n=200, nnz=1600, nev=2,
                         tol=1e-4, max_iters=30),
                 JobSpec("l", kind="lobpcg", n=200, nnz=1600, nev=2,
                         tol=1e-3, max_iters=30),
                 JobSpec("c", kind="cluster", n=120, k_classes=3, nev=3,
                         tol=1e-3, max_iters=30)):
        s = SolveSession(spec, store, None)
        assert s.run() == DONE, s.error
    assert len(seen) == 3
    for rec in seen:
        assert rec["solve_impl"] == "auto" and rec["op_impl"] == "auto"
        assert rec["op_device"] == rec["store_device"] == torch.device("cpu")


def test_session_report_crosses_to_numpy():
    s = SolveSession(JobSpec("c", kind="cluster", n=120, k_classes=3,
                             nev=3, tol=1e-4, max_iters=40),
                     _cpu_store(8 << 20), None)
    assert s.run() == DONE, s.error
    rep = s.report()
    assert json.loads(json.dumps(rep)) == rep
    assert isinstance(rep["purity"], float)
    assert all(isinstance(x, float) for x in rep["result"]["eigenvalues"])


# ============================================ paged KV rides the namespaces
def test_paged_kv_namespaced_coexistence():
    store = _cpu_store(4 << 20)
    solver_ns = store.namespace("solve")
    solver_ns.put("V/b0", np.zeros(256, np.float32))
    cfg = PagedConfig(page_size=8, n_kv_heads=2, head_dim=4, hot_pages=2)
    kv = PagedKVCache(cfg, store, session_id="kv")
    kv.start(0)
    for t in range(20):
        k = np.full((2, 4), t, np.float32)
        kv.append(0, k, k)
    assert kv.length(0) == 20
    # pages are namespaced on the SHARED store, solver blocks untouched
    assert all(n.startswith("kv/") for n in kv._tables[0])
    assert any(n.startswith("kv/") for n in store.namespace("kv").names())
    assert solver_ns.names() == ["V/b0"]
    out = kv.attend(0, np.ones((4, 4), np.float32))
    assert out.shape == (4, 4)
    kv.close()
    assert store.namespace("kv").names() == []
    assert solver_ns.names() == ["V/b0"]         # survivors intact


def test_paged_kv_bare_store_unchanged():
    cfg = PagedConfig(page_size=4, n_kv_heads=1, head_dim=4, hot_pages=1)
    kv = PagedKVCache(cfg, device="cpu")
    kv.start(7)
    kv.append(7, np.ones((1, 4), np.float32), np.ones((1, 4), np.float32))
    assert kv._tables[7] == ["kv/7/p0"]          # unprefixed, as before
    assert kv.session_id is None
    assert kv.store.device == torch.device("cpu")
    kv.close()                                    # no-op teardown


def test_paged_kv_rejects_unnamespaceable_store():
    class Bare:
        pass
    with pytest.raises(TypeError, match="namespace"):
        PagedKVCache(PagedConfig(), Bare(), session_id="kv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kv_dtype_by_name(dtype):
    cfg = PagedConfig(page_size=4, n_kv_heads=1, head_dim=8, hot_pages=1,
                      dtype=dtype)
    kv = PagedKVCache(cfg, device="cpu")
    kv.start(0)
    kv.append(0, np.full((1, 8), 1.5, np.float32),
              torch.full((1, 8), 2.5))
    k, v = kv.gather(0)
    assert k.dtype == v.dtype == getattr(torch, dtype)
    assert float(k[0, 0, 0]) == 1.5 and float(v[0, 0, 0]) == 2.5
    with pytest.raises(ValueError, match="unknown dtype"):
        PagedKVCache(PagedConfig(dtype="float99"), device="cpu")


def test_paged_kv_append_never_writes_a_held_page():
    """The slot write goes into a copy: a tensor read out of the store
    before an append keeps its values."""
    cfg = PagedConfig(page_size=4, n_kv_heads=1, head_dim=2, hot_pages=2)
    kv = PagedKVCache(cfg, device="cpu")
    kv.start(0)
    kv.append(0, np.ones((1, 2), np.float32), np.ones((1, 2), np.float32))
    held = kv.store.get("kv/0/p0")
    kv.append(0, np.full((1, 2), 7, np.float32), np.zeros((1, 2), np.float32))
    assert float(held[0, 1].abs().sum()) == 0.0
    assert float(kv.store.get("kv/0/p0")[0, 1, 0, 0]) == 7.0


# ================================= tests/test_extensions.py paged-KV cases
def test_paged_kv_matches_dense():
    rng = np.random.default_rng(0)
    cfg = PagedConfig(page_size=8, n_kv_heads=2, head_dim=16, hot_pages=2)
    cache = PagedKVCache(cfg, device="cpu")
    cache.start(0)
    s, h = 37, 4
    ks = rng.standard_normal((s, 2, 16)).astype(np.float32)
    vs = rng.standard_normal((s, 2, 16)).astype(np.float32)
    for t in range(s):
        cache.append(0, torch.from_numpy(ks[t]), torch.from_numpy(vs[t]))
    q = torch.from_numpy(rng.standard_normal((h, 16)).astype(np.float32))
    out = cache.attend(0, q)
    # dense reference
    qg = q.numpy().reshape(2, 2, 16)
    sc = np.einsum("kgd,skd->kgs", qg, ks) / np.sqrt(16)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    ref = np.einsum("kgs,skd->kgd", w, vs).reshape(h, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_paged_kv_spills_cold_pages():
    cfg = PagedConfig(page_size=4, n_kv_heads=1, head_dim=8, hot_pages=2)
    store = TieredStore(device="cpu")
    cache = PagedKVCache(cfg, store)
    cache.start(0)
    for t in range(20):   # 5 pages; only 2 may stay hot
        cache.append(0, torch.zeros((1, 8)), torch.zeros((1, 8)))
    tiers = [store.tier_of(nm) for nm in cache._tables[0]]
    assert tiers.count("host") >= 3
    store.reset_stats()
    cache.gather(0)       # reading the full context hits the cold tier
    assert store.stats.host_bytes_read > 0
