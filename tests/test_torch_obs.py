"""repro_torch.obs against the JAX package's `tests/test_obs.py`: the
metrics registry, convergence tracking, the trace report, and traced
solves.

  * metrics: `snapshot_counters` over every counter spelling, recursive
    `delta` with derived fields recomputed, `gauges`, registry isolation,
    and outputs equal to `repro.obs.metrics` on the same inputs;
  * progress: the ETA estimator, its events and `chain`, equal to
    `repro.obs.progress` update for update;
  * `solve(..., trace=)` on the RAM and the SAFS tier: a complete
    timeline whose `pass.subspace` spans reconcile with `IOStats` to the
    byte; a port trace passes `repro.obs.report.validate` and a
    reference trace passes the port's, and both reports render the same
    sections;
  * the report's CLI and its validation of broken traces.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import repro.core as R
from repro.obs import metrics as ref_metrics
from repro.obs import report as ref_report
from repro.obs.progress import ConvergenceTracker as RefTracker
from repro_torch.convert import tiled_from_arrays
from repro_torch.core import GraphOperator, IOStats, TieredStore, solve
from repro_torch.graphs import pack_tiles
from repro_torch.obs import (MetricsRegistry, SCHEMA, ConvergenceTracker,
                             Tracer, delta, derive, gauges,
                             snapshot_counters, snapshot_store, trace)
from repro_torch.obs import report


def _tm(small_graph):
    n, r, c, v, _ = small_graph
    return pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)


def _op(small_graph, store=None):
    return GraphOperator(_tm(small_graph), store=store,
                         device=None if store is not None else "cpu")


# --------------------------------------------------------------- metrics
def test_snapshot_counters_duck_typing():
    assert snapshot_counters(None) is None
    assert snapshot_counters({"a": 1}) == {"a": 1}
    st = IOStats()
    st.cache_hits = 3
    snap = snapshot_counters(st)                  # via as_dict()
    assert snap["cache_hits"] == 3 and "hit_rate" in snap

    class HasStatsAttr:
        stats = st
    assert snapshot_counters(HasStatsAttr())["cache_hits"] == 3

    class HasStatsMethod:
        def stats(self):
            return {"x": 1}
    assert snapshot_counters(HasStatsMethod()) == {"x": 1}

    with pytest.raises(TypeError, match="counter surface"):
        snapshot_counters(object())


def test_delta_recurses_and_recomputes_derived():
    before = {"logical": {"cache_hits": 10, "cache_misses": 10,
                          "hit_rate": 0.5, "passes": 2,
                          "pass_bytes_read": 200, "bytes_per_pass": 100.0},
              "tag": "x"}
    after = {"logical": {"cache_hits": 40, "cache_misses": 20,
                         "hit_rate": 2 / 3, "passes": 4,
                         "pass_bytes_read": 600, "bytes_per_pass": 150.0},
             "tag": "x"}
    d = delta(before, after)
    assert d["logical"]["cache_hits"] == 30
    assert d["logical"]["hit_rate"] == pytest.approx(30 / 40)
    assert d["logical"]["bytes_per_pass"] == pytest.approx(400 / 2)
    assert d["tag"] == "x"
    assert derive({"cache_hits": 1, "cache_misses": 3})["hit_rate"] == 0.25
    assert d == ref_metrics.delta(before, after)


@pytest.mark.parametrize("backend", ["ram", "safs"])
def test_store_snapshot_and_gauges_equal_reference(tmp_path, backend):
    """The same operations on a port store and a reference store give the
    same logical snapshot, and `gauges` of each the same figures."""
    opts = {} if backend == "ram" else {
        "backend": "safs", "backend_opts": {
            "root": str(tmp_path / "p"), "enable_prefetch": False,
            "write_behind": False}}
    ropts = {} if backend == "ram" else {
        "backend": "safs", "backend_opts": {
            "root": str(tmp_path / "r"), "enable_prefetch": False,
            "write_behind": False}}
    port = TieredStore(device="cpu", **opts)
    ref = R.TieredStore(**ropts)
    a = np.ones((64, 4), np.float32)
    for store in (port, ref):
        store.put("a", a)
        store.demote("a")
        store.get("a")
    sp, sr = snapshot_store(port), ref_metrics.snapshot_store(ref)
    assert sp["logical"] == sr["logical"]
    assert sp["device_bytes"] == sr["device_bytes"]
    gp, gr = gauges(sp), ref_metrics.gauges(sr)
    for k in ("logical_hit_rate", "bytes_per_pass", "passes",
              "wb_backlog_pages", "write_read_ratio"):
        assert gp[k] == gr[k], k
    assert gp["overlap_fraction"] == 0.0
    if backend == "safs":
        assert set(sp["backend"]) == set(sr["backend"])
        assert sp["backend"]["io"] == sr["backend"]["io"]
    port.close()
    ref.close()


def test_metrics_registry_isolation():
    reg = MetricsRegistry()
    reg.register("good", lambda: {"v": 1})
    reg.register("bad", lambda: 1 / 0)
    reg.register("stats_obj", IOStats())
    snap = reg.snapshot()
    assert snap["good"] == {"v": 1}
    assert "ZeroDivisionError" in snap["bad"]["error"]
    assert "host_bytes_read" in snap["stats_obj"]
    reg.unregister("bad")
    assert reg.names() == ["good", "stats_obj"]


# ------------------------------------------------------- convergence/ETA
def test_convergence_tracker_eta_decay_equals_reference():
    t = Tracer()
    c = ConvergenceTracker(t, tol=1e-8, nev=2, method="test")
    rc = RefTracker(None, tol=1e-8, nev=2, method="test")
    r = 1.0
    etas = []
    for k in range(6):
        for tr in (c, rc):
            tr.update(k, np.array([1.0, 1.0]), np.array([r, r / 2]))
        etas.append(c.eta_steps())
        assert etas[-1] == rc.eta_steps()
        assert c.decay_rate() == rc.decay_rate()
        r *= 0.1
    assert etas[0] is None
    assert etas[-1] is not None and etas[-1] < etas[1]
    evs = [r for r in t.records() if r["name"] == "convergence.step"]
    assert len(evs) == 6
    assert evs[-1]["args"]["eta_steps"] == etas[-1]
    assert c.history == rc.history


def test_convergence_tracker_converged_stagnant_and_chain():
    c = ConvergenceTracker(None, tol=1e-6, nev=1)
    c.update(0, np.array([1.0]), np.array([1e-9]))
    assert c.eta_steps() == 0
    c2 = ConvergenceTracker(None, tol=1e-12, nev=1)
    for k in range(5):
        c2.update(k, np.array([1.0]), np.array([1e-3]))
    assert c2.eta_steps() is None
    seen = []
    c3 = ConvergenceTracker(None, tol=1e-6, nev=1)
    cb = c3.chain(lambda k, th, r: seen.append(k))
    cb(0, np.array([1.0]), np.array([0.5]))
    assert seen == [0] and len(c3.history) == 1


# ------------------------------------------------------- traced solves
def test_traced_solve_ram_reconciles(small_graph, tmp_path):
    path = str(tmp_path / "solve.jsonl")
    res = solve(_op(small_graph), 4, method="krylov_schur", which="LA",
                tol=1e-5, max_iters=100, block_size=4, trace=path)
    assert isinstance(res.trace, Tracer)
    assert trace.active() is None          # uninstalled after the solve
    records = report.load(path)
    assert report.validate(records) == []
    assert ref_report.validate(records) == []
    names = {r["name"] for r in records if r.get("type") == "span"}
    assert {"solve", "pass.subspace", "operator.matmat"} <= names
    assert len(report.events(records, "convergence.step")) == \
        res.n_restarts + 1
    rec = report.reconcile(records)
    assert rec["exact"] and rec["lossless"]
    assert rec["span_pass_count"] == rec["iostats_passes"] > 0
    assert rec["span_pass_bytes"] == rec["iostats_pass_bytes_read"] > 0
    assert rec == ref_report.reconcile(records)
    root = next(r for r in records
                if r.get("type") == "span" and r["name"] == "solve")
    assert root["args"]["converged"] == res.converged
    assert root["args"]["nev"] == 4


def test_traced_solve_accepts_tracer_instance(small_graph):
    t = Tracer()
    res = solve(_op(small_graph), 2, method="lobpcg", tol=1e-4,
                max_iters=300, block_size=8, trace=t)
    assert res.trace is t
    assert t.counts()["spans"] > 0
    assert any(r["name"] == "convergence.step" for r in t.records())
    untraced = solve(_op(small_graph), 2, method="krylov_schur", which="LA",
                     tol=1e-4, max_iters=60)
    assert untraced.trace is None


@pytest.mark.disk
def test_traced_solve_safs_full_timeline(small_graph, disk_tmp, tmp_path):
    """One traced safs solve holds operator applies, subspace passes,
    prefetch waits and write-behind retires, plus convergence events,
    reconciles to the byte and passes both packages' validation."""
    n = small_graph[0]
    store = TieredStore(
        device_budget_bytes=2 * n * 4 * 4, backend="safs", device="cpu",
        backend_opts={"root": os.path.join(disk_tmp, "pages"),
                      "cache_bytes": 3 * n * 4 * 4})
    path = str(tmp_path / "safs_solve.jsonl")
    res = solve(_op(small_graph, store=store), 4, method="krylov_schur",
                which="LA", tol=1e-6, max_iters=100, block_size=4,
                group_size=2, store=store, trace=path)
    snap = store.backend.stats_dict()
    store.close()
    assert snap["integrity"]["pages_verified"] > 0
    assert snap["integrity"]["crc_failures"] == 0
    assert snap["write_behind"]["pages_retired"] > 0
    records = report.load(path)
    assert report.validate(records) == []
    assert ref_report.validate(records) == []
    names = {r["name"] for r in records if r.get("type") == "span"}
    assert {"solve", "operator.matmat", "pass.subspace", "safs.fill",
            "safs.wb.retire"} <= names
    rec = report.reconcile(records)
    assert rec["exact"], rec
    integ = report.integrity_reconcile(records)
    assert integ["exact"] and integ == ref_report.integrity_reconcile(
        records)
    assert res.converged


def test_reference_trace_passes_port_validation(small_graph, tmp_path):
    """A trace of the reference's traced solve passes the port's
    `validate`, and both packages render the same report for it."""
    n, r, c, v, _ = small_graph
    from repro.graphs import pack_tiles as ref_pack
    tm = ref_pack(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    path = str(tmp_path / "ref.jsonl")
    R.solve(R.GraphOperator(tm, impl="ref"), 4, method="krylov_schur",
            which="LA", tol=1e-5, max_iters=100, block_size=4, impl="ref",
            trace=path)
    records = report.load(path)
    assert report.validate(records) == []
    assert report.reconcile(records)["exact"]
    assert report.render(records) == ref_report.render(records)
    port_path = str(tmp_path / "port.jsonl")
    solve(GraphOperator(tiled_from_arrays(dataclasses.asdict(tm)),
                        device="cpu"), 4, method="krylov_schur", which="LA",
          tol=1e-5, max_iters=100, block_size=4, trace=port_path)
    port = report.load(port_path)
    assert report.phase_table(port)[0][0] == "solve"
    assert {n for n, *_ in report.phase_table(port)} == \
        {n for n, *_ in report.phase_table(records)}


# ---------------------------------------------------------------- report
def test_report_validate_catches_problems():
    assert report.validate([]) == ["empty trace"]
    bad = [{"type": "meta", "schema": "other/v9"},
           {"type": "span", "name": "s", "ts": 0.0, "dur": -5.0, "args": {}}]
    problems = report.validate(bad)
    assert any("schema" in p for p in problems)
    assert any("negative duration" in p for p in problems)
    lying = [
        {"type": "meta", "schema": SCHEMA},
        {"type": "span", "name": report.PASS_SPAN, "ts": 0.0, "dur": 1.0,
         "args": {"bytes": 100}},
        {"type": "metrics", "name": "solve.io", "ts": 2.0,
         "data": {"delta": {"logical": {"passes": 2,
                                        "pass_bytes_read": 999}}}},
        {"type": "summary", "spans": 1, "events": 0, "metrics": 1,
         "dropped": 0},
    ]
    assert any("mismatch" in p for p in report.validate(lying))
    assert report.validate(lying) == ref_report.validate(lying)
    lying[-1]["dropped"] = 7
    assert report.validate(lying) == []


def test_report_cli_roundtrip(small_graph, tmp_path, capsys):
    path = str(tmp_path / "cli.jsonl")
    chrome = str(tmp_path / "cli_chrome.json")
    solve(_op(small_graph), 2, method="krylov_schur", which="LA",
          tol=1e-4, max_iters=60, trace=path)
    assert report.main([path, "--validate", "--chrome", chrome]) == 0
    out = capsys.readouterr().out
    assert "validation OK" in out and "phase breakdown" in out
    doc = json.load(open(chrome))
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    with open(path, "a") as f:
        f.write(json.dumps({"type": "span", "name": "x", "ts": 0.0,
                            "dur": -1.0, "args": {}}) + "\n")
    assert report.main([path, "--validate"]) == 1
