"""The serve path end to end on the CPU, and across the packages.

  * the port of tests/test_serve.py's disk e2e: four mixed jobs over ONE
    shared SAFS store with a preemption, resumed, spectra matching
    private serial runs and physical bytes reconciling exactly;
  * the same JobSpec dicts through the reference's SolveSession (JAX, its
    plain path) and the port's (`device="cpu"`): eigenvalues at rtol
    1e-5, per-namespace logical IOStats equal to the byte, and physical
    bytes too with write-behind off;
  * the same jobs through both services: the port's report passes the
    reference's `validate_report` as well as its own;
  * the paged KV cache: the same appends give the same `gather` and the
    same IOStats in both packages;
  * the CLI in a subprocess with `--device cpu`, and its refusal without.

The reference draws a solve's start block with `jax.random`; the job
dicts carry that draw as `options["x0"]`, which the port's solve takes
and the reference's ignores, so both walk the same iterations.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tiered as R
import repro.serve as RS
from repro_torch.core.tiered import TieredStore
from repro_torch.serve import (JobSpec, PagedConfig, PagedKVCache,
                               SolveSession, build_service, validate_report)
from repro_torch.serve.session import DONE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few
    cores, and the services run their own worker threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_x0(d: dict) -> dict:
    """The job dict with the reference's start block as options["x0"]:
    its draw over the operator's rows (n padded to the 64-row blocks)."""
    spec = RS.JobSpec.from_dict(dict(d))
    b = spec.block_size or (2 * spec.nev if spec.method == "lobpcg"
                            else spec.nev)
    n_pad = -(-spec.n // 64) * 64
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(spec.seed),
                                      (n_pad, b), jnp.float32))
    return {**d, "options": {**d.get("options", {}), "x0": x0}}


# ===================================== E2E: multi-tenant solves over SAFS
def _serial_eigenvalues(spec):
    """The same JobSpec solved alone on a fresh private store — the parity
    baseline for the shared-store run."""
    s = SolveSession(spec, TieredStore(device_budget_bytes=64 << 20,
                                       device="cpu"), None)
    assert s.run() == DONE, s.error
    return np.array(s.result["eigenvalues"])


@pytest.mark.disk
def test_multi_tenant_e2e_with_preemption(disk_tmp):
    specs = [
        JobSpec("bg-embed", kind="eigsh", n=800, nnz=8000, nev=4,
                priority=1, tol=1e-9, max_iters=200),
        JobSpec("bg-lobpcg", kind="lobpcg", n=400, nnz=4000, nev=3,
                priority=0, tol=1e-5, max_iters=60),
        JobSpec("bg-cluster", kind="cluster", n=900, k_classes=3, nev=3,
                priority=0, tol=1e-6),
    ]
    rush = JobSpec("rush", kind="eigsh", n=300, nnz=3000, nev=2,
                   priority=5, tol=1e-5, max_iters=60)
    svc = build_service(
        backend="safs", root=os.path.join(disk_tmp, "pages"),
        device_budget=8 << 20, cache_bytes=4 << 20,
        ckpt_root=os.path.join(disk_tmp, "ckpt"), max_concurrent=1,
        poll_interval=0.005, device="cpu")
    try:
        for spec in specs:
            svc.submit(spec)
        # wait until the long high-ish-priority job is mid-flight, then
        # drop the rush job on the queue → the scheduler must suspend it
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            svc.scheduler.tick()
            running = svc.scheduler.stats_dict()["running"]
            if any(p["steps"] >= 1 for p in running.values()):
                break
            time.sleep(0.01)
        svc.submit(rush)
        svc.drain()
        rep = svc.report()
    finally:
        svc.close()

    assert validate_report(rep) == []
    assert RS.validate_report(rep) == []
    jobs = {j["job_id"]: j for j in rep["jobs"]}
    assert len(jobs) == 4 and all(j["state"] == DONE
                                  for j in jobs.values())
    assert sum(j["preemptions"] for j in jobs.values()) >= 1
    preempted = [j for j in jobs.values() if j["preemptions"]]
    assert all(j["resumes"] >= 1 for j in preempted)
    assert all(j["result"]["resumed_step"] is not None for j in preempted)
    # the rush job barely waited; spectra match private serial runs
    assert jobs["rush"]["queue_wait_s"] < jobs["bg-lobpcg"]["queue_wait_s"]
    for spec in specs + [rush]:
        got = np.array(jobs[spec.job_id]["result"]["eigenvalues"])
        np.testing.assert_allclose(got, _serial_eigenvalues(spec),
                                   rtol=1e-5)
    assert jobs["bg-cluster"]["purity"] > 0.9
    # physical accounting: per-namespace sums == backend totals, exactly
    ns, io = rep["backend"]["namespaces"], rep["backend"]["io"]
    for field in ("host_bytes_read", "host_bytes_written"):
        assert sum(d[field] for d in ns.values()) == io[field]
    assert json.loads(json.dumps(rep)) == rep


# ========================================= sessions across the packages
# Krylov–Schur at tol 1e-6 and LOBPCG at 1e-4: both packages cross them
# at the same step (at 1e-5 the reference's float32 floor decides
# LOBPCG's count on some graphs).
CROSS = [
    {"job_id": "ks", "kind": "eigsh", "n": 500, "nnz": 5000, "nev": 3,
     "tol": 1e-6, "max_iters": 80, "seed": 2},
    {"job_id": "pcg", "kind": "lobpcg", "n": 400, "nnz": 4000, "nev": 3,
     "tol": 1e-4, "max_iters": 60, "seed": 1},
    {"job_id": "clu", "kind": "cluster", "n": 600, "k_classes": 3,
     "nev": 3, "tol": 1e-6, "max_iters": 80},
]


@pytest.mark.disk
@pytest.mark.parametrize("d", CROSS, ids=[d["job_id"] for d in CROSS])
def test_sessions_agree_across_packages(d, disk_tmp):
    """One job per package, each in a namespace of a SAFS store with a
    device budget small enough to spill, write-behind off: eigenvalues
    at rtol 1e-5, logical and physical per-namespace bytes equal."""
    d = _with_x0(d)
    budget = 3 * d["n"] * 4 * 2 * d["nev"]

    def store(pkg, name):
        opts = {"root": os.path.join(disk_tmp, name), "cache_bytes": 1 << 20,
                "write_behind": False}
        if pkg is R:
            return R.TieredStore(device_budget_bytes=budget, backend="safs",
                                 backend_opts=opts)
        return TieredStore(device_budget_bytes=budget, backend="safs",
                           backend_opts=opts, device="cpu")

    ref_store, port_store = store(R, "ref"), store(None, "port")
    ref = RS.SolveSession(RS.JobSpec.from_dict(d), ref_store, None)
    port = SolveSession(JobSpec.from_dict(d), port_store, None)
    assert ref.run() == DONE, ref.error
    assert port.run() == DONE, port.error
    for s in (ref_store, port_store):
        s.flush()
    got, want = port.result, ref.result
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=1e-5)
    assert got["n_restarts"] == want["n_restarts"]
    assert got["converged"] and want["converged"]
    assert got["io_stats"] == want["io_stats"]
    assert port_store.namespace_stats() == ref_store.namespace_stats()
    assert port_store.namespace_stats()[d["job_id"]]["host_bytes_read"] > 0
    assert (port_store.backend.stats_dict()["namespaces"]
            == ref_store.backend.stats_dict()["namespaces"])
    if d["kind"] == "cluster":
        assert port.purity == pytest.approx(ref.purity, abs=1e-9)
        assert port.purity > 0.9
    assert port.report()["spectrum"]["nev"] == ref.report()["spectrum"]["nev"]
    ref_store.close()
    port_store.close()


def test_services_agree_and_reports_cross_validate():
    """The same job dicts through both services, one job at a time (each
    session then owns the whole budget, so its bytes do not depend on
    timing): the port's report passes both `validate_report`s, and each
    job's eigenvalues and per-namespace logical IOStats equal the
    reference's."""
    dicts = [_with_x0(d) for d in CROSS]
    reports = {}
    for name, build in (("ref", RS.build_service),
                        ("port", lambda **kw: build_service(device="cpu",
                                                            **kw))):
        svc = build(backend="ram", device_budget=48 << 10,
                    max_concurrent=1)
        for d in dicts:
            svc.submit(dict(d))
        svc.drain()
        reports[name] = svc.report()
        svc.close()
    rep, ref = reports["port"], reports["ref"]
    assert validate_report(rep) == [] and RS.validate_report(rep) == []
    assert RS.validate_report(ref) == [] and validate_report(ref) == []
    assert json.loads(json.dumps(rep)) == rep
    jobs = {j["job_id"]: j for j in rep["jobs"]}
    want = {j["job_id"]: j for j in ref["jobs"]}
    assert [j["job_id"] for j in rep["jobs"]] == \
        [j["job_id"] for j in ref["jobs"]]
    for jid, j in jobs.items():
        np.testing.assert_allclose(j["result"]["eigenvalues"],
                                   want[jid]["result"]["eigenvalues"],
                                   rtol=1e-5)
        assert j["result"]["io_stats"] == want[jid]["result"]["io_stats"]
        assert j["state"] == want[jid]["state"] == DONE
    assert rep["namespaces"] == ref["namespaces"]
    assert any(ns["host_bytes_written"] > 0
               for ns in rep["namespaces"].values())
    assert rep["arbiter"] == ref["arbiter"]
    assert set(rep) == set(ref)


# ============================================= paged KV across the packages
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("session_id", [None, "kv"])
def test_paged_kv_matches_reference(dtype, session_id):
    from repro.serve.paged_kv import PagedConfig as RefCfg
    from repro.serve.paged_kv import PagedKVCache as RefCache
    rng = np.random.default_rng(1)
    geom = dict(page_size=8, n_kv_heads=2, head_dim=16, hot_pages=2,
                dtype=dtype)
    ref_store = R.TieredStore(device_budget_bytes=1 << 20)
    port_store = TieredStore(device_budget_bytes=1 << 20, device="cpu")
    ref_store.namespace("solve").put("V/b0", np.ones(64, np.float32))
    port_store.namespace("solve").put("V/b0", np.ones(64, np.float32))
    ref = RefCache(RefCfg(**geom), ref_store, session_id=session_id)
    port = PagedKVCache(PagedConfig(**geom), port_store,
                        session_id=session_id)
    s = 45
    ks = rng.standard_normal((s, 2, 16)).astype(np.float32)
    vs = rng.standard_normal((s, 2, 16)).astype(np.float32)
    for seq in (0, 3):
        ref.start(seq)
        port.start(seq)
        for t in range(s - 8 * seq):
            ref.append(seq, jnp.asarray(ks[t], dtype),
                       jnp.asarray(vs[t], dtype))
            port.append(seq, torch.from_numpy(ks[t]),
                        torch.from_numpy(vs[t]))
    for seq in (0, 3):
        rk, rv = ref.gather(seq)
        pk, pv = port.gather(seq)
        assert str(pk.dtype).endswith(dtype)
        np.testing.assert_array_equal(pk.float().numpy(),
                                      np.asarray(rk, np.float32))
        np.testing.assert_array_equal(pv.float().numpy(),
                                      np.asarray(rv, np.float32))
        q = rng.standard_normal((4, 16)).astype(np.float32)
        np.testing.assert_allclose(
            port.attend(seq, torch.from_numpy(q)).numpy(),
            np.asarray(ref.attend(seq, jnp.asarray(q))),
            rtol=2e-5, atol=2e-6)
    assert port_store.stats.as_dict() == ref_store.stats.as_dict()
    assert port_store.namespace_stats() == ref_store.namespace_stats()
    assert port_store.stats.host_bytes_read > 0
    assert sorted(port_store.names()) == sorted(ref_store.names())
    ref.close()
    port.close()
    assert sorted(port_store.names()) == sorted(ref_store.names())
    assert port_store.namespace("solve").names() == ["V/b0"]


# ===================================================================== CLI
CLI_JOBS = [
    {"job_id": "embed", "kind": "eigsh", "n": 600, "nnz": 6000, "nev": 4,
     "tol": 1e-6, "max_iters": 80},
    {"job_id": "pcg", "kind": "lobpcg", "n": 400, "nnz": 4000, "nev": 3,
     "tol": 1e-5, "max_iters": 60, "priority": 1},
    {"job_id": "cluster", "kind": "cluster", "n": 600, "k_classes": 3,
     "nev": 3, "tol": 1e-6, "priority": 2},
]


def _cli(args, tmp_path, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=str(tmp_path))


@pytest.mark.disk
def test_cli_serves_jobs_on_the_cpu(disk_tmp, tmp_path):
    jobs = os.path.join(disk_tmp, "jobs.json")
    with open(jobs, "w") as fh:
        json.dump(CLI_JOBS, fh)
    out = os.path.join(disk_tmp, "report.json")
    args = ["--jobs", jobs, "--out", out, "--backend", "safs",
            "--root", os.path.join(disk_tmp, "pages"),
            "--ckpt-root", os.path.join(disk_tmp, "ckpt"),
            "--device-budget", str(8 << 20), "--cache-bytes", str(4 << 20),
            "--max-concurrent", "2"]
    run = _cli(args + ["--device", "cpu"], tmp_path)
    assert run.returncode == 0, run.stderr
    with open(out) as fh:
        rep = json.load(fh)
    assert rep["valid"] and rep["errors"] == []
    assert validate_report(rep) == [] and RS.validate_report(rep) == []
    assert {j["job_id"] for j in rep["jobs"]} == {"embed", "pcg",
                                                  "cluster"}
    assert "valid=True" in run.stderr
    # without --device cpu the service runs on the card; there is none
    run = _cli(args, tmp_path)
    assert run.returncode != 0
    assert "CUDA" in run.stderr
