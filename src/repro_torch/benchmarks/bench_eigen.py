"""Paper Fig. 12 + Table 3 — end-to-end eigensolver — plus the solver
family head-to-head (`--smoke`). Port of `benchmarks/bench_eigen.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_eigen --smoke \
        [--device cpu] [--out FAMILY.json]

Solver family (`collect`): the paper's §2 argument for Krylov–Schur is
that it converges with the least I/O. With Krylov–Schur and LOBPCG behind
`core.solver.solve` on the same SAFS-backed TieredStore, that claim is a
measurement: bytes moved through the tier per converged eigenpair, per
method, with the streamed-pass accounting (`IOStats.passes` /
`pass_bytes_read`) and the physical backend bytes side by side.
`validate` gates spectrum parity between the two methods and between
LOBPCG's SAFS and RAM paths. The counters count bytes, not time, so on
the same start blocks they equal the reference's to the byte
(`start_blocks`: the reference draws its own with `jax.random`).

`run` (the Fig. 12 / Table 3 rows) keeps the reference's model of SEM
runtime: compute plus tier traffic at the paper's measured tier
bandwidth, with the traffic from the byte-exact counters.

Runs on the CUDA card unless `--device cpu`; with `--out` the family
metrics are written as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import (GraphOperator, TieredStore, eigsh, lobpcg,
                              solve, svds)
from repro_torch.graphs import (clustered_web_graph, normalized_adjacency,
                                pack_tiles, rmat_graph)

SLOW_TIER_BW = 10.9e9


def _family_op(n: int, nnz: int, store: TieredStore) -> GraphOperator:
    r, c, v = rmat_graph(n, nnz, seed=7, symmetric=True)
    r2, c2, v2 = normalized_adjacency(n, r, c, v)
    tm = pack_tiles(n, n, r2, c2, v2, block_shape=(64, 64), min_block_nnz=4)
    return GraphOperator(tm, store=store)


def _run_method(method: str, n: int, nnz: int, nev: int, tol: float,
                store: TieredStore, x0=None, **kw) -> tuple:
    op = _family_op(n, nnz, store)
    store.reset_stats()
    t0 = time.perf_counter()
    res = solve(op, nev, method=method, which="LA", tol=tol, store=store,
                x0=x0, **kw)
    us = (time.perf_counter() - t0) * 1e6
    return res, us


def _solver_family(root: str, n: int, nnz: int, nev: int, tol: float,
                   device, start_blocks: dict) -> dict:
    """KS vs LOBPCG on the same SAFS-backed graph: bytes per converged
    eigenpair (logical tier traffic / nev), streamed-pass accounting and
    spectrum parity. Plus a RAM-backend LOBPCG for the SAFS-vs-RAM gate."""
    out: dict = {"n": n, "nnz": nnz, "nev": nev, "tol": tol,
                 "backend": "safs"}
    evs = {}
    methods = (("krylov_schur", dict(block_size=4, max_iters=100)),
               ("lobpcg", dict(block_size=2 * nev, max_iters=300)))
    for method, kw in methods:
        # budget and cache well below the working set, so blocks really
        # demote and the file backend sees physical traffic
        store = TieredStore(
            device_budget_bytes=2 * n * 4 * 4, backend="safs",
            backend_opts={"root": os.path.join(root, method),
                          "cache_bytes": 2 * n * 4 * 4}, device=device)
        res, us = _run_method(method, n, nnz, nev, tol, store,
                              x0=start_blocks.get(method), **kw)
        s = store.stats
        logical = s.host_bytes_read + s.host_bytes_written
        evs[method] = np.sort(np.asarray(res.eigenvalues, np.float64))
        out[method] = {
            "us": us,
            "converged": bool(res.converged),
            "iters": int(res.n_restarts),
            "n_ops": int(res.n_ops),
            "workset_cols": int(res.m_subspace),
            "eigenvalues": [float(x) for x in evs[method]],
            "host_bytes_read": int(s.host_bytes_read),
            "host_bytes_written": int(s.host_bytes_written),
            "passes": int(s.passes),
            "pass_bytes_read": int(s.pass_bytes_read),
            "physical_bytes_read": int(store.backend.stats.host_bytes_read),
            "bytes_per_converged_pair": float(logical / nev),
        }
        store.close()
    out["spectrum_max_rel_err"] = float(np.max(
        np.abs(evs["krylov_schur"] - evs["lobpcg"])
        / np.maximum(np.abs(evs["krylov_schur"]), 1e-12)))
    out["lobpcg_bytes_over_ks"] = (
        out["lobpcg"]["bytes_per_converged_pair"]
        / max(out["krylov_schur"]["bytes_per_converged_pair"], 1.0))

    st_ram = TieredStore(device_budget_bytes=4 * n * 4 * max(nev, 4),
                         device=device)
    res_ram, _ = _run_method("lobpcg", n, nnz, nev, tol, st_ram,
                             x0=start_blocks.get("lobpcg"),
                             block_size=2 * nev, max_iters=300)
    ev_ram = np.sort(np.asarray(res_ram.eigenvalues, np.float64))
    out["lobpcg_ram_converged"] = bool(res_ram.converged)
    out["lobpcg_safs_vs_ram_rel_err"] = float(np.max(
        np.abs(evs["lobpcg"] - ev_ram) / np.maximum(np.abs(ev_ram), 1e-12)))
    return out


def collect(*, smoke: bool = False, device=None,
            start_blocks: dict | None = None) -> dict:
    """The family comparison. `start_blocks` maps a method name to its
    start block ((n, 4) for krylov_schur, (n, 2·nev) for lobpcg); a
    method without one draws its own from a torch.Generator."""
    n, nnz, nev = (1200, 10000, 4) if smoke else (6000, 72000, 8)
    out: dict = {"schema": "bench_solver_family/v1", "smoke": smoke}
    root = tempfile.mkdtemp(prefix="bench_family_")
    try:
        out["family"] = _solver_family(root, n, nnz, nev, 1e-6, device,
                                       start_blocks or {})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def validate(metrics: dict) -> None:
    """Raises AssertionError on a regression."""
    assert "family" in metrics, "metrics missing 'family'"
    fam = metrics["family"]
    for method in ("krylov_schur", "lobpcg"):
        m = fam.get(method)
        assert m, f"family comparison missing {method!r}"
        for k in ("converged", "passes", "pass_bytes_read",
                  "host_bytes_read", "physical_bytes_read",
                  "bytes_per_converged_pair", "eigenvalues"):
            assert k in m, f"{method} missing field {k!r}"
        assert m["converged"], f"{method} did not converge: {m}"
        assert m["passes"] > 0, (method, m["passes"])
        assert m["pass_bytes_read"] > 0, (method, m["pass_bytes_read"])
        assert m["physical_bytes_read"] > 0, (method,
                                              m["physical_bytes_read"])
        assert m["bytes_per_converged_pair"] > 0, m
    assert fam["spectrum_max_rel_err"] <= 1e-4, (
        f"KS / LOBPCG spectra diverged: {fam['spectrum_max_rel_err']:.3e}")
    assert fam["lobpcg_ram_converged"], "RAM-path LOBPCG did not converge"
    assert fam["lobpcg_safs_vs_ram_rel_err"] <= 1e-5, (
        f"LOBPCG safs vs RAM spectra diverged: "
        f"{fam['lobpcg_safs_vs_ram_rel_err']:.3e}")


def run(csv_rows: list, device=None):
    """The reference's CSV rows (Fig. 12, the LOBPCG-vs-KS row, Table 3,
    the family row) on the port."""
    n, nnz = 20000, 240000
    r, c, v = rmat_graph(n, nnz, seed=3, symmetric=True)
    r2, c2, v2 = normalized_adjacency(n, r, c, v)
    tm = pack_tiles(n, n, r2, c2, v2, block_shape=(64, 64), min_block_nnz=4)

    for nev in (4, 8, 16):                      # Fig 12: SEM vs IM
        store = TieredStore(device=device)
        op = GraphOperator(tm, store=store)
        t0 = time.perf_counter()
        res = eigsh(op, nev, block_size=4, tol=1e-6, max_restarts=100,
                    store=store)
        t_compute = time.perf_counter() - t0
        s = store.stats
        io = s.host_bytes_read + s.host_bytes_written
        t_sem = t_compute + io / SLOW_TIER_BW
        csv_rows.append(("fig12_eigensolver", f"nev={nev}", t_sem * 1e6,
                         f"sem_over_im={t_compute / t_sem:.2f},"
                         f"converged={res.converged},"
                         f"restarts={res.n_restarts}"))

    st_lo = TieredStore(device=device)           # §2: KS vs LOBPCG I/O
    t0 = time.perf_counter()
    res_lo = lobpcg(GraphOperator(tm, store=st_lo), 4, block_size=8,
                    tol=1e-4, max_iters=150, which="LA", store=st_lo)
    csv_rows.append(("related_lobpcg_vs_ks", "nev=4",
                     (time.perf_counter() - t0) * 1e6,
                     f"ops={res_lo.n_ops},workset_cols={res_lo.m_subspace},"
                     f"converged={res_lo.converged}"))

    np_, nnzp = 34000, 1290000          # Table 3: scaled page graph → SVD
    r, c, v = clustered_web_graph(np_, nnzp, seed=4)
    tma = pack_tiles(np_, np_, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    tmat = pack_tiles(np_, np_, c, r, v, block_shape=(64, 64), min_block_nnz=4)
    store = TieredStore(device_budget_bytes=64 << 20, device=device)
    t0 = time.perf_counter()
    res = svds(GraphOperator(tma, store=store),
               GraphOperator(tmat, store=store), 8, block_size=2, tol=1e-6,
               max_restarts=60, store=store)
    wall = time.perf_counter() - t0
    s = store.stats
    csv_rows.append(("table3_page_scaled", "nev=8", wall * 1e6,
                     f"read_bytes={s.host_bytes_read},"
                     f"write_bytes={s.host_bytes_written},"
                     f"write_read_ratio="
                     f"{s.host_bytes_written / max(s.host_bytes_read, 1):.4f},"
                     f"device_hwm_bytes={store.device_bytes()},"
                     f"converged={res.converged}"))

    fam = collect(smoke=True, device=device)["family"]
    ks, lo = fam["krylov_schur"], fam["lobpcg"]
    csv_rows.append((
        "solver_family", f"nev={fam['nev']}", lo["us"],
        f"bytes_per_pair_ks={ks['bytes_per_converged_pair']:.0f},"
        f"bytes_per_pair_lobpcg={lo['bytes_per_converged_pair']:.0f},"
        f"spectrum_rel_err={fam['spectrum_max_rel_err']:.1e}"))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down sizes (n=1200, nev=4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, metavar="FAMILY.json",
                    help="write the family metrics here")
    args = ap.parse_args(argv)
    metrics = collect(smoke=args.smoke, device=args.device)
    validate(metrics)
    if args.out:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        print(f"wrote {args.out}")
    fam = metrics["family"]
    print(f"solver family (n={fam['n']}, nev={fam['nev']}, safs):")
    for tag in ("krylov_schur", "lobpcg"):
        m = fam[tag]
        print(f"  {tag:13s} iters={m['iters']:4d} ops={m['n_ops']:4d} "
              f"passes={m['passes']:5d} "
              f"bytes/pair={m['bytes_per_converged_pair']/1e6:8.2f} MB "
              f"(physical read {m['physical_bytes_read']/1e6:.1f} MB)")
    print(f"  lobpcg/ks bytes-per-pair ratio: "
          f"{fam['lobpcg_bytes_over_ks']:.2f}")
    print(f"  spectrum parity ks-vs-lobpcg {fam['spectrum_max_rel_err']:.1e}"
          f", lobpcg safs-vs-ram {fam['lobpcg_safs_vs_ram_rel_err']:.1e}")
    return metrics


if __name__ == "__main__":
    main()
