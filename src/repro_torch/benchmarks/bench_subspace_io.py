"""Subspace pass fusion — §3.4.3 reads-per-iteration, byte-exact. Port of
`benchmarks/bench_subspace_io.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_subspace_io \
        --smoke [--device cpu] [--out SUBSPACE_IO.json]

The paper's cost claim: reorthogonalization (MvTransMv + MvTimesMatAddMv
over the on-SSD subspace) dominates SEM runtime, so the wins come from
minimizing *passes* over the vector subspace. This bench measures the
before/after of the fused streamed-pass engine (`core.stream.SubspacePass`):

  expansion   host-tier bytes read by one CGS2 block expansion over an
              NB-block subspace (every block demoted to the slow tier —
              the controlled measurement): unfused = 2×(MvTransMv +
              MvTimesMatAddMv) = 4 streamed reads; fused = 2 `project_out`
              reads. The acceptance bar is fused/unfused ≤ 0.6 at NB ≥ 8
              (exact value 0.5: same bytes per pass, half the passes).
  compress    host-tier bytes read by restart compression onto k_keep
              columns: unfused = one full pass per output block (k_keep/b
              reads of the subspace); fused = exactly ONE streamed read
              regardless of k_keep (multi-accumulator TSGEMM).
  eigsh_e2e   whole-solve ladder on the ram backend: total logical reads,
              streamed passes, and fused-vs-unfused eigenvalue parity.
  safs        the same expansion on the file backend: wall-clock (the
              secondary column — IOStats bytes are the primary metric)
              plus physical disk bytes, and fused-vs-unfused eigsh
              spectrum parity with the subspace in page files.

The byte and pass counters count bytes moved, not time, so on the same
inputs they equal the reference's to the byte. The solves' start blocks
are drawn from a `torch.Generator`; the reference draws its own with
`jax.random`, which torch cannot reproduce, so a parity check hands that
draw to the ladder functions as `x0`.

`validate()` fails (non-zero exit) on missing fields, a fused/unfused
expansion read ratio above 0.6, a compress that re-reads the subspace, or
parity worse than rtol 1e-5. Runs on the CUDA card (gram, tsgemm and the
SpMM as hand-written kernels) unless `--device cpu`; walls are host-clock
seconds around synchronized work. With `--out` the metrics are written
as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import (GraphOperator, MultiVector, TieredStore,
                              bcgs2, eigsh)
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs import normalized_adjacency, pack_tiles, rmat_graph


def _demoted_mv(store, n: int = 512, b: int = 4, nb: int = 8,
                seed: int = 0) -> MultiVector:
    """An nb-block subspace with EVERY block on the slow tier (pins
    released) — host_bytes_read then counts each streamed pass exactly.
    The same draws and the same I/O state as the reference's fixture."""
    rng = np.random.default_rng(seed)
    mv = MultiVector(store, n, group_size=2)
    for _ in range(nb):
        mv.append_block(rng.standard_normal((n, b)).astype(np.float32))
    for i in range(nb):
        store.unpin(mv._block_name(i))
        store.demote(mv._block_name(i))
    return mv


def _draw(store, seed: int, n: int, b: int):
    return store.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, b)).astype(np.float32))


def _expansion_ladder(n: int, b: int, nb: int, device) -> dict:
    sub_bytes = n * b * 4 * nb
    out = {"nblocks": nb, "block_size": b, "n": n,
           "subspace_bytes": sub_bytes}
    for tag, fused in (("fused", True), ("unfused", False)):
        store = TieredStore(device=device)
        mv = _demoted_mv(store, n, b, nb)
        w = _draw(store, 9, n, b)
        store.reset_stats()
        bcgs2(mv, w, fused=fused)
        s = store.stats
        out[tag] = {"host_bytes_read": s.host_bytes_read,
                    "passes": s.passes,
                    "reads_over_subspace": s.host_bytes_read / sub_bytes}
        store.close()
    out["fused_over_unfused"] = (out["fused"]["host_bytes_read"]
                                 / max(out["unfused"]["host_bytes_read"], 1))
    return out


def _compress_ladder(n: int, b: int, nb: int, device) -> dict:
    sub_bytes = n * b * 4 * nb
    m = nb * b
    k_keep = m // 2
    out = {"nblocks": nb, "k_keep": k_keep, "subspace_bytes": sub_bytes}
    for tag, fused in (("fused", True), ("unfused", False)):
        store = TieredStore(device=device)
        mv = _demoted_mv(store, n, b, nb)
        q = _draw(store, 10, m, k_keep)
        store.reset_stats()
        mv.compress(q, [b] * (k_keep // b), fused=fused)
        s = store.stats
        out[tag] = {"host_bytes_read": s.host_bytes_read,
                    "passes": s.passes,
                    "reads_over_subspace": s.host_bytes_read / sub_bytes}
        store.close()
    out["fused_over_unfused"] = (out["fused"]["host_bytes_read"]
                                 / max(out["unfused"]["host_bytes_read"], 1))
    return out


def _graph_op(n: int, nnz: int, store) -> GraphOperator:
    r, c, v = rmat_graph(n, nnz, seed=5, symmetric=True)
    r2, c2, v2 = normalized_adjacency(n, r, c, v)
    tm = pack_tiles(n, n, r2, c2, v2, block_shape=(64, 64), min_block_nnz=4)
    return GraphOperator(tm, store=store)


def _eigsh_e2e(n: int, nnz: int, nev: int, device, x0=None) -> dict:
    out: dict = {"n": n, "nev": nev}
    evs = {}
    for tag, fused in (("fused", True), ("unfused", False)):
        store = TieredStore(device=device)
        op = _graph_op(n, nnz, store)
        res = eigsh(op, nev, block_size=4, tol=1e-7, max_restarts=200,
                    store=store, fused_passes=fused, x0=x0)
        s = store.stats
        evs[tag] = np.sort(res.eigenvalues)
        out[tag] = {"host_bytes_read": s.host_bytes_read,
                    "host_bytes_written": s.host_bytes_written,
                    "passes": s.passes,
                    "pass_bytes_read": s.pass_bytes_read,
                    "bytes_per_pass": s.bytes_per_pass(),
                    "converged": bool(res.converged),
                    "n_restarts": int(res.n_restarts)}
        store.close()
    out["max_rel_err"] = float(np.max(
        np.abs(evs["fused"] - evs["unfused"]) / np.abs(evs["unfused"])))
    out["passes_fused_over_unfused"] = (out["fused"]["passes"]
                                        / max(out["unfused"]["passes"], 1))
    # subspace bytes actually streamed over the whole solve (attributed to
    # passes — operator image reads sharing the store are excluded)
    out["pass_bytes_fused_over_unfused"] = (
        out["fused"]["pass_bytes_read"]
        / max(out["unfused"]["pass_bytes_read"], 1))
    return out


def _safs_ladder(root: str, n: int, b: int, nb: int, eig_n: int, nev: int,
                 device, x0=None) -> dict:
    """File-backend column: wall-clock per expansion (secondary metric)
    plus fused-vs-unfused spectrum parity with the subspace in pages."""
    out: dict = {"n": n, "nblocks": nb}
    for tag, fused in (("fused", True), ("unfused", False)):
        store = TieredStore(
            device_budget_bytes=2 * n * 4 * b, backend="safs",
            backend_opts={"root": os.path.join(root, f"exp_{tag}"),
                          "cache_bytes": 3 * n * 4 * b}, device=device)
        mv = _demoted_mv(store, n, b, nb, seed=12)
        w = _draw(store, 11, n, b)
        store.flush()
        store.reset_stats()
        synchronize(store.device)
        t0 = time.perf_counter()
        bcgs2(mv, w, fused=fused)
        synchronize(store.device)
        us = (time.perf_counter() - t0) * 1e6
        out[tag] = {"us": us,
                    "logical_bytes_read": store.stats.host_bytes_read,
                    "physical_bytes_read": store.backend.stats.host_bytes_read,
                    "passes": store.stats.passes}
        store.close()
    out["wallclock_fused_over_unfused"] = (out["fused"]["us"]
                                           / max(out["unfused"]["us"], 1e-9))

    evs = {}
    for tag, fused in (("fused", True), ("unfused", False)):
        store = TieredStore(
            device_budget_bytes=2 * eig_n * 4 * 4, backend="safs",
            backend_opts={"root": os.path.join(root, f"eig_{tag}"),
                          "cache_bytes": 3 * eig_n * 4 * 4}, device=device)
        op = _graph_op(eig_n, 12 * eig_n, store)
        res = eigsh(op, nev, block_size=4, tol=1e-6, max_restarts=100,
                    store=store, fused_passes=fused, x0=x0)
        evs[tag] = np.sort(res.eigenvalues)
        store.close()
    out["eigsh_max_rel_err"] = float(np.max(
        np.abs(evs["fused"] - evs["unfused"]) / np.abs(evs["unfused"])))
    return out


def collect(*, smoke: bool = False, device=None, n: int | None = None,
            b: int = 4, nb: int | None = None, e2e_n: int | None = None,
            e2e_nnz: int | None = None, nev: int = 8,
            eig_n: int | None = None) -> dict:
    """Every ladder; the sizes default to the reference's (its smoke sizes
    with `smoke`)."""
    dn, dnb = (4000, 8) if smoke else (20000, 16)
    de2e_n, de2e_nnz = (1200, 10000) if smoke else (3000, 30000)
    n, nb = n or dn, nb or dnb
    e2e_n, e2e_nnz = e2e_n or de2e_n, e2e_nnz or de2e_nnz
    eig_n = eig_n or (4000 if smoke else 6000)   # safs parity solve
    dev = resolve_device(device)
    out: dict = {"schema": "bench_subspace_io/v1", "smoke": smoke,
                 "device": str(dev)}
    out["expansion"] = _expansion_ladder(n, b, nb, dev)
    out["compress"] = _compress_ladder(n, b, nb, dev)
    out["eigsh_e2e"] = _eigsh_e2e(e2e_n, e2e_nnz, nev, dev)
    root = tempfile.mkdtemp(prefix="bench_subio_")
    try:
        out["safs"] = _safs_ladder(root, n, b, nb, eig_n, nev, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def validate(metrics: dict) -> None:
    """Raises AssertionError on a pass-count or parity regression."""
    for k in ("expansion", "compress", "eigsh_e2e", "safs"):
        assert k in metrics, f"subspace_io metrics missing {k!r}"
    exp = metrics["expansion"]
    assert exp["nblocks"] >= 8, exp["nblocks"]
    for k in ("fused", "unfused"):
        assert exp[k]["host_bytes_read"] > 0, (k, exp)
    assert exp["fused_over_unfused"] <= 0.6, (
        f"fused expansion reads {exp['fused_over_unfused']:.3f}x unfused "
        f"(bar: 0.6) — pass fusion regressed")
    comp = metrics["compress"]
    assert comp["fused"]["passes"] == 1, comp["fused"]
    assert comp["fused"]["reads_over_subspace"] <= 1.0 + 1e-9, (
        "fused compress must read the subspace exactly once")
    e2e = metrics["eigsh_e2e"]
    assert e2e["fused"]["converged"] and e2e["unfused"]["converged"], e2e
    assert e2e["max_rel_err"] <= 1e-5, (
        f"fused/unfused spectrum diverged: {e2e['max_rel_err']:.3e}")
    assert metrics["safs"]["eigsh_max_rel_err"] <= 1e-5, (
        f"safs fused/unfused spectrum diverged: "
        f"{metrics['safs']['eigsh_max_rel_err']:.3e}")


def run(csv_rows: list, device=None):
    """Harness entry (`python -m repro_torch.benchmarks.run subspace_io`)."""
    m = collect(smoke=True, device=device)
    exp, comp, e2e = m["expansion"], m["compress"], m["eigsh_e2e"]
    csv_rows.append((
        "subspace_io_expand", f"nb={exp['nblocks']}", m["safs"]["fused"]["us"],
        f"fused_over_unfused={exp['fused_over_unfused']:.3f}"))
    csv_rows.append((
        "subspace_io_compress", f"k={comp['k_keep']}", 0.0,
        f"fused_passes={comp['fused']['passes']},"
        f"unfused_passes={comp['unfused']['passes']}"))
    csv_rows.append((
        "subspace_io_e2e", f"n={e2e['n']}", 0.0,
        f"passes_ratio={e2e['passes_fused_over_unfused']:.3f},"
        f"max_rel_err={e2e['max_rel_err']:.1e}"))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down sizes (the reference's smoke sizes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, metavar="SUBSPACE_IO.json",
                    help="write the metrics here")
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
    exp, comp, e2e = (metrics["expansion"], metrics["compress"],
                      metrics["eigsh_e2e"])
    print(f"expansion (NB={exp['nblocks']}): "
          f"{exp['unfused']['reads_over_subspace']:.2f}x subspace unfused → "
          f"{exp['fused']['reads_over_subspace']:.2f}x fused "
          f"(ratio {exp['fused_over_unfused']:.3f})")
    print(f"compress (k_keep={comp['k_keep']}): "
          f"{comp['unfused']['passes']} passes unfused → "
          f"{comp['fused']['passes']} fused "
          f"({comp['fused']['reads_over_subspace']:.2f}x subspace)")
    print(f"eigsh e2e: {e2e['unfused']['passes']} → {e2e['fused']['passes']} "
          f"passes, subspace bytes {e2e['unfused']['pass_bytes_read']/1e6:.1f}"
          f" → {e2e['fused']['pass_bytes_read']/1e6:.1f} MB "
          f"(ratio {e2e['pass_bytes_fused_over_unfused']:.3f}), "
          f"parity {e2e['max_rel_err']:.1e}")
    print(f"safs: expansion wall-clock ratio "
          f"{metrics['safs']['wallclock_fused_over_unfused']:.2f} "
          f"(secondary), eigsh parity "
          f"{metrics['safs']['eigsh_max_rel_err']:.1e}")
    return metrics


if __name__ == "__main__":
    main()
