"""Paper Fig. 9/10/11 — out-of-core dense-matrix (TAS) operations. Port of
`benchmarks/bench_tasops.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_tasops \
        --smoke [--device cpu] [--out TASOPS.json]

Fig. 9 I/O ladder:
    naive          — every block demoted+promoted per op (no cache, no pool)
    +recent-cache  — newest block pinned in the device tier (§3.4.4)
    +lazy-scale    — MvScale folded into consumers (zero-I/O scaling)
    +grouping      — Fig. 5 group decomposition (bounded fast-tier memory)

Fig. 10/11: MvTransMv runtime by group size, plus modeled tier bandwidth
saturation of MvTimesMatAddMv (the paper reaches 10.87 GB/s of 12 GB/s).

`io_bytes` counts bytes moved through the slow tier, not time: for the
same sizes it equals the reference's to the byte, and it is a whole
number of n·b·4-byte blocks at any n (naive m/b, +recent-cache m/b − 1,
+lazy-scale 0). The subspace is a `MultiVector(impl="auto")`, so on the
card MvTimesMatAddMv and MvTransMv run the tsgemm and gram kernels; the
times are host-clock microseconds around synchronized work. Runs on the
CUDA card unless `--device cpu`; with `--out` the metrics are written as
JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import MultiVector, TieredStore
from repro_torch.device import resolve_device, synchronize

SLOW_TIER_BW = 10.9e9


def _mk(store, n, m, b, group_size=8):
    """An m-column subspace of b-column blocks appended one by one (each
    append pins the newest block and demotes its predecessor), drawn on
    the store's device (MvRandom): the ladder counts bytes and times
    operations, neither of which depends on the values."""
    mv = MultiVector(store, n, group_size=group_size)
    gen = torch.Generator(device=store.device).manual_seed(0)
    mv.mv_random(gen, [b] * (m // b))
    return mv


def _timed_us(dev, fn):
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return (time.perf_counter() - t0) * 1e6, out


def _io(store) -> int:
    return store.stats.host_bytes_read + store.stats.host_bytes_written


def _ladder(n: int, b: int, m: int, dev) -> dict:
    out: dict = {}
    small = np.random.default_rng(1).standard_normal((m, b)).astype(
        np.float32)

    # naive: no pinned cache — demote every block after each touch
    store = TieredStore(device_budget_bytes=n * 4 * b, device=dev)
    mv = _mk(store, n, m, b)
    for i in range(mv.nblocks):
        store.unpin(mv._block_name(i))
        store.demote(mv._block_name(i))
    store.reset_stats()
    us, _ = _timed_us(dev, lambda: mv.mv_times_mat(store.as_tensor(small)))
    out["naive"] = {"us": us, "io_bytes": _io(store)}
    store.close()

    # +recent-cache (default policy) — newest block stays on device
    store2 = TieredStore(device_budget_bytes=2 * n * 4 * b, device=dev)
    mv2 = _mk(store2, n, m, b)
    store2.reset_stats()
    us, _ = _timed_us(dev, lambda: mv2.mv_times_mat(store2.as_tensor(small)))
    out["cache"] = {"us": us, "io_bytes": _io(store2)}

    # +lazy scale: MvScale costs zero I/O
    store2.reset_stats()
    mv2.mv_scale(0.5)
    out["lazy_scale"] = {"io_bytes": _io(store2)}
    store2.close()

    # +grouping: fast-tier peak during MvTransMv bounded by group size
    out["mv_trans_mv_us"] = {}
    for gs in (2, 8):
        store3 = TieredStore(device=dev)
        mv3 = _mk(store3, n, m, b, group_size=gs)
        other = store3.as_tensor(np.random.default_rng(2).standard_normal(
            (n, b)).astype(np.float32))
        us, _ = _timed_us(dev, lambda: mv3.mv_trans_mv(other))
        out["mv_trans_mv_us"][f"g{gs}"] = us
        store3.close()

    # Fig 11: modeled tier throughput for op1 streaming the subspace
    bytes_streamed = n * m * 4
    t_io_bound = bytes_streamed / SLOW_TIER_BW * 1e6
    out["tier"] = {"io_bound_us": t_io_bound,
                   "io_over_compute": min(1.0, t_io_bound
                                          / max(out["cache"]["us"], 1e-9))}
    return out


def collect(*, smoke: bool = False, device=None, n: int | None = None,
            b: int = 4, ms=(16, 64, 256)) -> dict:
    """The ladder at each subspace width m; n defaults to the reference's
    60,000 (paper §4.2's 60M scaled 1000×), 6,000 with `smoke`."""
    n = n or (6000 if smoke else 60000)
    dev = resolve_device(device)
    out: dict = {"schema": "bench_tasops/v1", "smoke": smoke,
                 "device": str(dev), "n": n, "b": b, "m": {}}
    for m in ms:
        out["m"][str(m)] = _ladder(n, b, m, dev)
    return out


def validate(metrics: dict) -> None:
    """The I/O ladder's byte identities: naive streams all m/b blocks,
    +recent-cache all but the pinned newest, +lazy-scale nothing."""
    blk = metrics["n"] * metrics["b"] * 4
    for m, r in metrics["m"].items():
        nblk = int(m) // metrics["b"]
        assert r["naive"]["io_bytes"] == nblk * blk, (m, r["naive"])
        assert r["cache"]["io_bytes"] == (nblk - 1) * blk, (m, r["cache"])
        assert r["lazy_scale"]["io_bytes"] == 0, (m, r["lazy_scale"])


def run(csv_rows: list, device=None):
    """Harness entry (`python -m repro_torch.benchmarks.run tasops`): the
    reference's CSV rows at its sizes."""
    metrics = collect(device=device)
    for m, r in metrics["m"].items():
        csv_rows.append(("fig9_tas_naive", f"m={m}", r["naive"]["us"],
                         f"io_bytes={r['naive']['io_bytes']}"))
        csv_rows.append(("fig9_tas_cache", f"m={m}", r["cache"]["us"],
                         f"io_bytes={r['cache']['io_bytes']}"))
        csv_rows.append(("fig9_tas_lazy_scale", f"m={m}", 0.0,
                         f"io_bytes={r['lazy_scale']['io_bytes']}"))
        for g, us in r["mv_trans_mv_us"].items():
            csv_rows.append(("fig10_mv_trans_mv", f"m={m},g={g[1:]}", us,
                             ""))
        csv_rows.append(("fig11_tier_saturation", f"m={m}",
                         r["tier"]["io_bound_us"],
                         f"io_over_compute="
                         f"{r['tier']['io_over_compute']:.2f}"))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down size (n=6000)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, metavar="TASOPS.json",
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
    print(f"TAS ladder (n={metrics['n']}, b={metrics['b']}):")
    for m, r in metrics["m"].items():
        print(f"  m={m:>4s} naive {r['naive']['io_bytes']:>12,d} B "
              f"{r['naive']['us']:10.1f} us | +recent-cache "
              f"{r['cache']['io_bytes']:>12,d} B {r['cache']['us']:10.1f} us"
              f" | +lazy-scale {r['lazy_scale']['io_bytes']} B | "
              f"mv_trans_mv g2 {r['mv_trans_mv_us']['g2']:.1f} us, g8 "
              f"{r['mv_trans_mv_us']['g8']:.1f} us")
    return metrics


if __name__ == "__main__":
    main()
