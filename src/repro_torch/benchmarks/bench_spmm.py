"""Paper Fig. 6/7/8 — SpMM optimization ladder + SEM-vs-IM ratio. Port of
`benchmarks/bench_spmm.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_spmm \
        --smoke [--device cpu] [--out SPMM.json]

Fig. 6 ablation: start from plain COO segment-sum SpMM and add the
paper's optimizations one by one:
    coo            — unstructured gather/segment-sum (no blocking): the
                     COO side path's `coo_spmm_ref` over every entry
    +blocking      — 2-D tile blocking: every entry in a dense 64×64
                     block (`min_block_nnz=1`), block-CSR
    +hybrid        — blocks with at least 8 entries + COO remainder
                     (SCSR+COO)
    +balance       — LPT nnz balancing of tile rows over 48 workers (the
                     work-stealing analogue), against round-robin

The +blocking and +hybrid rungs run through a `GraphOperator` with the
image resident on the device (uploaded once, as the solver keeps it), so
on the card their dense part is the `spmm_blocksparse` kernel. Each rung
is timed per call (CUDA events on the card) and held against its plain
version on the same inputs: the kernel rungs against the operator's
plain path (`impl="ref"`), the coo rung against a float64 sum, each
within 1e-5 of Σ|terms| per element (`validate`).

Fig. 7/8 SEM ratio: semi-external-memory SpMM streams the matrix image
from the slow tier; the row models the tier at the paper's measured
bandwidth (SSD array ≈ 10.9 GB/s; `FAST_TIER_BW` the effective
in-memory SpMM rate the paper's Fig. 7 implies) and reports the SEM/IM
runtime ratio per #columns, the paper's 40–60 % claim. Its compute term
is the H100's: operations at the float32 peak outside the tensor cores
plus k passes over the image at the HBM rate (NVIDIA's SXM data sheet).

Block, COO-entry and image-byte counts and the two imbalances depend only
on the graph, so they equal the reference's for the same sizes. Runs on
the CUDA card unless `--device cpu`; with `--out` the metrics are written
as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import GraphOperator
from repro_torch.device import resolve_device, synchronize
from repro_torch.graphs import pack_tiles, rmat_graph
from repro_torch.graphs.partition import (balance_tile_rows, imbalance,
                                          tile_row_costs)
from repro_torch.kernels.spmm_ref import coo_spmm_ref

# modeled tier bandwidths. SLOW = the paper's measured SSD-array stream
# rate (§4.2.2: 10.87 GB/s). FAST = *effective* in-memory SpMM bandwidth —
# power-law SpMM is DRAM-random-access-bound, not peak-DRAM-bound; the
# paper's own Fig. 7 (IM ≈ 2× SEM at k=1) implies ~22–25 GB/s effective.
SLOW_TIER_BW = 10.9e9
FAST_TIER_BW = 25e9
# the modeled compute term: H100 SXM float32 peak outside the tensor
# cores and its device-memory rate (data sheet)
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

TOL = 1e-5          # |rung − plain| ≤ TOL · Σ|terms|, per element
WORKERS = 48        # +balance: the reference's worker count


def _time_us(fn, dev, reps: int = 3) -> float:
    """Mean microseconds per call after one warm-up call: CUDA events
    around `reps` calls on the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _coo64(rows, cols, vals, x, n) -> torch.Tensor:
    """Σ vals·x[cols] into rows in float64: the exact sum the rungs are
    held to, and (over |vals|, |x|) the scale of their error."""
    out = torch.zeros((n, x.shape[1]), dtype=torch.float64, device=x.device)
    return out.index_add_(0, rows, vals[:, None].double()
                          * x.double()[cols])


def _rel_err(got, want, scale) -> float:
    diff = (got.double() - want.double()).abs()
    ok = scale > 0
    if bool((diff[~ok] > 0).any()):
        return float("inf")
    return float((diff[ok] / scale[ok]).max()) if bool(ok.any()) else 0.0


def _rung(op: GraphOperator, xp, dev) -> tuple:
    """Time one blocked rung's matmat, then run it once more beside the
    operator's plain path on the same x. Returns (µs per call, Y, the
    plain Y)."""
    us = _time_us(lambda: op.matmat(xp), dev)
    y = op.matmat(xp)
    op.impl = "ref"
    try:
        y_plain = op.matmat(xp)
    finally:
        op.impl = "auto"
    return us, y, y_plain


def _ladder(n: int, nnz: int, r, c, v, *, ks, blocking: bool,
            dev) -> dict:
    """The Fig. 6/7/8 rungs over one graph (`blocking=False` leaves out
    the all-dense image)."""
    out: dict = {"n": n, "nnz": int(nnz), "entries": int(r.size),
                 "workers": WORKERS}
    images = {}
    if blocking:
        images["blocking"] = pack_tiles(n, n, r, c, v, block_shape=(64, 64),
                                        min_block_nnz=1)
    images["hybrid"] = pack_tiles(n, n, r, c, v, block_shape=(64, 64),
                                  min_block_nnz=8)
    for tag, tm in images.items():
        out[tag] = {"nblocks": tm.nblocks, "coo": int(tm.coo_vals.size),
                    "nbytes_image": tm.nbytes_image()}
    hyb = images["hybrid"]
    costs = tile_row_costs(np.asarray(hyb.row_ptr))
    naive = np.arange(len(costs)) % WORKERS
    lpt = balance_tile_rows(costs, WORKERS, contiguous=False)
    out["balance"] = {"imb_naive": imbalance(costs, naive, WORKERS),
                      "imb_lpt": imbalance(costs, lpt, WORKERS)}

    rows = torch.from_numpy(np.asarray(r, np.int32)).to(dev)
    cols = torch.from_numpy(np.asarray(c, np.int32)).to(dev)
    vals = torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    rows64, cols64 = rows.long(), cols.long()
    xs = {k: torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, k)).astype(np.float32)).to(dev) for k in ks}
    out["k"] = {str(k): {"us": {}, "max_rel_err": {}} for k in ks}
    scale = {}
    for k, x in xs.items():
        rec = out["k"][str(k)]
        exact = _coo64(rows64, cols64, vals, x, n)
        scale[k] = _coo64(rows64, cols64, vals.abs(), x.abs(), n)
        rec["us"]["coo"] = _time_us(
            lambda: coo_spmm_ref(rows, cols, vals, x, n), dev)
        y = coo_spmm_ref(rows, cols, vals, x, n)
        rec["max_rel_err"]["coo"] = _rel_err(y, exact, scale[k])
        del exact, y
    del rows, cols, vals, rows64, cols64

    for tag, tm in images.items():
        op = GraphOperator(tm, device=dev)
        for k, x in xs.items():
            xp = torch.nn.functional.pad(x, (0, 0, 0, tm.shape[1] - n))
            us, y, y_plain = _rung(op, xp, dev)
            rec = out["k"][str(k)]
            rec["us"][tag] = us
            rec["max_rel_err"][tag] = _rel_err(y[:n], y_plain[:n], scale[k])
            del y, y_plain
        del op
        synchronize(dev)

    image_bytes = hyb.nbytes_image()
    for k in ks:
        # Fig 7/8: SEM/IM modeled ratio. IM ≙ matrix resident in fast
        # memory at the *effective* in-memory SpMM rate; SEM ≙ matrix
        # streamed from the slow tier, overlapped with the same compute.
        flops = 2.0 * nnz * k
        t_comp = flops / F32_FLOPS_PER_S + k * image_bytes / HBM_BYTES_PER_S
        t_im = max(t_comp, image_bytes / FAST_TIER_BW)
        t_sem = max(t_comp, image_bytes / SLOW_TIER_BW)
        out["k"][str(k)]["sem"] = {"t_sem_us": t_sem * 1e6,
                                   "ratio": t_im / t_sem}
    return out


def collect(*, smoke: bool = False, device=None, n: int | None = None,
            nnz: int | None = None, seed: int = 0, ks=(1, 4),
            blocking: bool = True, graph=None) -> dict:
    """The ladder over `rmat_graph(n, nnz, seed, symmetric=True)` (the
    reference's 20,000 and 300,000; 4,000 and 40,000 with `smoke`), or
    over `graph` = (r, c, v) on n vertices."""
    n = n or (4000 if smoke else 20000)
    nnz = nnz or (40000 if smoke else 300000)
    dev = resolve_device(device)
    r, c, v = graph if graph is not None else rmat_graph(
        n, nnz, seed=seed, symmetric=True)
    out = _ladder(n, nnz, r, c, v, ks=ks, blocking=blocking, dev=dev)
    out.update(schema="bench_spmm/v1", smoke=smoke, device=str(dev))
    return out


def validate(metrics: dict) -> None:
    """Every rung agrees with its plain version, and LPT balances at least
    as well as round-robin."""
    for k, rec in metrics["k"].items():
        for tag, err in rec["max_rel_err"].items():
            assert err <= TOL, (f"k={k} {tag} rung disagrees with its plain "
                                f"version: {err:.3e} of Σ|terms|")
    bal = metrics["balance"]
    assert bal["imb_lpt"] <= bal["imb_naive"] + 1e-12, bal


def run(csv_rows: list, device=None):
    """Harness entry (`python -m repro_torch.benchmarks.run spmm`): the
    reference's CSV rows at its sizes."""
    m = collect(device=device)
    for k, rec in m["k"].items():
        us = rec["us"]
        csv_rows.append(("fig6_spmm_coo", f"k={k}", us["coo"], ""))
        csv_rows.append(("fig6_spmm_blocked", f"k={k}", us["blocking"],
                         f"nblocks={m['blocking']['nblocks']}"))
        h = m["hybrid"]
        csv_rows.append(("fig6_spmm_hybrid", f"k={k}", us["hybrid"],
                         f"nblocks={h['nblocks']},coo={h['coo']},"
                         f"bytes={h['nbytes_image']}"))
        b = m["balance"]
        csv_rows.append(("fig6_spmm_balance", f"k={k}", 0.0,
                         f"imb_naive={b['imb_naive']:.3f},"
                         f"imb_lpt={b['imb_lpt']:.3f}"))
        csv_rows.append(("fig7_sem_over_im", f"k={k}", rec["sem"]["t_sem_us"],
                         f"ratio={rec['sem']['ratio']:.2f},paper=0.4-0.6,"
                         f"compute=h100_f32_peak+hbm"))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down graph (n=4000, nnz=40000)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, metavar="SPMM.json",
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
    print(f"SpMM ladder (n={metrics['n']}, {metrics['entries']} entries): "
          f"+blocking {metrics['blocking']['nblocks']} blocks, +hybrid "
          f"{metrics['hybrid']['nblocks']} blocks + "
          f"{metrics['hybrid']['coo']} COO entries "
          f"({metrics['hybrid']['nbytes_image']:,d} B), imbalance "
          f"{metrics['balance']['imb_naive']:.3f} round-robin → "
          f"{metrics['balance']['imb_lpt']:.3f} LPT")
    for k, rec in metrics["k"].items():
        us = rec["us"]
        print(f"  k={k}: coo {us['coo']:.1f} us, +blocking "
              f"{us['blocking']:.1f} us, +hybrid {us['hybrid']:.1f} us | "
              f"SEM/IM {rec['sem']['ratio']:.2f} (paper 0.4-0.6) | max rel "
              f"err {max(rec['max_rel_err'].values()):.1e}")
    return metrics


if __name__ == "__main__":
    main()
