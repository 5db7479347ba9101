"""End-to-end sharded eigensolve benchmark — the dist/core integration.
Port of `benchmarks/bench_dist_e2e.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_dist_e2e
        [--smoke] [--ranks 8] [--backend gloo|nccl] [--device cpu]
        [--out PATH]

Tracks the paper's headline pipeline: `core.eigsh` restarts driving the
fused SpMM+CGS2/CholQR2 step (`dist.DistOperator`) over the ranks of a
(pod, data, model) mesh (`examples.dist_eigen_e2e.run_ranks`, the same
program as the e2e example). Three ladders, as in the reference:

  parity          nev eigenpairs of the same R-MAT graph through the local
                  GraphOperator path and the sharded fused path, from one
                  natural-space start block; both spectra, the max
                  relative deviation, and the rtol-1e-5 verdict.
  timings         wall seconds of both solves (host clock around
                  synchronized work) + the fused-expansion count. Ranks
                  that share one card or one host pay real collective
                  overhead for no parallelism: a regression canary, not a
                  speedup claim.
  pod_compressed  the int8 cross-pod reduction variant for a fixed
                  restart budget, its per-restart |λ| deviation.

Beside them, per rank: the collective bytes of the dist solve by kind
against the analytic count, host-staged bytes (gloo on the card) and,
on the card, peak device memory. `validate` fails (non-zero exit) when
the contract fields are missing or parity breaks. Runs on the CUDA card
unless `--device cpu`; `--ranks 1` runs in this process on a (1, 1, 1)
mesh, as the harness (`run`) does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REQUIRED_FIELDS = (
    ("parity", "max_rel_err"),
    ("parity", "rtol_1e5_ok"),
    ("eigenvalues", "local"),
    ("eigenvalues", "dist"),
    ("pod_compressed", "per_restart_abs_dev"),
    ("pod_compressed", "final_abs_dev"),
    ("timings", "local_s"),
    ("timings", "dist_s"),
)


def validate(metrics: dict) -> None:
    """Raise if the JSON is missing the parity/eigenvalue contract."""
    for sect, key in REQUIRED_FIELDS:
        if sect not in metrics or key not in metrics[sect]:
            raise ValueError(f"BENCH_dist_e2e missing field {sect}.{key}")
    if not metrics["parity"]["rtol_1e5_ok"]:
        raise ValueError(
            f"dist-vs-local spectrum parity failed: max_rel_err="
            f"{metrics['parity']['max_rel_err']:.3e} (bar: rtol 1e-5)")
    if metrics["smoke"] and not (metrics["parity"]["local_converged"]
                                 and metrics["parity"]["dist_converged"]):
        # parity alone cannot tell "both converged to the same spectrum"
        # from "both diverge identically"; the smoke sizes converge at tol
        # 1e-7, so the smoke run demands it
        raise ValueError("smoke-sized solves must converge: "
                         f"local={metrics['parity']['local_converged']} "
                         f"dist={metrics['parity']['dist_converged']}")


def collect(*, smoke: bool = False, device=None, ranks: int = 1,
            backend: str = "gloo") -> dict:
    from repro_torch.device import resolve_device
    from repro_torch.examples.dist_eigen_e2e import world

    dev = resolve_device(device)
    n, nnz, nev, bs = (1500, 15000, 4, 2) if smoke else (6000, 72000, 8, 4)
    cfg = dict(graph=("rmat_spectral", n, nnz, 1), nev=nev, block_size=bs,
               tol=1e-7, max_restarts=100, x0_seed=0, local=True,
               pod_restarts=3 if smoke else 6)
    outs = world(cfg, ranks=ranks, backend=backend, device=str(dev))
    head = outs[0]
    local, dist = head["local"], head["dist"]
    w_local = np.sort(local["eigenvalues"])
    w_dist = np.sort(dist["eigenvalues"])
    # per-element relative error: the bar assert_allclose(rtol=1e-5)
    # applies in the example and tests
    rel = float(np.max(np.abs(w_dist - w_local)
                       / np.maximum(np.abs(w_local), 1e-30)))
    devs = head["pod_compressed"]
    name = None
    if dev.type == "cuda":
        import torch
        name = torch.cuda.get_device_name(dev)
    return {
        "schema": "bench_dist_e2e/v1", "smoke": smoke,
        "graph": {"n": n, "nnz": nnz, "nev": nev, "block_size": bs,
                  "seed": 1},
        "device": {"type": dev.type, "name": name}, "ranks": ranks,
        "mesh": head["mesh"],
        "eigenvalues": {"local": [float(x) for x in w_local],
                        "dist": [float(x) for x in w_dist]},
        "parity": {"max_rel_err": rel, "rtol_1e5_ok": bool(rel <= 1e-5),
                   "local_converged": local["converged"],
                   "dist_converged": dist["converged"]},
        "timings": {"local_s": local["wall_s"], "dist_s": dist["wall_s"],
                    "fused_expansions": head["fused_steps"],
                    "local_restarts": local["restarts"],
                    "dist_restarts": dist["restarts"]},
        "pod_compressed": {
            "per_restart_abs_dev": devs,
            "final_abs_dev": devs[-1] if devs else None,
            "restarts_measured": len(devs),
            # the deviation must settle, not grow, over full restart
            # cycles (last <= 2x the best seen after restart 0)
            "accumulates": bool(len(devs) >= 2
                                and devs[-1] > 2.0 * min(devs[1:]) + 1e-12),
        },
        "per_rank": [{"rank": o["rank"], "bytes": o["bytes"],
                      "analytic_bytes": o["analytic_bytes"],
                      "peak_device_bytes": o.get("peak_device_bytes"),
                      "panel": o["panel"]} for o in outs],
    }


def run(csv_rows: list, device=None):
    """Harness entry (`benchmarks/run.py dist_e2e`): CSV rows off the
    smoke collect(), in this process on a (1, 1, 1) mesh (the full fused
    path, as the reference's one-device harness run)."""
    m = collect(smoke=True, device=device)
    validate(m)
    csv_rows.append(("dist_e2e", f"n={m['graph']['n']},local",
                     m["timings"]["local_s"] * 1e6,
                     f"restarts={m['timings']['local_restarts']}"))
    csv_rows.append(("dist_e2e", f"n={m['graph']['n']},dist",
                     m["timings"]["dist_s"] * 1e6,
                     f"max_rel_err={m['parity']['max_rel_err']:.2e}"))
    csv_rows.append(("dist_e2e", "pod_compressed", 0.0,
                     f"final_abs_dev="
                     f"{m['pod_compressed']['final_abs_dev']:.2e}"))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down sizes (n=1500)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="processes of the (pod, data, model) mesh")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="write the metrics as JSON")
    args = ap.parse_args(argv)
    metrics = collect(smoke=args.smoke, device=args.device,
                      ranks=args.ranks, backend=args.backend)
    validate(metrics)
    if args.out:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        print(f"wrote {args.out}")
    p = metrics["parity"]
    print(f"{metrics['mesh']}")
    print(f"parity: max_rel_err={p['max_rel_err']:.3e} "
          f"(rtol 1e-5 ok: {p['rtol_1e5_ok']})")
    pc = metrics["pod_compressed"]
    print(f"pod_compressed |λ| deviation per restart: "
          f"{['%.2e' % x for x in pc['per_restart_abs_dev']]} "
          f"(accumulates: {pc['accumulates']})")
    t = metrics["timings"]
    print(f"local {t['local_s']:.3f}s vs dist {t['dist_s']:.3f}s "
          f"({t['fused_expansions']} fused expansions)")
    for r in metrics["per_rank"]:
        print(f"rank {r['rank']}: bytes {r['bytes']} analytic "
              f"{r['analytic_bytes']} peak device {r['peak_device_bytes']}")
    if pc["accumulates"]:
        print("WARNING: pod-compressed deviation grew over restart cycles",
              file=sys.stderr)
        sys.exit(1)
    return metrics


if __name__ == "__main__":
    main()
