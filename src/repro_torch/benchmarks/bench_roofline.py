"""Roofline rows of the port's dry run (port of `benchmarks/bench_roofline`):
reads the JSONL that `repro_torch.launch.dryrun` writes and emits one row
per (arch × shape × mesh) with the three roofline terms, from H100 SXM
data-sheet constants. Never the reference's TPU-mesh records
(`results/dryrun.jsonl`)."""
from __future__ import annotations

import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULTS = os.path.join(ROOT, DEFAULT_OUT)


def run(csv_rows: list, device=None, path: str = RESULTS):
    """`device` is not read: the rows come from recorded traces."""
    del device
    if not os.path.exists(path):
        csv_rows.append(("roofline", "missing", 0.0,
                         "run: python -m repro_torch.launch.dryrun --all "
                         "--both-meshes"))
        return csv_rows
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if "error" in r:
                csv_rows.append((f"roofline_{r['mesh']}",
                                 f"{r['arch']}/{r['shape']}", 0.0,
                                 f"ERROR={r['error'][:60]}"))
                continue
            csv_rows.append((
                f"roofline_{r['mesh']}", f"{r['arch']}/{r['shape']}",
                r["step_time_bound_s"] * 1e6,
                f"compute_s={r['compute_s']:.3e},"
                f"memory_s={r['memory_s']:.3e},"
                f"collective_s={r['collective_s']:.3e},"
                f"dominant={r['dominant']},"
                f"roofline_frac={r['roofline_fraction']:.4f},"
                f"useful_ratio={r['useful_ratio']:.3f}"))
    return csv_rows
