"""Render the dry-run and roofline tables from the port's dry-run JSONL
(port of `repro.launch.roofline`).

  PYTHONPATH=src python -m repro_torch.launch.roofline \
      [--jsonl results/dryrun_torch.jsonl]

Emits GitHub-markdown tables. The records are those of
`repro_torch.launch.dryrun` (a meta-device trace priced with H100 SXM
data-sheet constants), never the reference's TPU-mesh records in
`results/dryrun.jsonl`; the dry-run table shows each cell's `trace_s`
where the reference's shows its compile seconds.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

DEFAULT_JSONL = "results/dryrun_torch.jsonl"


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.1f}ms"
    return f"{s*1e6:.1f}us"


def load(path: str):
    recs = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if "error" not in r:
                r.setdefault("variant", "baseline")
                recs.append(r)
    return recs


def roofline_table(recs, mesh="16x16", variant="baseline"):
    rows = [r for r in recs if r["mesh"] == mesh
            and r["variant"] == variant]
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS | useful | roofline% | bytes/dev |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant'].replace('_s','')} | "
            f"{r['model_flops']:.2e} | {r['useful_ratio']:.2f} | "
            f"{100*r['roofline_fraction']:.2f} | "
            f"{fmt_bytes(r['per_device_bytes_resident'])} |")
    return "\n".join(out)


def variant_compare(recs):
    """Baseline-vs-variant rows for every cell that has both."""
    by_cell = defaultdict(dict)
    for r in recs:
        by_cell[(r["arch"], r["shape"], r["mesh"])][r["variant"]] = r
    out = ["| arch | shape | mesh | variant | bound before | bound after | "
           "speedup | dominant after |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), d in sorted(by_cell.items()):
        if "baseline" not in d or len(d) < 2:
            continue
        base = d["baseline"]
        for vname, r in sorted(d.items()):
            if vname == "baseline":
                continue
            sp = base["step_time_bound_s"] / max(r["step_time_bound_s"],
                                                 1e-30)
            out.append(
                f"| {arch} | {shape} | {mesh} | {vname} | "
                f"{fmt_s(base['step_time_bound_s'])} | "
                f"{fmt_s(r['step_time_bound_s'])} | {sp:.2f}x | "
                f"{r['dominant'].replace('_s','')} |")
    return "\n".join(out)


def dryrun_table(recs, variant="baseline"):
    out = ["| arch | shape | mesh | trace s | bytes/dev | collectives/dev "
           "(AG/AR/RS/A2A/CP) |",
           "|---|---|---|---|---|---|"]
    for r in sorted((r for r in recs if r["variant"] == variant),
                    key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        c = r["collective_per_device"]
        cs = "/".join(fmt_bytes(c.get(k, 0)) for k in
                      ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all", "collective-permute"))
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                   f"{r['trace_s']:.1f} | "
                   f"{fmt_bytes(r['per_device_bytes_resident'])} | {cs} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default=DEFAULT_JSONL)
    ap.add_argument("--section", default="all",
                    choices=("all", "roofline", "dryrun", "perf"))
    args = ap.parse_args(argv)
    recs = load(args.jsonl)
    if args.section in ("all", "dryrun"):
        print("### Dry-run (both meshes, baseline)\n")
        print(dryrun_table(recs))
        print()
    if args.section in ("all", "roofline"):
        print("### Roofline — single pod 16x16 (baseline)\n")
        print(roofline_table(recs, "16x16"))
        print()
        print("### Roofline — multi-pod 2x16x16 (baseline)\n")
        print(roofline_table(recs, "2x16x16"))
        print()
    if args.section in ("all", "perf"):
        print("### Perf — baseline vs optimized variants\n")
        print(variant_compare(recs))


if __name__ == "__main__":
    main()
