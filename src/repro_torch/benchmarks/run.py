"""Benchmark harness — one module per paper table/figure. Port of
`benchmarks/run.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu] \
        [spmm tasops eigen safs subspace_io]

Prints ``name,case,us_per_call,derived`` CSV, the reference's columns.
`roofline` (ROADMAP.md queue 1 item 8) and `dist_e2e` (item 5) are not
ported yet, and naming one raises. Runs on the CUDA card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import importlib

MODULES = ("spmm", "tasops", "eigen", "safs", "subspace_io")
NOT_PORTED = {"roofline": "ROADMAP.md queue 1 item 8",
              "dist_e2e": "ROADMAP.md queue 1 item 5"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("benches", nargs="*", metavar="BENCH",
                    help=f"any of {', '.join(MODULES)} (default: all)")
    args = ap.parse_args(argv)
    for name in args.benches:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"bench {name!r} is not ported yet: {NOT_PORTED[name]}")
        if name not in MODULES:
            ap.error(f"unknown bench {name!r}")
    rows: list = []
    for name in args.benches or MODULES:
        mod = importlib.import_module(f"repro_torch.benchmarks.bench_{name}")
        mod.run(rows, device=args.device)
    print("name,case,us_per_call,derived")
    for name, case, us, derived in rows:
        print(f"{name},{case},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
