#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 eigbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `src/repro_torch`. Prints
progress and, last, each compared number beside its limit on standard
error, and one JSON object as the last line of standard output. Exits
non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), without the program, or when the process holds JAX or
the JAX package (`repro`) once the window has closed.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """perf_counter's reading at this process's start (from /proc), or
    now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    from eigbench.harness import cell as runner
    from eigbench.harness.manifest import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        runner.log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        runner.log(f"the cell asks for {cell.chips} cards, "
                   f"{torch.cuda.device_count()} found")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        runner.log(f"the program (src/repro_torch) is not here: {e}")
        return 2
    runner.log(f"cell {cell.name} | seed {args.seed} | {args.seconds:g} s | "
               f"trace {args.trace} | {runner.card_line()}")
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    found = runner.banned_modules()
    if found:
        runner.log(f"the process holds {found}: the benchmark may load "
                   f"neither JAX nor the JAX package")
        return 3
    for name, c in out["checks"].items():
        runner.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
