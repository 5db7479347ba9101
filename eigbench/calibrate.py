#!/usr/bin/env python3
"""Read the numbers that decide `correct`, for setting their limits.

    python3 eigbench/calibrate.py --workloads kron21-ks.nev8,kron21-ks.nb32 \
        --seeds 11,12,13 --control-seeds 11,12 --seconds 51 \
        [--control program,reference] [--control-solves 4] [--out FILE]

on the card, from the root of a checkout. The cells must share one
configuration: for each seed the graph is drawn and the program set up
once (the configuration's fixed graph), then for each seed each cell's
window runs as in a benchmark run and every answer is judged against the
plain reference (the lower readings). On the control seeds the control
runs in the program's place at the cell's size (the upper readings):
with `--control program`, the program over its bf16 image
(`GraphOperator.astype`), the control where the image's values are not
exact in bf16 (`kron21-ks`); with `--control reference` (the default),
the plain reference's own solver with every vector rounded to bfloat16,
from the window's start blocks (the control of `kron21-svd`, whose 0/1
entries bf16 holds exactly, and the upper reading of `orthogonality`,
which the bf16 image leaves alone). One JSON line per (cell, seed,
side), with each number's worst value over the answers, goes to
standard output and to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_answers(control: str, system, graph, cell, seed: int,
                    count: int, dev) -> list:
    """`count` answers of the control in the program's place."""
    import torch
    from eigbench.gen import kronecker
    from eigbench.harness import cell as runner
    from eigbench.harness.system import Answer
    from eigbench.reference import eigen as ref
    answers = []
    if control == "program":
        while len(answers) < count:
            more, _, _ = runner.run_window(system, cell, seed + len(answers),
                                           0.0, dev)
            answers += more
        return answers
    kind = system.config["kind"]
    op = ref.PlainOperator(graph.n, graph.rows, graph.cols, graph.vals, dev,
                           t=kind == "svd")
    for i in range(count):
        x0 = kronecker.window_block(graph.n, int(cell.traffic["block_size"]),
                                    seed, i, int(cell.traffic["start_pool"]),
                                    dev)
        vals, vecs = ref.control_answer(op, int(cell.traffic["nev"]), kind,
                                        x0)
        answers.append(Answer(i, 0.0, vals, vecs.float().cpu(), True, 0, 0))
    del op
    torch.cuda.empty_cache()
    return answers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workloads", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-solves", type=int, default=4)
    p.add_argument("--control", default="reference",
                   help="'program', 'reference' or both, comma-separated")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from eigbench.harness import cell as runner
    from eigbench.harness.manifest import load_cell
    from eigbench.harness.system import System
    if not torch.cuda.is_available():
        runner.log("no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    cells = [load_cell(w) for w in args.workloads.split(",")]
    config = cells[0].config
    if any(c.config != config for c in cells):
        raise SystemExit("the cells must share one configuration")
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    runner.log(runner.card_line())

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    t0 = time.perf_counter()
    graph = runner.make_graph(config, dev)
    system = System(config, cells[0].traffic, graph, dev)
    runner.log(f"set up in {time.perf_counter() - t0:.1f} s")
    # every program side runs first and is judged once the program is
    # freed, as in a benchmark run: the card holds no image and the
    # reference at once
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for cell in cells:
            system.traffic = cell.traffic
            answers, window, _ = runner.run_window(system, cell, seed,
                                                   args.seconds, dev)
            runs.append((cell, seed, "program", answers, {
                "window_s": window, "walls": [a.wall for a in answers],
                "n_ops": [a.n_ops for a in answers]}))
    controls = args.control.split(",")
    if "program" in controls:
        for tag in list(system.ops):       # no name keeps the float32 image
            system.ops[tag] = system.ops[tag].astype(torch.bfloat16)
        torch.cuda.empty_cache()
        for seed in sorted(control_seeds):
            for cell in cells:
                system.traffic = cell.traffic
                runs.append((cell, seed, "control: program", control_answers(
                    "program", system, graph, cell, seed,
                    args.control_solves, dev), {}))
    system.close()
    for cell, seed, side, answers, extra in runs:
        checks, failed, _ = runner.judge(cell, graph, answers, dev, seed)
        emit({"cell": cell.name, "seed": seed, "side": side,
              "answers": len(answers), "failed": len(failed),
              "unconverged": sum(not a.converged for a in answers),
              **extra, "numbers": {k: v["value"] for k, v in checks.items()}})
    if "reference" in controls:
        for seed in sorted(control_seeds):
            for cell in cells:
                answers = control_answers("reference", system, graph, cell,
                                          seed, args.control_solves, dev)
                checks, failed, _ = runner.judge(cell, graph, answers, dev,
                                                 seed)
                emit({"cell": cell.name, "seed": seed,
                      "side": "control: reference",
                      "answers": len(answers), "failed": len(failed),
                      "numbers": {k: v["value"] for k, v in checks.items()}})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
