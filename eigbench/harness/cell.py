"""One run of one cell: set-up, the timed window, the check, the result.

Set-up (counted in `setup_s`, from the process's start): the
configuration's fixed graph drawn on the device and brought to the host,
the card's peak memory reset, the program's image packed and uploaded,
and one warm-up solve from a start block no timed solve uses. The
window: solves back to back from one client, each from the next start
block of the pool in the seed's order (`kronecker.window_block`), timed
by the host clock between two synchronizations, until the first solve
that ends after `seconds`. After the window: the peak is read,
the program freed, and every answer is judged against the plain
reference (`reference.eigen`) on the same COO arrays.

With `trace`, the operators are seen through CUDA events for the whole
window, and the profiler records the first `trace_solves` solves (again,
up to three times, while its records come back short); the per-layer
readers take what they need from `LayerData`.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time

import numpy as np
import torch

from eigbench.gen import kronecker
from eigbench.harness import profile as tprof
from eigbench.harness.manifest import Cell, load_metric
from eigbench.harness.system import System
from eigbench.reference import eigen as ref

BANNED = ("jax", "jaxlib", "flax", "repro")
REF_STREAM = 1 << 40            # the reference's own start draw
TRACE_WINDOWS = 3
# read at the start and after the window, beside the run's times
CARD_STATE = "clocks.sm,clocks.mem,temperature.gpu,power.draw,pstate"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line(query: str = "name,power.limit") -> str:
    """The card's fields `query` (by default its name and power limit) as
    nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi: none"


def banned_modules(modules=None) -> list:
    """Top-level names among `modules` (default: sys.modules) that a run
    may not hold, compared whole (`repro_torch` is not `repro`)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counters() -> dict:
    from repro_torch.kernels import gram, spmm_tile, tsgemm
    return {"spmm": spmm_tile.LAUNCHES, "gram": gram.LAUNCHES,
            "tsgemm": tsgemm.LAUNCHES,
            "spmm_by_k": dict(spmm_tile.LAUNCHES_BY_K),
            "gram_by_shape": dict(gram.LAUNCHES_BY_SHAPE),
            "tsgemm_by_shape": dict(tsgemm.LAUNCHES_BY_SHAPE)}


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for key, val in after.items():
        if isinstance(val, dict):
            out[key] = {k: v - before[key].get(k, 0) for k, v in val.items()
                        if v - before[key].get(k, 0)}
        else:
            out[key] = val - before[key]
    return out


KERNELS = {"spmm": r"spmm_blocksparse_kernel$",
           "gram": r"(^|:)gram_(vec_|tile_)?kernel$",
           "tsgemm": r"(^|:)tsgemm_(vec_|pair2_)?kernel$"}


@dataclasses.dataclass
class LayerData:
    """What the per-layer readers read."""
    n: int
    answers: list
    images: dict                 # tag -> ImageShape
    matmat: list                 # (tag, solve index, k, ms)
    trace: object = None         # profile.Trace of the accepted window
    launches: dict = None        # counter deltas over that window
    profiled: tuple = ()         # solve indices of that window
    records_ok: bool = False


class _Profiler:
    """Profiles `per_window` solves at a time from the window's start,
    and again while the records come back short."""

    def __init__(self, per_window: int):
        self.per_window = per_window
        self.windows = 0
        self.prof = None
        self.done = False
        self.result = None

    def before(self, index: int) -> None:
        if self.done or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        self.windows += 1
        self.first = index
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.counters = _launch_counters()
        self.mark = torch.profiler.record_function(tprof.WINDOW_MARK)
        self.mark.__enter__()

    def after(self, index: int, device, last: bool = False) -> None:
        """After solve `index`: close the profiled window once it holds
        `per_window` solves, or at the window's `last` solve."""
        if self.prof is None or (index - self.first + 1 < self.per_window
                                 and not last):
            return
        _sync(device)
        self.mark.__exit__(None, None, None)
        _sync(device)
        self.prof.stop()
        launches = _delta(_launch_counters(), self.counters)
        trace = tprof.read_trace(self.prof)
        self.prof = None
        counted = {k: trace.count(rx) for k, rx in KERNELS.items()}
        ok = all(counted[k] == launches[k] for k in KERNELS)
        if not ok:
            log(f"trace: profile window {self.windows} recorded kernels "
                f"{counted}, the wrappers launched "
                f"{ {k: launches[k] for k in KERNELS} }")
        self.result = (trace, launches, tuple(range(self.first, index + 1)),
                       ok)
        self.done = ok or self.windows >= TRACE_WINDOWS


def _nearest_rank(values: list, q: float) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def run_window(system: System, cell: Cell, seed: int, seconds: float,
               device, profiler: _Profiler | None = None):
    """The timed window: (answers, window seconds, host time of the first
    solve's start)."""
    t, n = cell.traffic, system.n
    width = int(t["block_size"])

    def wall_clock(fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        return out, time.perf_counter() - t0

    answers = []
    start = None
    index = 0
    while True:
        x0 = kronecker.window_block(n, width, seed, index,
                                    int(t["start_pool"]), device)
        _sync(device)
        if start is None:
            start = time.perf_counter()
        if profiler is not None:
            profiler.before(index)
        with torch.profiler.record_function("eigbench.solve"):
            answers.append(system.solve(x0, index, wall_clock))
        del x0
        index += 1
        last = time.perf_counter() - start >= seconds
        if profiler is not None:
            profiler.after(index - 1, device, last)
        if last:
            break
    return answers, time.perf_counter() - start, start


def judge(cell: Cell, graph, answers: list, device, seed: int) -> tuple:
    """Every answer against the plain reference: (checks, indices of the
    answers that failed, correct). `checks` holds each number compared,
    the worst over the answers, with its limit."""
    kind = cell.config["kind"]
    nev = int(cell.traffic["nev"])
    op = ref.PlainOperator(graph.n, graph.rows, graph.cols, graph.vals,
                           device, t=kind == "svd")
    want, ref_res, cycles = ref.reference_values(
        op, nev, kind, device, seed=kronecker.derive_seed(seed, REF_STREAM))
    log(f"reference: values {np.array2string(np.asarray(want), precision=9)}"
        f" | residual {ref_res:.3g} after {cycles} cycles")
    worst = {"value_gap": 0.0, "residual": 0.0, "orthogonality": 0.0}
    failed = set()
    for a in answers:
        if kind == "eig":
            got = ref.judge_eig(op, a.values, a.vectors, want,
                                cell.config["solver"]["which"])
        else:
            got = ref.judge_svd(op, a.values, a.vectors, want)
        bad = not a.converged or not all(
            np.isfinite(v) and v <= cell.limits[k] for k, v in got.items())
        if bad:
            failed.add(a.index)
        for k, v in got.items():
            worst[k] = max(worst[k], v) if np.isfinite(v) else float("inf")
    del op
    checks = {k: {"value": worst[k], "limit": cell.limits[k]}
              for k in worst}
    checks["unconverged"] = {"value": sum(not a.converged for a in answers),
                             "limit": 0}
    checks["reference_residual"] = {"value": ref_res,
                                    "limit": cell.limits["reference_residual"]}
    correct = (not failed and len(answers) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return checks, failed, correct


def end_to_end(cell: Cell, answers: list, window: float, setup_s: float,
               peak: int, failed_idx: set) -> dict:
    good = [a for a in answers if a.index not in failed_idx]
    walls = [a.wall if a.index not in failed_idx else math.inf
             for a in answers]
    p90 = _nearest_rank(walls, 0.9) if walls else math.inf
    values = {"setup_s": (setup_s, "s"),
              "solve_s": (window / len(good) if good else window, "s"),
              "solve_p90_s": (p90 if math.isfinite(p90) else window, "s"),
              "peak_device_GB": (peak / 1e9, "GB")}
    return {k: {"value": values[k][0], "unit": values[k][1]}
            for k in cell.end_to_end}


def make_graph(config: dict, device):
    """The configuration's graph: one fixed draw (`graph_seed`)."""
    return kronecker.make_graph(config["graph"] | {
        "scale": config["scale"], "edge_factor": config["edge_factor"]},
        int(config["graph_seed"]), device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run; returns the result object (the last line's keys)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        log(f"card at the start: {card_line(CARD_STATE)}")
        from repro_torch.kernels import _build
        _build.lib()                       # builds once per checkout
    graph = make_graph(cell.config, device)
    log(f"graph: n {graph.n}, {graph.nnz} entries "
        f"({time.perf_counter() - t_start:.2f} s from start)")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    system = System(cell.config, cell.traffic, graph, device)
    for tag, img in system.images.items():
        log(f"image {tag}: {img.nblocks} blocks "
            f"({img.block_bytes() / 1e9:.3f} GB), {img.coo_entries} COO "
            f"entries ({time.perf_counter() - t_start:.2f} s from start)")
    if trace:
        system.time_matmats()
    x0 = kronecker.start_block(graph.n, int(cell.traffic["block_size"]),
                               seed, kronecker.WARMUP_STREAM, device)
    t_warm = time.perf_counter()
    warm = system.solve(x0, -1, lambda fn: (fn(), 0.0))
    _sync(device)
    t_warm = time.perf_counter() - t_warm
    log(f"warm-up solve {t_warm:.3f} s, {warm.n_ops} operator applications "
        f"({time.perf_counter() - t_start:.2f} s from start)")
    del x0, warm
    profiler = _Profiler(int(cell.traffic["trace_solves"])) if trace else None
    answers, window, first = run_window(system, cell, seed, seconds, device,
                                        profiler)
    setup_s = first - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        log(f"card after the window: {card_line(CARD_STATE)}")
    walls = [a.wall for a in answers]
    log(f"window: {len(answers)} solves in {window:.3f} s | solve wall "
        f"median {np.median(walls):.4f} s, min {min(walls):.4f}, max "
        f"{max(walls):.4f} | matmats {[a.n_ops for a in answers][:12]}... "
        f"| unconverged {sum(not a.converged for a in answers)} | answers' "
        f"copies to the host {sum(a.copy_s for a in answers):.4f} s | setup "
        f"{setup_s:.2f} s | peak {peak / 1e9:.3f} GB")
    layer = None
    if trace:
        matmat = []
        for tag, t in system.timed.items():
            matmat += [(tag, i, k, ms) for i, k, ms in t.timings() if i >= 0]
        layer = LayerData(n=graph.n, answers=answers, images=system.images,
                          matmat=matmat)
        if profiler.result is not None:
            layer.trace, layer.launches, layer.profiled, layer.records_ok = \
                profiler.result
    system.close()
    del system
    gc.collect()
    t_judge = time.perf_counter()
    checks, failed, correct = judge(cell, graph, answers, device, seed)
    log(f"check: {len(answers)} answers judged in "
        f"{time.perf_counter() - t_judge:.2f} s")
    out = {"correct": bool(correct), "attempted": len(answers),
           "failed": len(failed)}
    if trace:
        out["metrics"] = per_layer(cell, layer)
    else:
        out["metrics"] = end_to_end(cell, answers, window, setup_s, peak,
                                    failed)
    out["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": (torch.cuda.get_device_name(device) if cuda
                              else "cpu"),
                     "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and layer.trace is not None:
        out["device"]["busy_s"] = layer.trace.busy_s()
        out["device"]["window_s"] = layer.trace.window_s
        out["breakdown"] = {"device_ops": layer.trace.device_ops(),
                            "idle_gaps": layer.trace.idle_gaps()}
    out["checks"] = checks
    return out


def per_layer(cell: Cell, data: LayerData) -> dict:
    out = {}
    for name in cell.per_layer:
        mod = load_metric(name, cell.root)
        value = mod.read(data)
        if value is None:
            log(f"metric {name}: nothing to read in this run")
            continue
        out[name] = {"value": float(value), "unit": mod.UNIT}
    return out
