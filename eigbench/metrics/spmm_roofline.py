"""The block SpMM kernels' share of their roofline over the profiled
solves: the least time of every launch's bytes at the HBM peak (blocks,
block indices, X read once, Y written once:
`bounds.roofline.spmm_bytes`, one launch per operator application) over
the device time of `spmm_blocksparse_kernel` and its combine kernel, in
%. Nothing is read when the profiler's records came back short."""
import re

from eigbench.bounds import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "solve_s"
KERNEL = re.compile(r"spmm_blocksparse_(combine_)?kernel$")


def read(data):
    if data.trace is None or not data.records_ok:
        return None
    profiled = set(data.profiled)
    calls = [(tag, k) for tag, i, k, _ in data.matmat if i in profiled]
    secs = sum(v[1] for name, v in data.trace.by_kernel().items()
               if KERNEL.search(name))
    if not calls or secs <= 0 or len(calls) != data.launches["spmm"]:
        return None
    least = sum(roofline.seconds(roofline.spmm_bytes(data.images[tag], k))
                for tag, k in calls)
    return 100.0 * least / secs
