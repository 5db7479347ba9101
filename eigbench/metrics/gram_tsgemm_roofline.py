"""The gram and tsgemm kernels' share of their roofline over the
profiled solves: the least time of every launch's bytes at the HBM peak
(by the launch counters' shapes (m, b) and the vectors' length n:
`bounds.roofline.gram_bytes`, `tsgemm_bytes`) over the device time of
their kernels, in %. Nothing is read when the profiler's records came
back short."""
import re

from eigbench.bounds import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "solve_s"
KERNEL = re.compile(r"(^|:)(gram|tsgemm)_(vec_|tile_|pair2_)?kernel$")


def read(data):
    if data.trace is None or not data.records_ok:
        return None
    n = data.n
    least = sum(c * roofline.seconds(roofline.gram_bytes(n, m, b))
                for (m, b), c in data.launches["gram_by_shape"].items())
    least += sum(c * roofline.seconds(roofline.tsgemm_bytes(n, m, b))
                 for (m, b), c in data.launches["tsgemm_by_shape"].items())
    secs = sum(v[1] for name, v in data.trace.by_kernel().items()
               if KERNEL.search(name))
    if least <= 0 or secs <= 0:
        return None
    return 100.0 * least / secs
