"""Host-to-device copy rate over the profiled solves: the bytes of the
profiler's `Memcpy HtoD` records over their device time, in GB/s (the
subspace blocks read from pinned host memory)."""
UNIT, BETTER, SOURCE = "GB/s", "higher", "device_trace"
LAYER = "tiered store"
MOVES = "solve_s"


def read(data):
    if data.trace is None:
        return None
    nbytes, secs = data.trace.copies("HtoD")
    if not nbytes or secs <= 0:
        return None
    return nbytes / secs / 1e9
