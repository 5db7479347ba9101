"""The device's idle share over the profiled solves: 1 − the union of
its kernel, copy and fill records over the window's length, in %."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "solve_s"


def read(data):
    if data.trace is None or data.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - data.trace.busy_s() / data.trace.window_s)
