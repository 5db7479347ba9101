"""Reading the profiler's trace of a window of solves.

The arithmetic of the repository's chip_smoke.py, kept here as part of
the yardstick: device records only (an operator's host entry repeats the
time of the kernels it launched), kernels grouped by name with template
arguments stripped, the busy time as the union of the device's kernel,
copy and fill intervals, and a window whose records came back short
(fewer kernels of a kind than the wrappers counted as launched: CUPTI
drops records now and then) is profiled again.

The trace is exported as Chrome JSON into a temporary file under TMPDIR,
read, and deleted.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
WINDOW_MARK = "eigbench.window"


def kernel_name(name: str) -> str:
    """A kernel's name without `void`, its template arguments and its
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(.*$", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


@dataclasses.dataclass
class Trace:
    window: tuple          # (start, end) µs of the window mark
    device: list           # (start, end, cat, name, bytes) µs
    host: list             # (start, end, name) µs

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _clipped(self):
        lo, hi = self.window
        for s, e, cat, name, nbytes in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                yield s, e, cat, name, nbytes

    def busy_intervals(self) -> list:
        """The union of device activity inside the window, merged."""
        out = []
        for s, e, *_ in sorted(self._clipped(), key=lambda r: r[:2]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def by_kernel(self) -> dict:
        """{name: [count, seconds]} of the device records in the window,
        kernels by `kernel_name`, copies and fills by their own name."""
        out: dict = {}
        for s, e, cat, name, _ in self._clipped():
            key = kernel_name(name) if cat == "kernel" else name
            rec = out.setdefault(key, [0, 0.0])
            rec[0] += 1
            rec[1] += (e - s) / 1e6
        return out

    def copies(self, direction: str = "HtoD") -> tuple[int, float]:
        """(bytes, seconds) of the window's memcpy records of a direction;
        bytes None when the trace carries none."""
        nbytes, secs, known = 0, 0.0, True
        for s, e, cat, name, b in self._clipped():
            if cat == "gpu_memcpy" and direction in name:
                secs += (e - s) / 1e6
                if b is None:
                    known = False
                else:
                    nbytes += b
        return (nbytes if known else None), secs

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time inside the window, summed by the innermost
        host record running at each gap's midpoint, largest first:
        [[name, seconds], ...]."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        host = sorted(self.host, key=lambda r: (r[0], -r[1]))
        sums: dict = {}
        stack: list = []
        i = 0
        for gs, ge in gaps:
            mid = 0.5 * (gs + ge)
            while i < len(host) and host[i][0] <= mid:
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host (no record)"
            sums[name] = sums.get(name, 0.0) + (ge - gs) / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
                [:top]]

    def device_ops(self, top: int = 10) -> list:
        rows = sorted(self.by_kernel().items(), key=lambda kv: -kv[1][1])
        return [[k, v[1]] for k, v in rows[:top]]

    def count(self, pattern: str) -> int:
        """Kernel records in the window whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(v[0] for k, v in self.by_kernel().items() if rx.search(k))


def read_trace(prof) -> Trace:
    """The Chrome trace of a finished `torch.profiler.profile`, reduced to
    the window mark and the device and host records."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="eigbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    window, device, host = None, [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, d = float(ev["ts"]), float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            b = (ev.get("args") or {}).get("bytes")
            device.append((s, s + d, cat, name,
                           None if b is None else int(b)))
        elif cat in HOST_CATS:
            if name == WINDOW_MARK and cat == "user_annotation":
                window = (s, s + d)
            host.append((s, s + d, name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_MARK!r} record")
    return Trace(window=window, device=device, host=host)
