"""Low-overhead span tracer — one timeline across solver, store and SAFS.

Design constraints, in order:

  1. *Disabled must be free.* Every instrumentation point in the hot paths
     (`TieredStore.get`, `SubspacePass.run`, SAFS fill/evict/retire) calls
     the module-level `span()` / `event()`; with no tracer installed these
     are a global None-check returning a shared no-op singleton — no
     allocation beyond the kwargs dict, no locking, no clock reads.
  2. *Threads are first-class.* SAFS does its real work off-thread (the
     readahead pool fills pages, the write-behind drain retires batches);
     spans record which thread they ran on so the exported timeline shows
     disk work genuinely overlapping foreground compute. One lock guards
     the record list; thread idents map to small stable tids.
  3. *Machine-readable first.* Records are plain dicts with a stable
     schema (`repro.obs/v1`); `write_jsonl` is the system-of-record
     export (validated by `repro.obs.report --validate`), `write_chrome`
     converts the same records to Chrome trace-event JSON for Perfetto /
     chrome://tracing.

Timestamps are microseconds from the tracer's construction
(`time.perf_counter` deltas — monotonic, sub-µs); the meta record carries
the wall-clock epoch for humans.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

SCHEMA = "repro.obs/v1"


def _jsonable(o: Any):
    """json.dumps default hook: numpy scalars/arrays → python, else str."""
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    tolist = getattr(o, "tolist", None)
    if callable(tolist):
        return tolist()
    return str(o)


class _NullSpan:
    """Shared no-op span returned when no tracer is installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed region. Use as a context manager; `set(**attrs)` attaches
    attributes discovered during the region (bytes read, pages evicted)."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._record_span(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Thread-safe in-process collector of spans / events / metric dumps.

    `max_records` bounds memory: past it, new records are counted in
    `dropped` instead of stored (the summary record reports the count, and
    the report's byte-exact reconciliation refuses to run on a lossy
    trace).
    """

    def __init__(self, *, max_records: int = 1_000_000):
        self.max_records = int(max_records)
        self.dropped = 0
        self._lock = threading.Lock()
        self._records: List[dict] = []
        self._tids: Dict[int, int] = {}     # thread ident -> small tid
        self._tnames: Dict[int, str] = {}   # tid -> thread name
        self._epoch_perf = time.perf_counter()
        self._epoch_unix = time.time()

    # ---------------------------------------------------------- recording
    def _us(self, t: float) -> float:
        return (t - self._epoch_perf) * 1e6

    def _append(self, rec: dict) -> None:
        with self._lock:
            if len(self._records) >= self.max_records:
                self.dropped += 1
                return
            ident = threading.get_ident()
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
                self._tnames[tid] = threading.current_thread().name
            rec["tid"] = tid
            self._records.append(rec)

    def _record_span(self, name: str, t0: float, t1: float,
                     args: dict) -> None:
        self._append({"type": "span", "name": name, "ts": self._us(t0),
                      "dur": (t1 - t0) * 1e6, "args": args})

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration instant (announcements, convergence points)."""
        self._append({"type": "event", "name": name,
                      "ts": self._us(time.perf_counter()), "args": attrs})

    def metric(self, name: str, data: dict) -> None:
        """A structured counter snapshot pinned to the timeline (the solve
        epilogue records the store/backend deltas here; the report's
        reconciliation reads it back)."""
        self._append({"type": "metrics", "name": name,
                      "ts": self._us(time.perf_counter()), "data": data})

    # ------------------------------------------------------------- export
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def counts(self) -> dict:
        with self._lock:
            by_type: Dict[str, int] = {}
            for r in self._records:
                by_type[r["type"]] = by_type.get(r["type"], 0) + 1
            return {"spans": by_type.get("span", 0),
                    "events": by_type.get("event", 0),
                    "metrics": by_type.get("metrics", 0),
                    "dropped": self.dropped}

    def export_records(self) -> List[dict]:
        """meta header + records + summary footer — the JSONL layout."""
        with self._lock:
            recs = list(self._records)
            threads = {str(t): n for t, n in self._tnames.items()}
            dropped = self.dropped
        by_type: Dict[str, int] = {}
        for r in recs:
            by_type[r["type"]] = by_type.get(r["type"], 0) + 1
        meta = {"type": "meta", "schema": SCHEMA, "unit": "us",
                "epoch_unix": self._epoch_unix, "threads": threads}
        summary = {"type": "summary", "spans": by_type.get("span", 0),
                   "events": by_type.get("event", 0),
                   "metrics": by_type.get("metrics", 0), "dropped": dropped}
        return [meta] + recs + [summary]

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for rec in self.export_records():
                f.write(json.dumps(rec, default=_jsonable) + "\n")
        return path

    def write_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(chrome_trace(self.export_records()), f,
                      default=_jsonable)
        return path


def chrome_trace(records: List[dict]) -> dict:
    """Convert exported records to the Chrome trace-event format (load the
    file in https://ui.perfetto.dev or chrome://tracing). Spans become
    complete ("X") events, events instants ("i"), metric snapshots ride as
    instants with their data in args; thread names come from the meta
    record."""
    evs: List[dict] = []
    threads: Dict[str, str] = {}
    for r in records:
        t = r.get("type")
        if t == "meta":
            threads = r.get("threads", {})
        elif t == "span":
            evs.append({"name": r["name"], "ph": "X", "ts": r["ts"],
                        "dur": r["dur"], "pid": 0, "tid": r.get("tid", 0),
                        "args": r.get("args", {})})
        elif t == "event":
            evs.append({"name": r["name"], "ph": "i", "s": "t",
                        "ts": r["ts"], "pid": 0, "tid": r.get("tid", 0),
                        "args": r.get("args", {})})
        elif t == "metrics":
            evs.append({"name": r["name"], "ph": "i", "s": "p",
                        "ts": r["ts"], "pid": 0, "tid": r.get("tid", 0),
                        "args": r.get("data", {})})
    for tid, name in threads.items():
        evs.append({"name": "thread_name", "ph": "M", "pid": 0,
                    "tid": int(tid), "args": {"name": name}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


# ------------------------------------------------------------ module state
# One installed tracer per process. Instrumentation points call the
# module-level span()/event(); the None fast path is the whole cost of a
# disabled build.
_TRACER: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall() -> None:
    global _TRACER
    _TRACER = None


def active() -> Optional[Tracer]:
    return _TRACER


@contextlib.contextmanager
def tracing(tracer: Tracer):
    """Install `tracer` for the block's duration, restoring whatever was
    installed before (solves nest; background threads started inside the
    block record into the same tracer)."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    try:
        yield tracer
    finally:
        _TRACER = prev


def span(name: str, **attrs):
    """A span against the installed tracer, or the shared no-op when
    tracing is disabled."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs) -> None:
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)
