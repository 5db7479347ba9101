"""Pull-based metrics registry — one snapshot shape over every counter
(a copy of `repro.obs.metrics`).

The repo accumulated four counter surfaces with four spellings:
`IOStats.as_dict()`, `Prefetcher.stats()`, `WriteBehind.stats_dict()`,
and the merged `SafsBackend.stats_dict()`. `snapshot_counters` reads any
of them (duck-typed — this module imports nothing from core/safs, so it
can sit below every layer without cycles); `MetricsRegistry` names a set
of sources and snapshots them all at once; `gauges` computes the derived
figures the paper argues with: cache hit rate, prefetch overlap fraction,
bytes/pass, write-behind backlog depth, write/read ratio (Table 3: 0.028).

`delta(before, after)` subtracts two snapshots recursively so a solve's
own traffic can be reported even on a shared, long-lived store; apply
`derive` to a delta to recompute ratio fields (a subtracted hit_rate is
meaningless — recompute it from the subtracted counts).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

# IOStats fields that are derived ratios, not raw counters: delta() must
# recompute them, never subtract them.
_DERIVED_FIELDS = ("hit_rate", "bytes_per_pass")


def snapshot_counters(obj: Any) -> Optional[dict]:
    """Uniform counter snapshot of any stats-bearing object: dicts pass
    through (copied); `stats_dict()` / `as_dict()` / callable `stats()`
    are tried in that order; an object exposing a `stats` attribute
    (TieredStore, PageCache) snapshots that attribute."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return dict(obj)
    for meth in ("stats_dict", "as_dict"):
        fn = getattr(obj, meth, None)
        if callable(fn):
            return fn()
    st = getattr(obj, "stats", None)
    if callable(st):
        return st()
    if st is not None and st is not obj:
        return snapshot_counters(st)
    raise TypeError(f"no counter surface on {type(obj).__name__!r} "
                    f"(need stats_dict/as_dict/stats)")


def snapshot_store(store) -> dict:
    """The standard per-store snapshot: logical tier traffic + the
    backend's merged physical-side counters."""
    return {"logical": snapshot_counters(store.stats),
            "device_bytes": store.device_bytes(),
            "backend": snapshot_counters(store.backend)}


def delta(before: Any, after: Any) -> Any:
    """Recursive numeric `after - before`. Non-numeric leaves (and leaves
    missing from `before`) keep `after`'s value; derived ratio fields are
    recomputed from the subtracted counters via `derive`."""
    if isinstance(before, dict) and isinstance(after, dict):
        out = {k: delta(before.get(k), v) for k, v in after.items()}
        if any(k in out for k in _DERIVED_FIELDS):
            out = derive(out)
        return out
    if (isinstance(before, (int, float)) and isinstance(after, (int, float))
            and not isinstance(before, bool) and not isinstance(after, bool)):
        return after - before
    return after


def derive(flat: dict) -> dict:
    """Recompute the derived gauges of an IOStats-shaped dict from its raw
    counters (use on `delta` output, where subtracted ratios are garbage).
    Only touches the fields whose inputs are present."""
    out = dict(flat)
    if "cache_hits" in out and "cache_misses" in out:
        hits, misses = out["cache_hits"], out["cache_misses"]
        out["hit_rate"] = hits / max(hits + misses, 1)
    if "pass_bytes_read" in out and "passes" in out:
        out["bytes_per_pass"] = (out["pass_bytes_read"]
                                 / max(out["passes"], 1))
    return out


def gauges(snap: dict) -> dict:
    """Derived figures off a `snapshot_store` snapshot (or a delta of
    two): the numbers the paper's Table 3 / §3.4.2 argue with."""
    logical = derive(snap.get("logical") or {})
    backend = snap.get("backend") or {}
    io = derive(backend.get("io") or {}) if isinstance(backend, dict) else {}
    pf = backend.get("prefetch") if isinstance(backend, dict) else None
    wb = backend.get("write_behind") if isinstance(backend, dict) else None
    busy = (pf or {}).get("busy_seconds", 0.0)
    return {
        "logical_hit_rate": logical.get("hit_rate"),
        "page_hit_rate": io.get("hit_rate"),
        "bytes_per_pass": logical.get("bytes_per_pass"),
        "passes": logical.get("passes"),
        "overlap_fraction": ((pf or {}).get("overlap_seconds", 0.0)
                             / busy if busy > 0 else 0.0),
        "wb_backlog_pages": (wb or {}).get("pending_pages", 0),
        "wb_peak_depth_pages": (wb or {}).get("max_depth_pages", 0),
        "write_read_ratio": (logical.get("host_bytes_written", 0)
                             / max(logical.get("host_bytes_read", 0), 1)),
    }


class MetricsRegistry:
    """Named pull-based sources snapshotted together.

    `register(name, obj_or_fn)` accepts either a zero-arg callable
    returning a dict or any object `snapshot_counters` understands.
    `snapshot()` never raises — a failing source reports its error in
    place so one dead counter cannot take down a solve epilogue."""

    def __init__(self):
        self._sources: Dict[str, Callable[[], Optional[dict]]] = {}

    def register(self, name: str, source: Any) -> None:
        if not callable(source):
            obj = source
            source = lambda: snapshot_counters(obj)  # noqa: E731
        self._sources[name] = source

    def unregister(self, name: str) -> None:
        self._sources.pop(name, None)

    def names(self) -> list:
        return sorted(self._sources)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in self.names():
            try:
                out[name] = self._sources[name]()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out
