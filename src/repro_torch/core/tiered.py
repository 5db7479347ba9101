"""TieredStore — the slow tier with byte-exact I/O accounting.

Port of `repro.core.tiered` without the multi-tenant `namespace()` facade
(`StoreNamespace` and its per-session budgets and splits wait for the
serving slice, ROADMAP queue 1 item 6).

The paper keeps the Krylov subspace on SSD (§3.4) and fights for read
bandwidth and write endurance. Here the device tier is tensors on the
store's device (the H100's memory) and the slow tier is the backend:

  backend="ram"   pinned host memory reached over PCIe;
  backend="safs"  the paper's layer — one page file per data_id under
                  `backend_opts["root"]`, an LRU page cache with async
                  write-behind and most-recent-block pinning, and a
                  readahead pool (`safs.backend.SafsBackend`).

`stats` counts logical tier traffic to the byte exactly as the reference
does, so the two packages' `IOStats.as_dict()` are equal for the same
sequence of operations: the counters measure bytes moved, not time. With
safs the backend's own `stats` count the physical disk bytes as well.

Policies from §3.4.4:
  * most-recent-block caching — the newest subspace block stays in the
    device tier (`pin`), and the most recently appended-then-demoted
    block's pages stay pinned in the backend's page cache (`host_pin`,
    driven by MultiVector.append_block; a no-op on the RAM backend);
  * data identifiers — an entry's bytes live in the backend under its
    `data_id` (its name unless `put` gives another), so entries sharing
    one id share the cached pages;
  * write-avoidance — demotion only writes when the block is dirty.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import from_numpy
from repro_torch.obs import trace

DEVICE = "device"
HOST = "host"  # the "SSD" tier

NS_SEP = "::"  # session prefix in qualified ids: "<session_id>::<name>"


def ns_of(data_id: str) -> str:
    """Namespace (session id) of a qualified id; "" for root-owned ids.
    The SAFS backend files and accounts a namespaced id per session."""
    i = data_id.find(NS_SEP)
    return data_id[:i] if i >= 0 else ""


class ReadOnlyError(RuntimeError):
    """Write attempted against a read-only store entry (streamed matrix
    image chunks: per-chunk dirty tracking is not implemented, so a write
    would silently diverge from the on-disk image)."""


@dataclasses.dataclass
class IOStats:
    host_bytes_read: int = 0       # "SSD" reads (paper Table 3: 145 TB)
    host_bytes_written: int = 0    # "SSD" writes (paper Table 3: 4 TB)
    host_reads: int = 0
    host_writes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    passes: int = 0                # streamed whole-subspace reads (§3.4.3)
    pass_bytes_read: int = 0       # host bytes read INSIDE those passes
    retries: int = 0               # transient-I/O retries absorbed (safs)
    retry_sleep_ms: float = 0.0    # cumulative backoff slept in retries

    def __post_init__(self):
        # not a dataclass field: asdict/eq stay counter-only
        self._lock = threading.Lock()

    def add(self, **deltas: int) -> None:
        """Atomically bump counters."""
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def bytes_per_pass(self) -> float:
        """Average slow-tier bytes read per streamed subspace pass — the
        §3.4.3 figure of merit (only bytes read inside SubspacePass runs
        count)."""
        return self.pass_bytes_read / max(self.passes, 1)

    def hit_rate(self) -> float:
        """Fraction of lookups served without a slow-tier read."""
        return self.cache_hits / max(self.cache_hits + self.cache_misses, 1)

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["bytes_per_pass"] = self.bytes_per_pass()
        d["hit_rate"] = self.hit_rate()
        return d


@dataclasses.dataclass
class _Entry:
    data_id: str
    tier: str
    device_val: Optional[torch.Tensor]
    has_host: bool                 # backend holds a copy of data_id
    nbytes: int
    dirty: bool                    # device copy newer than host copy
    readonly: bool = False         # writes raise (streamed matrix image)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_tensor(value) -> torch.Tensor:
    """A tensor as it is; a numpy array as a CPU tensor of its bytes (bf16
    by its type's name). A read-only array (e.g. a view of a JAX buffer)
    is copied first."""
    if isinstance(value, np.ndarray):
        if not value.flags.writeable:
            value = value.copy()
        return from_numpy(value)
    return value


class TieredStore:
    """Named tensor store with a device-tier budget and explicit residency.

    device_budget_bytes caps the device tier; putting past the budget
    demotes the least-recently-used non-pinned entries to the host tier
    (counted as slow-tier writes if dirty). `device=None` means the CUDA
    card and raises when there is none; pass `device="cpu"` to run the
    whole store on the CPU (the tests do). The host tier's bytes live in
    `backend` ("ram" | "safs" | a constructed backend; see the module
    docstring), which takes `backend_opts` and the store's device.
    """

    def __init__(self, device_budget_bytes: int = 1 << 62, *,
                 backend="ram", backend_opts: dict | None = None,
                 device=None):
        from repro_torch.safs.backend import make_backend  # late: cycle
        self.device = resolve_device(device)
        self.device_budget = device_budget_bytes
        self.stats = IOStats()
        self.backend = make_backend(backend, device=self.device,
                                    **(backend_opts or {}))
        self._entries: Dict[str, _Entry] = {}
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # oldest first
        self._pinned: set[str] = set()
        self._recent_host_id: Optional[str] = None   # page-cache pin slot
        #                                              (a data_id)
        self._device_nbytes = 0
        self._lock = threading.RLock()

    def as_tensor(self, value) -> torch.Tensor:
        """`value` (numpy array or tensor) as a tensor on the store's
        device."""
        return _host_tensor(value).to(self.device)

    # -- residency accounting -------------------------------------------------
    def device_bytes(self) -> int:
        return self._device_nbytes

    def host_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.has_host)

    def _touch(self, name: str) -> None:
        if name in self._lru:
            self._lru.move_to_end(name)
        else:
            self._lru[name] = None

    def _evict_for(self, incoming: int) -> None:
        if self._device_nbytes + incoming <= self.device_budget:
            return
        for name in list(self._lru):                # oldest first
            if self._device_nbytes + incoming <= self.device_budget:
                break
            e = self._entries[name]
            if e.tier == DEVICE and name not in self._pinned:
                self.demote(name)

    # -- core API --------------------------------------------------------------
    def put(self, name: str, value, *, tier: str = DEVICE,
            data_id: str | None = None, readonly: bool = False) -> None:
        """Store `value` under `name`, on the device tier or written
        straight to the host tier (a host-tier value is not moved to the
        device first). Its bytes live in the backend under `data_id`
        (default `name`). A read-only entry refuses any later put."""
        with self._lock:
            prev = self._entries.get(name)
            if prev is not None and prev.readonly:
                raise ReadOnlyError(
                    f"store entry {name!r} is read-only (streamed matrix "
                    f"image chunk; per-chunk dirty tracking is not "
                    f"implemented — rebuild the operator instead of "
                    f"writing through it)")
            t = self.as_tensor(value) if tier == DEVICE else \
                _host_tensor(value)
            nbytes = _nbytes(t)
            if prev is not None:
                # retire the stale entry before eviction runs, so
                # _evict_for can neither demote the about-to-be-replaced
                # bytes nor double-release them from the running counter
                if prev.tier == DEVICE:
                    self._device_nbytes -= prev.nbytes
                del self._entries[name]
                self._lru.pop(name, None)
            if tier == DEVICE:
                self._evict_for(nbytes)
                self._entries[name] = _Entry(data_id or name, DEVICE, t,
                                             False, nbytes, True, readonly)
                self._device_nbytes += nbytes
            else:
                e = _Entry(data_id or name, HOST, None, True, nbytes, False,
                           readonly)
                self.backend.store(e.data_id, t)
                self.stats.add(host_bytes_written=nbytes, host_writes=1)
                self._entries[name] = e
            self._touch(name)

    def get(self, name: str) -> torch.Tensor:
        """Read a tensor; host-tier reads are counted as slow-tier reads."""
        with self._lock:
            e = self._entries[name]
            self._touch(name)
            if e.tier == DEVICE:
                self.stats.add(cache_hits=1)
                return e.device_val
            self.stats.add(cache_misses=1, host_bytes_read=e.nbytes,
                           host_reads=1)
            with trace.span("store.get", block=name, bytes=e.nbytes):
                return self.backend.load(e.data_id).to(self.device,
                                                       non_blocking=True)

    def promote(self, name: str) -> torch.Tensor:
        """Move to device tier (counted read if it was on host)."""
        with self._lock:
            e = self._entries[name]
            if e.tier == DEVICE:
                return e.device_val
            val = self.get(name)
            self._evict_for(e.nbytes)
            e.device_val, e.tier, e.dirty = val, DEVICE, False
            self._device_nbytes += e.nbytes
            return val

    def demote(self, name: str) -> None:
        """Move to host tier; writes only if dirty (write-avoidance)."""
        with self._lock:
            e = self._entries[name]
            if e.tier == HOST:
                return
            if e.dirty or not e.has_host:
                with trace.span("store.demote", block=name, bytes=e.nbytes):
                    self.backend.store(e.data_id, e.device_val)
                e.has_host = True
                self.stats.add(host_bytes_written=e.nbytes, host_writes=1)
            e.device_val, e.tier, e.dirty = None, HOST, False
            self._device_nbytes -= e.nbytes

    def host_pin(self, name: str) -> None:
        """Pin `name`'s pages in the backend page cache until the next
        host_pin supersedes it (§3.4.4 "cache the most recent dense
        matrix"; owned by MultiVector.append_block)."""
        with self._lock:
            data_id = self._entries[name].data_id
            if self._recent_host_id == data_id:
                return
            if self._recent_host_id is not None:
                self.backend.unpin(self._recent_host_id)
            self.backend.pin(data_id)
            self._recent_host_id = data_id

    def pin(self, name: str) -> None:
        """Pin in device tier — the most-recent-block cache of §3.4.4."""
        with self._lock:
            self.promote(name)
            self._pinned.add(name)

    def unpin(self, name: str) -> None:
        with self._lock:
            self._pinned.discard(name)

    def delete(self, name: str) -> None:
        with self._lock:
            e = self._entries.pop(name, None)
            if e is not None and e.tier == DEVICE:
                self._device_nbytes -= e.nbytes
            self._lru.pop(name, None)
            self._pinned.discard(name)
            if e is not None and not any(o.data_id == e.data_id
                                         for o in self._entries.values()):
                self.backend.delete(e.data_id)
                if self._recent_host_id == e.data_id:
                    self.backend.unpin(e.data_id)
                    self._recent_host_id = None

    def names(self):
        with self._lock:
            return list(self._entries)

    def tier_of(self, name: str) -> str:
        with self._lock:
            return self._entries[name].tier

    # -- checkpoint plumbing ----------------------------------------------------
    def sync_device_entries(self) -> None:
        """Write device-tier entries with no current host copy through to
        the backend (residency unchanged: the entry just becomes clean
        with a host copy, as after a promote). A page-file snapshot of
        the store then misses no block (the checkpoint layer, ROADMAP
        queue 1 item 4, calls it)."""
        with self._lock:
            for e in self._entries.values():
                if e.tier == DEVICE and (e.dirty or not e.has_host):
                    self.backend.store(e.data_id, e.device_val)
                    e.has_host, e.dirty = True, False

    def data_ids(self) -> list[str]:
        """Backend ids owned by this store, each once, in entry order:
        what a snapshot of the store's page files covers (on a shared
        backend, not `backend.data_ids()`)."""
        with self._lock:
            out, seen = [], set()
            for e in self._entries.values():
                if e.has_host and e.data_id not in seen:
                    seen.add(e.data_id)
                    out.append(e.data_id)
            return out

    def resolve_data_id(self, name: str) -> str:
        """Qualified backend id for a logical name (the identity here; a
        namespace facade prefixes its session)."""
        return name

    def account_read(self, nbytes: int, *, reads: int = 1) -> None:
        """Attribute an out-of-band slow-tier read (the operator's matrix
        image) to this store's counters."""
        self.stats.add(host_bytes_read=int(nbytes), host_reads=reads)

    # -- streaming helpers ------------------------------------------------------
    def begin_pass(self) -> int:
        """Mark the start of one streamed whole-subspace read; returns the
        host_bytes_read watermark to hand back to `end_pass`."""
        self.stats.add(passes=1)
        return self.stats.host_bytes_read

    def end_pass(self, read_watermark: int) -> None:
        """Attribute the bytes read since the watermark to
        `stats.pass_bytes_read`."""
        self.stats.add(pass_bytes_read=(self.stats.host_bytes_read
                                        - read_watermark))

    def prefetch(self, names: Iterable[str]) -> None:
        """Hint the backend to stage host-tier entries ahead of a pass (a
        no-op on the RAM backend)."""
        with self._lock:
            ids = [n for n in names
                   if n in self._entries and self._entries[n].tier == HOST]
        if ids:
            trace.event("store.prefetch", n=len(ids), first=ids[0])
            self.backend.prefetch(ids)

    def stream(self, names: Iterable[str], *, readahead: int = 2):
        """Yield `get(name)` for each name while keeping the next
        `readahead` entries' pages in flight on the backend's readahead
        pool: the sequential-scan driver of the SSD-streamed image
        (`GraphOperator(stream_image=True)`). On the ram backend it is a
        plain `get` loop."""
        names = list(names)
        for i, nm in enumerate(names):
            if readahead > 0:
                self.prefetch(names[i + 1:i + 1 + readahead])
            yield self.get(nm)

    def flush(self) -> None:
        """Force dirty host-tier pages down to the physical medium (a
        durability barrier on the safs backend; nothing on ram)."""
        self.backend.flush()

    def close(self) -> None:
        self.backend.close()

    def reset_stats(self) -> IOStats:
        old, self.stats = self.stats, IOStats()
        return old
