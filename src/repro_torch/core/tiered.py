"""TieredStore — the slow tier with byte-exact I/O accounting.

Port of `repro.core.tiered` without the multi-tenant `namespace()` facade
(`StoreNamespace` waits for the serving slice, ROADMAP queue 1 item 7)
and without what only the SSD-streamed image and transposed views use:
read-only entries and shared `data_id`s (item 3).

The paper keeps the Krylov subspace on SSD (§3.4) and fights for read
bandwidth and write endurance. Here the device tier is tensors on the
store's device (the H100's memory) and the slow tier is the backend:
pinned host memory reached over PCIe (`backend="ram"`). `stats` counts
logical tier traffic to the byte exactly as the reference does, so the
two packages' `IOStats.as_dict()` are equal for the same sequence of
operations: the counters measure bytes moved, not time.

Policies from §3.4.4:
  * most-recent-block caching — the newest subspace block stays in the
    device tier (`pin`), and the most recently appended-then-demoted
    block's pages stay pinned in the backend's page cache (`host_pin`,
    driven by MultiVector.append_block; a no-op on the RAM backend);
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
from repro_torch.obs import trace

DEVICE = "device"
HOST = "host"  # the "SSD" tier


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
    tier: str
    device_val: Optional[torch.Tensor]
    has_host: bool                 # backend holds a copy under the name
    nbytes: int
    dirty: bool                    # device copy newer than host copy


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TieredStore:
    """Named tensor store with a device-tier budget and explicit residency.

    device_budget_bytes caps the device tier; putting past the budget
    demotes the least-recently-used non-pinned entries to the host tier
    (counted as slow-tier writes if dirty). `device=None` means the CUDA
    card and raises when there is none; pass `device="cpu"` to run the
    whole store on the CPU (the tests do).
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
        self._device_nbytes = 0
        self._lock = threading.RLock()

    def as_tensor(self, value) -> torch.Tensor:
        """`value` (numpy array or tensor) as a tensor on the store's
        device."""
        if isinstance(value, np.ndarray):
            # a read-only array (e.g. a view of a JAX buffer) is copied
            value = (torch.from_numpy(value) if value.flags.writeable
                     else torch.tensor(value))
        return value.to(self.device)

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
    def put(self, name: str, value, *, tier: str = DEVICE) -> None:
        with self._lock:
            prev = self._entries.get(name)
            t = self.as_tensor(value)
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
                self._entries[name] = _Entry(DEVICE, t, False, nbytes, True)
                self._device_nbytes += nbytes
            else:
                self.backend.store(name, t)
                self.stats.add(host_bytes_written=nbytes, host_writes=1)
                self._entries[name] = _Entry(HOST, None, True, nbytes, False)
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
                return self.backend.load(name).to(self.device,
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
                    self.backend.store(name, e.device_val)
                e.has_host = True
                self.stats.add(host_bytes_written=e.nbytes, host_writes=1)
            e.device_val, e.tier, e.dirty = None, HOST, False
            self._device_nbytes -= e.nbytes

    def host_pin(self, name: str) -> None:
        """Pin `name`'s pages in the backend page cache until the next
        host_pin supersedes it (§3.4.4 "cache the most recent dense
        matrix"; owned by MultiVector.append_block)."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(name)
            if self._recent_host_id == name:
                return
            if self._recent_host_id is not None:
                self.backend.unpin(self._recent_host_id)
            self.backend.pin(name)
            self._recent_host_id = name

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
            if e is not None:
                self.backend.delete(name)
                if self._recent_host_id == name:
                    self.backend.unpin(name)
                    self._recent_host_id = None

    def names(self):
        with self._lock:
            return list(self._entries)

    def tier_of(self, name: str) -> str:
        with self._lock:
            return self._entries[name].tier

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
        """Yield `get(name)` for each name while announcing the next
        `readahead` entries to the backend (the sequential-scan driver of
        the SSD-streamed image, ROADMAP queue 1 item 3)."""
        names = list(names)
        for i, nm in enumerate(names):
            if readahead > 0:
                self.prefetch(names[i + 1:i + 1 + readahead])
            yield self.get(nm)

    def close(self) -> None:
        self.backend.close()

    def reset_stats(self) -> IOStats:
        old, self.stats = self.stats, IOStats()
        return old
