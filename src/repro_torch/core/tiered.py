"""TieredStore — the slow tier with byte-exact I/O accounting.

Port of `repro.core.tiered`.

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

Multi-tenancy (many solves over one store and one page cache, as
FlashGraph runs many graph workloads over one SSD cache):
  * `namespace(session_id)` returns a `StoreNamespace` facade that prefixes
    every key with `"<sid>::"`, keeps per-namespace `IOStats`, and exposes
    the store's whole duck API, so solvers run unmodified inside it;
  * per-namespace device budgets (`set_namespace_budget`): a namespace
    overflowing its allotment demotes its *own* LRU entries first, and
    its fused compress chunks at half of it (`compress_acc_bytes`);
  * one host-pin slot *per namespace*: concurrent solves cannot steal each
    other's §3.4.4 most-recent-block page pin;
  * `drop_namespace(sid)` retires a namespace — entries and backend pages
    are deleted, its IOStats survive for post-mortem reports;
  * every public method is serialized by one reentrant lock, and `IOStats`
    increments go through `IOStats.add` (its own lock), so the namespaces'
    sums equal the store's counters exactly under concurrency.
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
    ns: str = ""                   # owning namespace ("" = root)


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
        # page-cache pin (§3.4.4), a data_id — one slot PER NAMESPACE, so
        # concurrent solves cannot steal each other's most-recent pin
        self._recent_host_ids: Dict[str, str] = {}
        self._device_nbytes = 0
        self._lock = threading.RLock()          # serializes all public ops
        self._ns_stats: Dict[str, IOStats] = {}
        self._ns_budget: Dict[str, int] = {}    # per-namespace device caps
        self._ns_device: Dict[str, int] = {}    # device bytes per namespace
        self._namespaces: Dict[str, "StoreNamespace"] = {}

    def as_tensor(self, value) -> torch.Tensor:
        """`value` (numpy array or tensor) as a tensor on the store's
        device."""
        return _host_tensor(value).to(self.device)

    # -- multi-tenancy ---------------------------------------------------------
    def namespace(self, session_id: str) -> "StoreNamespace":
        """Session-scoped facade: keys prefixed `"<sid>::"`, IOStats split
        per session, optional per-session device budget. Re-entering the
        same id (a suspended solve resuming) returns a facade over the
        same accumulated stats."""
        if not session_id or NS_SEP in session_id:
            raise ValueError(f"invalid session id {session_id!r}")
        with self._lock:
            ns = self._namespaces.get(session_id)
            if ns is None:
                ns = StoreNamespace(self, session_id)
                self._namespaces[session_id] = ns
            return ns

    def set_namespace_budget(self, session_id: str,
                             nbytes: Optional[int]) -> None:
        """Cap a session's device-tier bytes (None lifts the cap).
        Shrinking a live session's allotment demotes its own LRU entries
        at once."""
        with self._lock:
            if nbytes is None:
                self._ns_budget.pop(session_id, None)
                return
            self._ns_budget[session_id] = int(nbytes)
            self._evict_for(0, session_id)

    def namespace_budget(self, session_id: str) -> Optional[int]:
        with self._lock:
            return self._ns_budget.get(session_id)

    def drop_namespace(self, session_id: str) -> None:
        """Retire a session: delete its entries and backend pages, release
        its pins and budget. Its IOStats survive (post-mortem reporting:
        they reconcile against the store's totals)."""
        with self._lock:
            for name in [n for n, e in self._entries.items()
                         if e.ns == session_id]:
                self.delete(name)
            rid = self._recent_host_ids.pop(session_id, None)
            if rid is not None:
                self.backend.unpin(rid)
            self._ns_budget.pop(session_id, None)
            self._ns_device.pop(session_id, None)
            self._namespaces.pop(session_id, None)
            drop = getattr(self.backend, "drop_namespace", None)
            if drop is not None:
                drop(session_id)

    def namespace_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-session logical IOStats snapshots (retired sessions too —
        stats outlive `drop_namespace`)."""
        with self._lock:
            return {sid: st.as_dict() for sid, st in self._ns_stats.items()}

    def _ns_io(self, sid: str) -> IOStats:
        st = self._ns_stats.get(sid)
        if st is None:
            st = self._ns_stats.setdefault(sid, IOStats())
        return st

    def _acct(self, ns: str, **deltas: int) -> None:
        """Bump the store-wide counters, and the owning session's split:
        the store's totals equal root traffic plus the namespace sums."""
        self.stats.add(**deltas)
        if ns:
            self._ns_io(ns).add(**deltas)

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

    def _evict_for(self, incoming: int, ns: str = "") -> None:
        # a capped namespace overflowing its allotment demotes its OWN
        # least-recently-used entries first — it cannot push another
        # namespace's working set off the device tier
        budget = self._ns_budget.get(ns)
        if budget is not None:
            while self._ns_device.get(ns, 0) + incoming > budget:
                victim = next(
                    (n for n in self._lru
                     if self._entries[n].tier == DEVICE
                     and self._entries[n].ns == ns
                     and n not in self._pinned), None)
                if victim is None:
                    break
                self.demote(victim)
        if self._device_nbytes + incoming <= self.device_budget:
            return
        for name in list(self._lru):                # oldest first
            if self._device_nbytes + incoming <= self.device_budget:
                break
            e = self._entries[name]
            if e.tier == DEVICE and name not in self._pinned:
                self.demote(name)

    def _drop_entry(self, e: _Entry) -> None:
        """An entry leaving the table (delete / overwrite) releases its
        device residency from the running counters."""
        if e.tier == DEVICE:
            self._sub_device(e)

    def _add_device(self, e: _Entry) -> None:
        self._device_nbytes += e.nbytes
        if e.ns:
            self._ns_device[e.ns] = self._ns_device.get(e.ns, 0) + e.nbytes

    def _sub_device(self, e: _Entry) -> None:
        self._device_nbytes -= e.nbytes
        if e.ns:
            self._ns_device[e.ns] = self._ns_device.get(e.ns, 0) - e.nbytes

    # -- core API --------------------------------------------------------------
    def put(self, name: str, value, *, tier: str = DEVICE,
            data_id: str | None = None, readonly: bool = False) -> None:
        """Store `value` under `name`, on the device tier or written
        straight to the host tier (a host-tier value is not moved to the
        device first). Its bytes live in the backend under `data_id`
        (default `name`). A read-only entry refuses any later put."""
        with self._lock:
            ns = ns_of(name)
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
                self._drop_entry(prev)
                del self._entries[name]
                self._lru.pop(name, None)
            if tier == DEVICE:
                self._evict_for(nbytes, ns)
                e = _Entry(data_id or name, DEVICE, t, False, nbytes, True,
                           readonly, ns)
                self._entries[name] = e
                self._add_device(e)
            else:
                e = _Entry(data_id or name, HOST, None, True, nbytes, False,
                           readonly, ns)
                self.backend.store(e.data_id, t)
                self._acct(ns, host_bytes_written=nbytes, host_writes=1)
                self._entries[name] = e
            self._touch(name)

    def get(self, name: str) -> torch.Tensor:
        """Read a tensor; host-tier reads are counted as slow-tier reads."""
        with self._lock:
            e = self._entries[name]
            self._touch(name)
            if e.tier == DEVICE:
                self._acct(e.ns, cache_hits=1)
                return e.device_val
            self._acct(e.ns, cache_misses=1, host_bytes_read=e.nbytes,
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
            self._evict_for(e.nbytes, e.ns)
            e.device_val, e.tier, e.dirty = val, DEVICE, False
            self._add_device(e)
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
                self._acct(e.ns, host_bytes_written=e.nbytes, host_writes=1)
            self._sub_device(e)
            e.device_val, e.tier, e.dirty = None, HOST, False

    def host_pin(self, name: str) -> None:
        """Pin `name`'s pages in the backend page cache until the next
        host_pin *from the same namespace* supersedes it (§3.4.4 "cache
        the most recent dense matrix"; owned by MultiVector.append_block:
        plain LRU demotions must not move it)."""
        with self._lock:
            e = self._entries[name]
            cur = self._recent_host_ids.get(e.ns)
            if cur == e.data_id:
                return
            if cur is not None:
                self.backend.unpin(cur)
            self.backend.pin(e.data_id)
            self._recent_host_ids[e.ns] = e.data_id

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
            if e is not None:
                self._drop_entry(e)
            self._lru.pop(name, None)
            self._pinned.discard(name)
            if e is not None and not any(o.data_id == e.data_id
                                         for o in self._entries.values()):
                self.backend.delete(e.data_id)
                if self._recent_host_ids.get(e.ns) == e.data_id:
                    self.backend.unpin(e.data_id)
                    del self._recent_host_ids[e.ns]

    def names(self):
        with self._lock:
            return list(self._entries)

    def tier_of(self, name: str) -> str:
        with self._lock:
            return self._entries[name].tier

    # -- checkpoint plumbing ----------------------------------------------------
    def sync_device_entries(self, ns: Optional[str] = None) -> None:
        """Write device-tier entries (of one namespace, if given) with no
        current host copy through to the backend (residency unchanged: the
        entry just becomes clean with a host copy, as after a promote). A
        page-file snapshot of the store then misses no block
        (`ckpt.save_safs` calls it)."""
        with self._lock:
            for e in self._entries.values():
                if ns is not None and e.ns != ns:
                    continue
                if e.tier == DEVICE and (e.dirty or not e.has_host):
                    self.backend.store(e.data_id, e.device_val)
                    e.has_host, e.dirty = True, False

    def data_ids(self, ns: Optional[str] = None) -> list[str]:
        """Backend ids owned by this store (or one namespace), each once,
        in entry order: what a snapshot of the store's page files covers
        (on a shared backend, not `backend.data_ids()`: a session's
        checkpoint must not capture other sessions' page files)."""
        with self._lock:
            out, seen = [], set()
            for e in self._entries.values():
                if ns is not None and e.ns != ns:
                    continue
                if e.has_host and e.data_id not in seen:
                    seen.add(e.data_id)
                    out.append(e.data_id)
            return out

    def resolve_data_id(self, name: str) -> str:
        """Qualified backend id for a logical name (the identity here; a
        namespace facade prefixes its session)."""
        return name

    # -- budget hooks -----------------------------------------------------------
    def compress_acc_bytes(self) -> Optional[int]:
        """Per-store cap on the fused compress pass's transient
        accumulators (`core.multivector.COMPRESS_PASS_ACC_BYTES`). None
        keeps the global default; a namespace under a device budget
        returns a scaled cap so a small-budget session chunks its compress
        pass."""
        return None

    def account_read(self, nbytes: int, *, reads: int = 1) -> None:
        """Attribute an out-of-band slow-tier read (the operator's matrix
        image) to this store's counters; a namespace facade routes it to
        its split too."""
        self._acct("", host_bytes_read=int(nbytes), host_reads=reads)

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
            ids = [self._entries[n].data_id for n in names
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


class StoreNamespace:
    """Session-scoped view of a shared `TieredStore`.

    Mirrors the store's duck API (put/get/promote/demote/pin/host_pin/
    begin_pass/stream/...), prefixing every key with `"<sid>::"` and
    splitting IOStats per session, so `MultiVector`, `SubspacePass`,
    `GraphOperator` and every solver run unmodified inside a session.
    `close()` retires the whole namespace (entries and backend pages);
    the session's stats survive on the parent for post-mortem reporting.

    Pass accounting is namespace-local: `begin_pass` watermarks the
    *session's* host_bytes_read and `end_pass` attributes the delta to
    both the session and the parent — under concurrency a parent-level
    watermark would blame one session's pass for another's bytes.
    """

    def __init__(self, parent: TieredStore, session_id: str):
        self._parent = parent
        self.session_id = session_id
        self._prefix = session_id + NS_SEP
        with parent._lock:
            self._stats = parent._ns_io(session_id)

    # -- naming ----------------------------------------------------------------
    def _q(self, name: str) -> str:
        return self._prefix + name

    def resolve_data_id(self, name: str) -> str:
        return self._q(name)

    # -- shared-resource views ---------------------------------------------------
    @property
    def stats(self) -> IOStats:
        return self._stats

    @property
    def backend(self):
        return self._parent.backend

    @property
    def parent(self) -> TieredStore:
        return self._parent

    @property
    def device(self) -> torch.device:
        return self._parent.device

    def as_tensor(self, value) -> torch.Tensor:
        return self._parent.as_tensor(value)

    @property
    def device_budget(self) -> int:
        b = self._parent._ns_budget.get(self.session_id)
        return self._parent.device_budget if b is None else b

    # -- core API ----------------------------------------------------------------
    def put(self, name, value, *, tier=DEVICE, data_id=None,
            readonly=False) -> None:
        self._parent.put(self._q(name), value, tier=tier,
                         data_id=self._q(data_id) if data_id else None,
                         readonly=readonly)

    def get(self, name):
        return self._parent.get(self._q(name))

    def promote(self, name):
        return self._parent.promote(self._q(name))

    def demote(self, name) -> None:
        self._parent.demote(self._q(name))

    def host_pin(self, name) -> None:
        self._parent.host_pin(self._q(name))

    def pin(self, name) -> None:
        self._parent.pin(self._q(name))

    def unpin(self, name) -> None:
        self._parent.unpin(self._q(name))

    def delete(self, name) -> None:
        self._parent.delete(self._q(name))

    def names(self):
        with self._parent._lock:
            return [n[len(self._prefix):] for n, e in
                    self._parent._entries.items()
                    if e.ns == self.session_id]

    def tier_of(self, name) -> str:
        return self._parent.tier_of(self._q(name))

    def device_bytes(self) -> int:
        with self._parent._lock:
            return self._parent._ns_device.get(self.session_id, 0)

    def host_bytes(self) -> int:
        with self._parent._lock:
            return sum(e.nbytes for e in self._parent._entries.values()
                       if e.ns == self.session_id and e.has_host)

    # -- checkpoint plumbing ------------------------------------------------------
    def sync_device_entries(self) -> None:
        self._parent.sync_device_entries(ns=self.session_id)

    def data_ids(self) -> list[str]:
        return self._parent.data_ids(ns=self.session_id)

    # -- budget hooks --------------------------------------------------------------
    def compress_acc_bytes(self) -> Optional[int]:
        """Fused-compress transient cap scaled to this session's device
        allotment (half of it, floored at 1 MiB), so a small-budget
        session chunks its compress pass instead of blowing past its
        share. None (no budget set) keeps the global default."""
        budget = self._parent._ns_budget.get(self.session_id)
        if budget is None:
            return None
        return max(budget // 2, 1 << 20)

    def account_read(self, nbytes: int, *, reads: int = 1) -> None:
        self._parent._acct(self.session_id, host_bytes_read=int(nbytes),
                           host_reads=reads)

    # -- streaming helpers ---------------------------------------------------------
    def begin_pass(self) -> int:
        with self._parent._lock:
            self._stats.add(passes=1)
            self._parent.stats.add(passes=1)
            return self._stats.host_bytes_read

    def end_pass(self, read_watermark: int) -> None:
        delta = self._stats.host_bytes_read - read_watermark
        self._stats.add(pass_bytes_read=delta)
        self._parent.stats.add(pass_bytes_read=delta)

    def prefetch(self, names: Iterable[str]) -> None:
        self._parent.prefetch([self._q(n) for n in names])

    def stream(self, names: Iterable[str], *, readahead: int = 2):
        names = list(names)
        for i, nm in enumerate(names):
            if readahead > 0:
                self.prefetch(names[i + 1:i + 1 + readahead])
            yield self.get(nm)

    def flush(self) -> None:
        self._parent.flush()

    def close(self) -> None:
        """Session end: drop the namespace (entries and backend pages).
        The shared backend stays open — the parent owns its lifecycle."""
        self._parent.drop_namespace(self.session_id)

    def reset_stats(self) -> IOStats:
        with self._parent._lock:
            old = self._stats
            self._stats = IOStats()
            self._parent._ns_stats[self.session_id] = self._stats
            return old
