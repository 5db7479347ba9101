"""Storage backends for the slow tier — `ram` (host memory) or `safs`
(page files). Port of `repro.safs.backend`.

`TieredStore` owns policy (tier residency, LRU demotion, write-avoidance,
logical byte accounting); a `StorageBackend` owns where the slow-tier
bytes physically live. Both take and return tensors:

  * `RamBackend` keeps them as CPU tensors. When the store's device is
    CUDA they are *pinned* (page-locked) CPU tensors: every CGS2 pass
    pulls the older subspace blocks back across PCIe, and only pinned
    memory copies asynchronously at full rate. Copies go on PyTorch's
    current stream, so a later read of the same block is ordered after
    its write, and nothing reads those bytes on the host.
  * `SafsBackend` is the paper's layer: one PageFile per data_id under a
    root directory, fronted by a shared LRU `PageCache` with async
    write-behind demotions, and a multi-worker readahead `Prefetcher`.
    All disk reads go through the batched vectored engine
    (`PageFile.read_pages_batch`: one preadv per run of pages). Its
    `stats` count *actual disk traffic* (endurance), which is ≤ the
    logical tier traffic TieredStore counts whenever the page cache
    absorbs re-reads — the paper's Table-3 gap, measurable.

The SAFS backend reads the bytes of what it stores on the host (it
checksums them and splits them into pages), so `store` copies a CUDA
tensor into a pinned buffer and waits for that copy to finish before
it touches a byte. `load` assembles a block's pages into a new pinned
buffer when the store is on CUDA; the store's non-blocking copy to the
card reads it, and PyTorch's caching host allocator keeps the buffer
from reuse until that copy has run. The page cache, the write-behind
drain thread and the readahead workers see only `bytes`: they make no
CUDA call, and every copy to or from the card stays on the thread that
called the store, on its current stream.

Select per store:  `TieredStore(backend="safs", backend_opts={"root": dir})`
or pass a constructed backend instance. Throughput knobs, as in the
reference: `io_workers` (readahead pool size), `readahead_depth` (files
queued ahead), `write_behind` (async demotions; `wb_max_pages` bounds
the queue).
"""
from __future__ import annotations

import os
import shutil
import threading
import time
import urllib.parse
from typing import Dict, Iterable, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.tiered import IOStats, ns_of
from repro_torch.obs import trace
from repro_torch.safs.cache import PageCache, WriteBehind
from repro_torch.safs.faults import (DEFAULT_RETRY, FaultPlan,
                                     IntegrityCounters, RetryPolicy)
from repro_torch.safs.pagefile import PAGE_SIZE, PageFile, dtype_name
from repro_torch.safs.prefetch import PrefetchError, Prefetcher


@runtime_checkable
class StorageBackend(Protocol):
    """Mechanism interface for the slow tier (see module docstring)."""

    stats: IOStats

    def store(self, data_id: str, t: torch.Tensor) -> None: ...
    def load(self, data_id: str) -> torch.Tensor: ...
    def delete(self, data_id: str) -> None: ...
    def has(self, data_id: str) -> bool: ...
    def pin(self, data_id: str) -> None: ...
    def unpin(self, data_id: str) -> None: ...
    def prefetch(self, data_ids: Iterable[str]) -> None: ...
    def flush(self) -> None: ...
    def close(self) -> None: ...
    def stats_dict(self) -> dict: ...


def _pins(device) -> bool:
    return torch.device(device).type == "cuda"


# ------------------------------------------------------------ ns accounting
class _NsIO:
    """Per-namespace physical-I/O splits for a shared backend. Every byte
    the backend reads from / writes to the medium is attributed to the
    owning session (`ns_of(data_id)`; un-namespaced ids bucket under
    "_shared"), so per-namespace sums reconcile exactly against the
    backend's global IOStats."""

    SHARED = "_shared"

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, IOStats] = {}

    def add(self, data_id: str, **deltas: int) -> None:
        ns = ns_of(data_id) or self.SHARED
        with self._lock:
            st = self._stats.get(ns)
            if st is None:
                st = self._stats[ns] = IOStats()
        st.add(**deltas)

    def as_dict(self) -> Dict[str, dict]:
        with self._lock:
            return {ns: st.as_dict() for ns, st in self._stats.items()}


# ---------------------------------------------------------------- ram
class RamBackend:
    """Host-memory slow tier, byte-accounted. It pins its buffers exactly
    when the store it serves lives on a CUDA device."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.pin_memory = _pins(device)
        self.stats = IOStats()
        self.ns_io = _NsIO()
        self._bufs: Dict[str, torch.Tensor] = {}

    def store(self, data_id: str, t: torch.Tensor) -> None:
        if self.pin_memory:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
        else:
            buf = t.detach().to("cpu", copy=True)
        self._bufs[data_id] = buf
        nbytes = buf.numel() * buf.element_size()
        self.stats.add(host_bytes_written=nbytes, host_writes=1)
        self.ns_io.add(data_id, host_bytes_written=nbytes, host_writes=1)

    def load(self, data_id: str) -> torch.Tensor:
        t = self._bufs[data_id]
        nbytes = t.numel() * t.element_size()
        self.stats.add(host_bytes_read=nbytes, host_reads=1)
        self.ns_io.add(data_id, host_bytes_read=nbytes, host_reads=1)
        return t

    def delete(self, data_id: str) -> None:
        self._bufs.pop(data_id, None)

    def has(self, data_id: str) -> bool:
        return data_id in self._bufs

    def drop_namespace(self, session_id: str) -> None:
        # entries are deleted per-id by the store; nothing else to reclaim
        pass

    def pin(self, data_id: str) -> None:        # no page cache to pin in
        pass

    def unpin(self, data_id: str) -> None:
        pass

    def prefetch(self, data_ids) -> None:       # RAM is already "resident"
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._bufs.clear()

    def stats_dict(self) -> dict:
        """Merged snapshot, same shape as SafsBackend's (absent subsystems
        report None so consumers need no backend-type dispatch)."""
        return {"io": self.stats.as_dict(), "cache": None, "prefetch": None,
                "write_behind": None, "integrity": None,
                "namespaces": self.ns_io.as_dict()}


# ---------------------------------------------------------------- safs
class SafsBackend:
    """File-backed slow tier: PageFiles + shared page cache + readahead
    pool + async write-behind demotions. `device` is the device of the
    store it serves: loads come back pinned when it is CUDA."""

    def __init__(self, root: str, *, device: torch.device | str = "cpu",
                 page_size: int = PAGE_SIZE,
                 cache_bytes: int = 64 << 20, use_mmap: bool = False,
                 enable_prefetch: bool = True, io_workers: int = 2,
                 readahead_depth: int = 8, write_behind: bool = True,
                 wb_max_pages: int = 4096, pin_pages: bool = True,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 verify_reads: bool = True):
        self.root = root
        self.pin_memory = _pins(device)
        self.page_size = int(page_size)
        self.use_mmap = use_mmap
        self.enable_prefetch = enable_prefetch
        # verify_reads: CRC-check every page served off the medium against
        # its sidecar checksum block; detections quarantine the page and
        # raise CorruptPageError instead of serving rotten bytes upward
        self.verify_reads = bool(verify_reads)
        self.integrity = IntegrityCounters()
        self._quarantine: set = set()          # {(data_id, page)}
        # pin_pages=False degrades the cache to plain LRU (no §3.4.4
        # most-recent-matrix pin)
        self.pin_pages = bool(pin_pages)
        # faults: a seeded safs.faults.FaultPlan consulted at every I/O
        # boundary (tests script failure interleavings with it).
        # retry: transient-error policy applied to every preadv/pwritev
        # chunk and write-behind retire; retries are counted in
        # stats.retries and emitted as safs.retry trace events.
        self.faults = faults
        self.retry = retry
        os.makedirs(root, exist_ok=True)
        self._files: Dict[str, PageFile] = {}
        self._lock = threading.RLock()
        self.cache = PageCache(cache_bytes, self.page_size, self._writeback)
        self.stats = self.cache.stats      # shared: byte-exact disk traffic
        self.ns_io = _NsIO()               # per-session physical splits
        self.writebehind: Optional[WriteBehind] = None
        if write_behind:
            self.writebehind = WriteBehind(self._writeback_sync,
                                           max_pages=wb_max_pages,
                                           stats=self.stats,
                                           retry=retry, faults=faults,
                                           on_retry=self._count_retry)
        self.prefetcher = Prefetcher(self._fill, io_workers=io_workers,
                                     depth=readahead_depth,
                                     on_retry=self._count_retry)
        self._reopen()

    def _count_retry(self, **kw) -> None:
        """on_retry sink for every retry site (page files, write-behind,
        prefetch workers): one IOStats counter, so `stats_dict()["io"]
        ["retries"]` reconciles 1:1 with the `safs.retry` trace events."""
        self.stats.add(retries=1,
                       retry_sleep_ms=float(kw.get("slept_ms", 0.0)))

    def _note_corrupt(self, data_id: str, **kw) -> None:
        """on_corrupt sink: quarantine the page (the PageFile already
        counted crc_failures and emitted the safs.corrupt event)."""
        with self._lock:
            self._quarantine.add((data_id, int(kw.get("page") or 0)))

    def _open_pagefile(self, path: str, data_id: Optional[str] = None,
                       **kw) -> PageFile:
        if data_id is None:
            data_id = self._unpath(os.path.basename(path))
        return PageFile(path, use_mmap=self.use_mmap, faults=self.faults,
                        retry=self.retry, on_retry=self._count_retry,
                        verify=self.verify_reads, integrity=self.integrity,
                        on_corrupt=lambda **c: self._note_corrupt(data_id,
                                                                  **c),
                        **kw)

    # ------------------------------------------------------------- naming
    def _path(self, data_id: str) -> str:
        """Namespaced ids live one subdirectory down (`root/<sid>/`) so a
        session's page files are enumerable and reclaimable as a unit; the
        file NAME stays the quoted full id either way."""
        ns = ns_of(data_id)
        sub = self.root
        if ns:
            sub = os.path.join(self.root, urllib.parse.quote(ns, safe=""))
            os.makedirs(sub, exist_ok=True)
        return os.path.join(sub,
                            urllib.parse.quote(data_id, safe="") + ".pages")

    def _unpath(self, fname: str) -> str:
        return urllib.parse.unquote(fname[:-len(".pages")])

    def _reopen(self) -> None:
        """Adopt page files already in root (written by either package) —
        root itself plus one level of per-namespace subdirs."""
        dirs = [self.root]
        for d in sorted(os.listdir(self.root)):
            p = os.path.join(self.root, d)
            if os.path.isdir(p):
                dirs.append(p)
        for dirpath in dirs:
            for f in sorted(os.listdir(dirpath)):
                if f.endswith(".pages") and os.path.exists(
                        os.path.join(dirpath, f + ".meta")):
                    data_id = self._unpath(f)
                    self._files[data_id] = self._open_pagefile(
                        os.path.join(dirpath, f))

    def pagefile(self, data_id: str) -> PageFile:
        return self._files[data_id]

    def data_ids(self):
        with self._lock:
            return list(self._files)

    # ------------------------------------------------------------- plumbing
    def _writeback_sync(self, data_id: str, pages: Dict[int, bytes]) -> int:
        with self._lock:
            pf = self._files.get(data_id)
        if pf is None:      # deleted while the batch sat in the queue
            return 0
        written = pf.write_pages(pages)
        if written:
            # every physical write (sync evict/flush AND async retire)
            # funnels through here — the one choke point where the owning
            # session's split can be advanced in lockstep with the bytes
            self.ns_io.add(data_id, host_bytes_written=written,
                           host_writes=1)
        return written

    def _writeback(self, data_id: str, pages: Dict[int, bytes]) -> int:
        """Cache demotion sink: async via the write-behind queue when
        enabled (returns 0 — the queue accounts the bytes at retire),
        synchronous journaled write otherwise."""
        if self.writebehind is not None:
            return self.writebehind.submit(data_id, pages)
        return self._writeback_sync(data_id, pages)

    def _stage_page(self, data_id: str, i: int) -> Optional[bytes]:
        """A page's newest bytes short of the disk (never stale disk
        bytes). Freshness order: dirty cache line > write-behind queue >
        clean cache line — a *clean* line can be a stale disk fill that
        raced a concurrent evict-into-queue, so queued bytes beat it."""
        got = self.cache.get(data_id, i, with_dirty=True)
        # the emptiness probe is only safe *after* the cache lookup: an
        # eviction publishes its queue insert before the cache lock drops
        if got is not None:
            data, dirty = got
            if (dirty or self.writebehind is None
                    or self.writebehind.empty()):
                return data
            wb = self.writebehind.lookup(data_id, i)
            return data if wb is None else wb
        if self.writebehind is not None and not self.writebehind.empty():
            data = self.writebehind.lookup(data_id, i)
            if data is not None:
                self.cache.put(data_id, i, data, dirty=False)
            return data
        return None

    def _fill_read(self, data_id: str, nbytes: int) -> None:
        """Account one physical disk read: the shared cache IOStats plus
        the owning session's split (all three fill sites route here)."""
        self.cache.fill_bytes_read(nbytes)
        self.ns_io.add(data_id, host_bytes_read=nbytes, host_reads=1)

    def _fill(self, data_id: str) -> int:
        """Batched cache fill: every non-resident page of data_id, read as
        coalesced vectored runs (one preadv per run). Runs on the
        readahead workers; pread keeps it safe vs the consumer."""
        with trace.span("safs.fill", file=data_id) as sp:
            n = self._fill_inner(data_id)
            sp.set(bytes=n)
            return n

    def _fill_inner(self, data_id: str) -> int:
        with self._lock:
            pf = self._files.get(data_id)
        if pf is None:
            return 0
        # generation captured BEFORE the staleness probes: a submit that
        # precedes the capture is necessarily still queued when the probe
        # below runs (retire follows our disk read in any stale
        # interleaving), so the probe catches it; one that follows the
        # capture fails the post-insert compare.
        gen0 = (self.writebehind.generation(data_id)
                if self.writebehind is not None else 0)
        wb = (self.writebehind
              if self.writebehind is not None and not self.writebehind.empty()
              else None)
        missing = []
        for i in pf.page_indices():
            if self.cache.peek(data_id, i):
                continue
            if wb is not None and wb.lookup(data_id, i) is not None:
                continue               # disk copy is stale; skip
            missing.append(i)
        if not missing:
            return 0
        n = 0
        for i, data in pf.read_pages_batch(missing).items():
            n += len(data)
            if self.writebehind is None:
                self.cache.put(data_id, i, data, dirty=False)
                continue
            if self.writebehind.lookup(data_id, i) is not None:
                continue   # dirtied + evicted while we read: ours is stale
            # insert only if no evict for this file landed inside our
            # read window (the queue entry may have already RETIRED, so
            # only an unchanged submit generation proves the fill fresh);
            # the check-and-insert is atomic. A refused fill costs
            # nothing here: the consumer's load re-reads.
            self.cache.put_clean_if(
                data_id, i, data,
                lambda: self.writebehind.generation(data_id) == gen0)
        self._fill_read(data_id, n)
        return n

    # ------------------------------------------------------------- protocol
    def store(self, data_id: str, t: torch.Tensor) -> None:
        """Write `t` (any device) to the page file of `data_id` through
        the page cache. A CUDA tensor is copied into a pinned buffer and
        the copy is waited for before its bytes are split into pages."""
        if t.device.type != "cpu":
            host = torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=self.pin_memory)
            host.copy_(t)          # blocking: the D2H is complete on return
            t = host
        shape, name = tuple(t.shape), dtype_name(t.dtype)
        with self._lock:
            pf = self._files.get(data_id)
            mismatch = pf is not None and (pf.shape != shape
                                           or pf.dtype_name != name)
        if mismatch:
            # outside the lock: delete's discard waits out an in-flight
            # write-behind batch whose writer needs this lock (deadlock)
            self.delete(data_id)
        with self._lock:
            pf = self._files.get(data_id)
            if pf is None:
                pf = self._open_pagefile(self._path(data_id),
                                         page_size=self.page_size,
                                         shape=shape, dtype=name)
                self._files[data_id] = pf
        for i, payload in pf.split(t).items():
            self.cache.put(data_id, i, payload, dirty=True)

    def load(self, data_id: str) -> torch.Tensor:
        """The block of `data_id` as a new CPU tensor (pinned when the
        store is on CUDA), from the cache, the write-behind queue and one
        coalesced vectored read for the rest."""
        try:
            self.prefetcher.wait(data_id)
        except PrefetchError:
            pass    # fall through: the batched miss path below re-reads
        with self._lock:
            pf = self._files[data_id]
        # generation captured BEFORE the _stage_page probes — see _fill
        gen0 = (self.writebehind.generation(data_id)
                if self.writebehind is not None else 0)
        pages: Dict[int, bytes] = {}
        missing = []
        for i in pf.page_indices():
            data = self._stage_page(data_id, i)
            if data is None:
                missing.append(i)
            else:
                pages[i] = data
        if missing:       # one coalesced vectored read for all misses
            filled = pf.read_pages_batch(missing)
            self._fill_read(data_id, sum(len(d) for d in filled.values()))
            for i, data in filled.items():
                if self.writebehind is None:
                    self.cache.put(data_id, i, data, dirty=False)
                    pages[i] = data
                    continue
                wb = self.writebehind.lookup(data_id, i)
                if wb is not None:       # evicted into the queue mid-read
                    pages[i] = wb
                    continue
                if self.cache.put_clean_if(
                        data_id, i, data,
                        lambda: self.writebehind.generation(data_id)
                        == gen0):
                    pages[i] = data
                    continue
                # insert refused: an evict for this file raced our read
                # window. Serve the queue's bytes if the entry is still
                # pending, else re-read the page under its own generation
                # capture (a retire made the disk fresh; a further racing
                # evict re-fails the capture and loops). The fresh bytes
                # are left uncached.
                while True:
                    gen1 = self.writebehind.generation(data_id)
                    wb = self.writebehind.lookup(data_id, i)
                    if wb is not None:
                        pages[i] = wb
                        break
                    data = pf.read_pages_batch([i])[i]
                    self._fill_read(data_id, len(data))
                    if self.writebehind.generation(data_id) == gen1:
                        pages[i] = data
                        break
        return pf.assemble(pages, pin_memory=self.pin_memory)

    def delete(self, data_id: str) -> None:
        # discard first (it waits out an in-flight batch), THEN unmap the
        # file — so the drain thread never writes into a vanished id
        if self.writebehind is not None:
            self.writebehind.discard(data_id)
        with self._lock:
            pf = self._files.pop(data_id, None)
        self.cache.invalidate(data_id, drop_dirty=True)
        if pf is not None:
            pf.delete()

    def has(self, data_id: str) -> bool:
        with self._lock:
            return data_id in self._files

    def drop_namespace(self, session_id: str) -> None:
        """Reclaim a retired session: delete any of its page files still
        open (the store normally deletes them per-id first) and remove the
        now-empty per-namespace subdir. The session's physical IOStats
        split survives for post-mortem reporting."""
        with self._lock:
            ids = [d for d in self._files if ns_of(d) == session_id]
        for d in ids:
            self.delete(d)
        try:
            os.rmdir(os.path.join(self.root,
                                  urllib.parse.quote(session_id, safe="")))
        except OSError:
            pass        # never created, or a straggler file — leave it

    # ------------------------------------------------------------ integrity
    def scrub_file(self, data_id: str) -> list:
        """Verify one file's pages against its checksum block, straight
        off the medium (the cache is bypassed on purpose — scrub checks
        the bytes at rest). Detections are quarantined, counted and
        emitted as `safs.corrupt` events (site "scrub"); returns the
        corrupt page indices."""
        with self._lock:
            pf = self._files.get(data_id)
        if pf is None:
            return []
        bad = pf.verify_pages()
        self.integrity.add(pages_scrubbed=pf.n_pages,
                           scrub_corrupt=len(bad),
                           crc_failures=len(bad))
        for i in bad:
            trace.event("safs.corrupt", site="scrub", file=pf.path, page=i)
            with self._lock:
                self._quarantine.add((data_id, i))
        return bad

    def quarantined(self) -> list:
        """Pages whose corruption has been detected and not yet repaired,
        as sorted (data_id, page) pairs."""
        with self._lock:
            return sorted(self._quarantine)

    def repair_page(self, data_id: str, page: int, data: bytes) -> None:
        """Overwrite one corrupt page with verified replacement bytes
        (journaled, checksum block updated in the same commit) and lift
        its quarantine. The caller sources `data` from a verified copy."""
        with self._lock:
            pf = self._files[data_id]
        pf.write_pages({int(page): data})
        self.ns_io.add(data_id, host_bytes_written=len(data), host_writes=1)
        # drop any cached clean copy so the next read re-fills from the
        # repaired medium (dirty lines are newer than the copy — keep)
        self.cache.invalidate(data_id, drop_dirty=False)
        with self._lock:
            self._quarantine.discard((data_id, int(page)))
        self.integrity.add(pages_repaired=1)
        trace.event("safs.repair", file=data_id, page=int(page))

    def sweep_orphan_namespaces(self, *, live: Iterable[str] = (),
                                grace_s: float = 3600.0) -> list:
        """Startup GC for a root reused after a killed process:
        per-session page subdirs that belong to no live session and have
        not been touched for `grace_s` seconds are reclaimed (their files
        were adopted by `_reopen`, so `drop_namespace` both closes and
        deletes them). Age-gating spares a directory a concurrent process
        just created. Returns the swept session ids."""
        live = set(live)
        swept = []
        now = time.time()
        for d in sorted(os.listdir(self.root)):
            p = os.path.join(self.root, d)
            if not os.path.isdir(p):
                continue
            sid = urllib.parse.unquote(d)
            if sid in live or now - os.path.getmtime(p) < grace_s:
                continue
            self.drop_namespace(sid)
            if os.path.isdir(p):       # stragglers drop_namespace spared
                shutil.rmtree(p, ignore_errors=True)
            trace.event("safs.gc_namespace", namespace=sid)
            swept.append(sid)
        return swept

    def pin(self, data_id: str) -> None:
        if self.pin_pages:
            self.cache.pin(data_id)

    def unpin(self, data_id: str) -> None:
        self.cache.unpin(data_id)

    def prefetch(self, data_ids) -> None:
        """Queue readahead fills. Files whose every page is already cache-
        resident are skipped (O(1) per id off the cache's per-file
        counters), so a pass that announces its full block list up front
        does not burn the bounded window on no-op fills."""
        if not self.enable_prefetch:
            return
        todo = []
        for d in data_ids:
            with self._lock:
                pf = self._files.get(d)
            if pf is None:
                continue
            if self.cache.resident_pages(d) >= pf.n_pages:
                continue
            todo.append(d)
        if todo:
            self.prefetcher.schedule(todo)

    def flush(self, data_id: str | None = None) -> int:
        """Write back all dirty pages (journaled per file), drain the
        write-behind queue (durability barrier), and fsync. Returns bytes
        written to the medium (for the async sink: bytes the queue
        retired during this flush, prior demotions included)."""
        if self.writebehind is not None:
            before = self.writebehind.stats_dict()["bytes_retired"]
            self.cache.flush(data_id)
            self.writebehind.drain()
            n = self.writebehind.stats_dict()["bytes_retired"] - before
        else:
            n = self.cache.flush(data_id)
        with self._lock:
            files = ([self._files[data_id]] if data_id is not None
                     else list(self._files.values()))
        for pf in files:
            pf.sync()
        return n

    def stats_dict(self) -> dict:
        """One merged snapshot of every SAFS counter surface: physical
        disk traffic (`io`), cache residency, prefetcher overlap
        accounting, write-behind queue state, integrity counters and the
        per-namespace splits."""
        with self._lock:
            n_files = len(self._files)
        return {
            "io": self.stats.as_dict(),
            "cache": {"capacity_bytes": self.cache.capacity,
                      "page_size": self.page_size,
                      "resident_pages": self.cache.n_pages(),
                      "resident_bytes": self.cache.nbytes(),
                      "pinned_files": len(self.cache.pinned()),
                      "n_files": n_files},
            "prefetch": self.prefetcher.stats(),
            "write_behind": (self.writebehind.stats_dict()
                             if self.writebehind is not None else None),
            "integrity": {**self.integrity.as_dict(),
                          "quarantined": len(self._quarantine)},
            "namespaces": self.ns_io.as_dict(),
        }

    def close(self) -> None:
        try:
            self.flush()
        finally:
            # a flush failure (WriteBehindError) must still propagate, but
            # never leak worker threads or page-file fds
            self.prefetcher.close()
            if self.writebehind is not None:
                self.writebehind.close()
            with self._lock:
                for pf in self._files.values():
                    pf.close()
                self._files.clear()


def make_backend(spec, *, device: torch.device | str = "cpu", **opts):
    """Factory: 'ram' (no opts; pins when `device` is CUDA), 'safs' (opts:
    root, page_size, cache_bytes, use_mmap, enable_prefetch, io_workers,
    readahead_depth, write_behind, wb_max_pages, pin_pages, faults,
    retry, verify_reads; loads come back pinned when `device` is CUDA),
    or pass through an already constructed backend."""
    if not isinstance(spec, str):
        return spec
    if spec == "ram":
        return RamBackend(device, **opts)
    if spec == "safs":
        if "root" not in opts:
            import atexit
            import tempfile
            opts["root"] = tempfile.mkdtemp(prefix="safs_")
            # an auto-created root is ours to reclaim; long-lived processes
            # creating many stores should pass `root` and call close()
            atexit.register(shutil.rmtree, opts["root"], ignore_errors=True)
        return SafsBackend(device=device, **opts)
    raise ValueError(f"unknown storage backend {spec!r}")
