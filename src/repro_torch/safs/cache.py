"""SAFS page cache — LRU over (data_id, page) with most-recent-block pinning.

A copy of `repro.safs.cache` over the port's `core.tiered.IOStats`: page
payloads are `bytes`, so nothing here touches torch, and the write-behind
drain thread makes no CUDA call.

The paper's SAFS keeps a page cache in front of the SSD array and FlashEigen
pins the most recent dense matrix in it (§3.4.4): the newest subspace block
is about to be re-read by reorthogonalization, so evicting it would double
the read traffic, and re-writing a clean page would burn write endurance.
Both policies live here:

  * keys are (data_id, page_index) — a transposed view shares its parent's
    data_id (§3.4.4 "data identifiers"), so its pages hit the same lines;
  * eviction is LRU over unpinned pages; a dirty page is written back to
    its PageFile on eviction (write-back, not write-through — this is where
    the 145 TB-read vs 4 TB-write asymmetry of Table 3 comes from);
  * stats are byte-exact and mirror `core.tiered.IOStats` field names so
    the two accounting layers compose: `host_bytes_read/written` count real
    disk traffic (endurance), `cache_hits/misses` count page lookups.

Demotions are *asynchronous* behind `WriteBehind` (§3.4's async I/O made
concrete): an eviction hands its dirty pages to a bounded queue and
returns immediately; a drain thread batches the queue per file and pushes
each batch through the journaled `PageFile.write_pages`, so crash
consistency is inherited — a page is *acked* (durable) the moment its
batch's journal commits, and a kill mid-patch is replayed on reopen.
Until a page retires, `WriteBehind.lookup` serves its newest bytes to
cache-miss reads (the queue doubles as a victim buffer), so readers can
never observe the stale on-disk copy of an evicted-but-unwritten page.

Thread safety: one lock around the table — the prefetch thread inserts
pages while the consumer thread reads them.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.tiered import IOStats
from repro_torch.obs import trace
from repro_torch.safs.faults import (DEFAULT_RETRY, FaultPlan, OnRetry,
                               RetryPolicy, with_retries)

Key = Tuple[str, int]


class _Line:
    __slots__ = ("data", "dirty")

    def __init__(self, data: bytes, dirty: bool):
        self.data = data
        self.dirty = dirty


class PageCache:
    """Byte-budgeted LRU page cache with per-data_id pinning.

    `writer(data_id, {page: bytes}) -> bytes_written` is the write-back
    sink (the owning backend flushes through its PageFile journal);
    evictions of dirty pages call it one page at a time, explicit
    `flush()` batches all dirty pages of a file into one journal commit.
    """

    def __init__(self, capacity_bytes: int, page_size: int,
                 writer: Callable[[str, Dict[int, bytes]], int]):
        self.capacity = int(capacity_bytes)
        self.page_size = int(page_size)
        self._writer = writer
        self._lines: "OrderedDict[Key, _Line]" = OrderedDict()
        self._pinned: set[str] = set()
        self._per_file: Dict[str, int] = {}   # resident pages per data_id
        self.stats = IOStats()
        self._lock = threading.RLock()

    # ------------------------------------------------------------- sizing
    def nbytes(self) -> int:
        with self._lock:
            return len(self._lines) * self.page_size

    def n_pages(self) -> int:
        return len(self._lines)

    def _evict_for(self, incoming_pages: int) -> None:
        # caller holds the lock
        budget = self.capacity - incoming_pages * self.page_size
        if len(self._lines) * self.page_size <= budget:
            return
        # Evict past the budget by a slack of ~capacity/8 (whole pages; 0 on
        # tiny caches) and batch the dirty write-backs per file: a streaming
        # store then pays one journal commit (with its fsyncs) per slack
        # chunk instead of one per evicted page.
        slack = (self.capacity // 8 // self.page_size) * self.page_size
        target = max(0, budget - slack)
        victims = []
        for key in self._lines:                     # oldest first
            if (len(self._lines) - len(victims)) * self.page_size <= target:
                break
            if key[0] not in self._pinned:
                victims.append(key)
        if not victims:
            return
        with trace.span("safs.evict", pages=len(victims)) as sp:
            by_file: Dict[str, Dict[int, bytes]] = {}
            dirty = 0
            for key in victims:
                line = self._lines.pop(key)
                self._dec_per_file(key[0])
                if line.dirty:
                    dirty += 1
                    by_file.setdefault(key[0], {})[key[1]] = line.data
            sp.set(dirty_pages=dirty)
            for d, pages in by_file.items():
                n = self._writer(d, pages)
                if n:   # an async (write-behind) sink returns 0 at submit
                    self.stats.add(host_bytes_written=n, host_writes=1)

    # ------------------------------------------------------------ lookups
    def get(self, data_id: str, page: int, *, with_dirty: bool = False):
        """Hit → payload (LRU-touched); miss → None (caller reads disk).
        with_dirty=True returns (payload, dirty) instead — the backend
        uses the flag to rank a clean line against write-behind bytes."""
        with self._lock:
            line = self._lines.get((data_id, page))
            if line is None:
                self.stats.add(cache_misses=1)
                return None
            self._lines.move_to_end((data_id, page))
            self.stats.add(cache_hits=1)
            return (line.data, line.dirty) if with_dirty else line.data

    def peek(self, data_id: str, page: int) -> bool:
        """Residency probe without touching LRU order or stats (prefetch)."""
        with self._lock:
            return (data_id, page) in self._lines

    def resident_pages(self, data_id: str) -> int:
        """How many of a file's pages are resident — O(1) off a running
        per-file counter (the backend's prefetch uses it to skip
        fully-cached files instead of probing every page)."""
        with self._lock:
            return self._per_file.get(data_id, 0)

    def _dec_per_file(self, data_id: str) -> None:
        # caller holds the lock
        left = self._per_file.get(data_id, 0) - 1
        if left > 0:
            self._per_file[data_id] = left
        else:
            self._per_file.pop(data_id, None)

    def put_clean_if(self, data_id: str, page: int, data: bytes,
                     fresh) -> bool:
        """Insert a clean fill only if `fresh()` — evaluated under the
        cache lock — confirms no eviction raced the disk read that
        produced it (the backend passes a write-behind generation
        compare). Returns False, inserting nothing, on a failed check.

        The atomicity matters: an insert-then-verify would publish the
        possibly-stale line for the verify's duration, and a concurrent
        reader could be served it while the write-behind queue no longer
        shadows the page (its batch already retired). Evictions bump the
        generation while still holding this lock, so check-then-insert
        under the same lock leaves no window: a racing evict is either
        fully ordered before (check fails) or after (its dirty line was
        present during our insert, and the no-clean-clobber rule in
        `put` already kept our bytes out)."""
        with self._lock:          # RLock: the nested put re-enters
            if not fresh():
                return False
            self.put(data_id, page, data, dirty=False)
            return True

    def put(self, data_id: str, page: int, data: bytes, *,
            dirty: bool) -> None:
        """Insert/overwrite a line. dirty=False for fill-on-read/prefetch,
        dirty=True for stores (write-back deferred to eviction/flush)."""
        with self._lock:
            key = (data_id, page)
            if key not in self._lines:
                self._evict_for(1)
                self._lines[key] = _Line(data, dirty)
                self._per_file[data_id] = self._per_file.get(data_id, 0) + 1
            else:
                line = self._lines[key]
                if dirty:
                    line.data = data
                    line.dirty = True
                # a clean fill never clobbers a resident line: the line may
                # hold newer dirty bytes than the disk copy the (prefetch)
                # filler read between its peek and this put
            self._lines.move_to_end(key)

    # ------------------------------------------------------------ pinning
    def pin(self, data_id: str) -> None:
        with self._lock:
            self._pinned.add(data_id)

    def unpin(self, data_id: str) -> None:
        with self._lock:
            self._pinned.discard(data_id)

    def pinned(self) -> set:
        with self._lock:
            return set(self._pinned)

    # ------------------------------------------------------- flush/forget
    def flush(self, data_id: str | None = None) -> int:
        """Write back dirty pages (all files, or one), batched per file so
        each file gets a single journal commit. Returns bytes written."""
        with self._lock:
            by_file: Dict[str, Dict[int, bytes]] = {}
            for (d, p), line in self._lines.items():
                if line.dirty and (data_id is None or d == data_id):
                    by_file.setdefault(d, {})[p] = line.data
            total = 0
            for d, pages in by_file.items():
                n = self._writer(d, pages)
                if n:
                    self.stats.add(host_writes=1)
                total += n
                for p in pages:
                    self._lines[(d, p)].dirty = False
            self.stats.add(host_bytes_written=total)
            return total

    def invalidate(self, data_id: str, *, drop_dirty: bool = False) -> None:
        """Forget a file's pages (on delete). Dirty pages are dropped only
        when drop_dirty (the file itself is going away)."""
        with self._lock:
            for key in [k for k in self._lines if k[0] == data_id]:
                line = self._lines[key]
                if line.dirty and not drop_dirty:
                    n = self._writer(data_id, {key[1]: line.data})
                    if n:
                        self.stats.add(host_bytes_written=n, host_writes=1)
                del self._lines[key]
                self._dec_per_file(data_id)
            self._pinned.discard(data_id)

    def fill_bytes_read(self, n: int) -> None:
        """Account a disk read that filled this cache (backend helper)."""
        self.stats.add(host_bytes_read=n, host_reads=1)


# ---------------------------------------------------------------------------
# Async write-behind queue for cache demotions
# ---------------------------------------------------------------------------
class WriteBehindError(RuntimeError):
    """A background write-back failed; re-raised at submit/drain."""


class WriteBehind:
    """Bounded async write-behind queue over a journaled page writer.

    `writer(data_id, {page: bytes}) -> bytes_written` is the *synchronous*
    journaled sink (`PageFile.write_pages` via the backend). Eviction paths
    call `submit` and return immediately; one drain thread pops the oldest
    file's accumulated pages as a single batch → one journal commit per
    batch instead of one per evicted page, and in submit order per file
    (a re-dirtied page resubmitted later can never be overtaken by its
    older bytes).

    Durability ("ack") semantics: a page is acked once the journal of the
    batch containing it has committed — from then on a crash is redone on
    reopen (`PageFile._recover`), so every acked page survives a kill
    mid-demotion. Pages still queued at the kill are *not* acked; callers
    needing a durability barrier call `drain()` (backend `flush`/`close`
    do). Until its batch retires, a page's newest bytes are served by
    `lookup` — the queue is also the victim buffer for evicted-but-
    unwritten pages.

    `stats` (an IOStats, usually the PageCache's) is advanced by the drain
    thread with the *actual* bytes the journaled writer reported, so
    physical-endurance accounting stays byte-exact even when queue merging
    collapses a resubmitted page into one write.

    Fault tolerance: each retire is retried with backoff on transient
    errors per `retry` (site "wb.retire"; an attached `FaultPlan` is
    consulted there too). Exhaustion raises a typed `SafsIOError`
    carrying file/attempt context, which is captured like any writer
    failure and surfaces at the next `drain()` as `WriteBehindError`
    (the SafsIOError is its __cause__). Retries are counted in
    `stats_dict()["retries"]` and through `on_retry`.
    """

    def __init__(self, writer: Callable[[str, Dict[int, bytes]], int], *,
                 max_pages: int = 4096, stats: Optional["IOStats"] = None,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 faults: Optional[FaultPlan] = None,
                 on_retry: Optional[OnRetry] = None):
        self._writer = writer
        self.max_pages = max(1, int(max_pages))
        self._stats = stats
        self._retry = retry
        self._faults = faults
        self._on_retry = on_retry
        self.retries = 0               # retire attempts that were retried
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: "OrderedDict[str, Dict[int, bytes]]" = OrderedDict()
        self._inflight: Optional[Tuple[str, Dict[int, bytes]]] = None
        self._gen: Dict[str, int] = {}   # per-file submit counter (stale-
        #                                  fill guard: see generation())
        self._n_pending = 0            # pages queued (excl. in flight)
        self._error: Optional[BaseException] = None
        self._error_id: Optional[str] = None   # file the error belongs to
        self._shutdown = False
        self.pages_retired = 0
        self.bytes_retired = 0
        self.batches_retired = 0
        self.max_depth_pages = 0       # high-water queue depth (bench stat)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="safs-writebehind")
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            with self._cv:
                # pause while a captured error awaits drain(): retrying a
                # persistently failing writer would spin, and the failed
                # batch is back in _pending so lookup still serves it
                while ((not self._pending or self._error is not None)
                       and not self._shutdown):
                    self._cv.wait()
                if self._shutdown and (not self._pending
                                       or self._error is not None):
                    return
                data_id, pages = self._pending.popitem(last=False)
                self._n_pending -= len(pages)
                self._inflight = (data_id, pages)
                self._cv.notify_all()          # submit backpressure
            err: Optional[BaseException] = None
            written = 0
            try:
                with trace.span("safs.wb.retire", file=data_id,
                                pages=len(pages)) as sp:
                    written = self._retire(data_id, pages)
                    sp.set(bytes=written)
            except BaseException as e:
                err = e
            with self._cv:
                self._inflight = None
                if err is None:
                    self.pages_retired += len(pages)
                    self.bytes_retired += written
                    self.batches_retired += 1
                    if self._stats is not None and written:
                        self._stats.add(host_bytes_written=written,
                                        host_writes=1)
                else:
                    if self._error is None:
                        self._error, self._error_id = err, data_id
                    # re-queue the failed batch: the queue may hold the
                    # only copy of these bytes, and dropping them would
                    # let readers see the stale disk copy. A page
                    # resubmitted since the pop is newer — keep it.
                    batch = self._pending.setdefault(data_id, {})
                    for p, data in pages.items():
                        if p not in batch:
                            batch[p] = data
                            self._n_pending += 1
                self._cv.notify_all()

    def _retire(self, data_id: str, pages: Dict[int, bytes]) -> int:
        """One journaled batch write, retried on transient errors. The
        fault-plan check ("wb.retire") runs inside the retry unit so an
        injected transient fault is absorbed, while an injected CrashPoint
        propagates (non-transient) and is captured as the queue error."""

        def attempt() -> int:
            if self._faults is not None:
                self._faults.check("wb.retire", file=data_id,
                                   pages=len(pages))
            return self._writer(data_id, pages)

        return with_retries(attempt, self._retry, site="wb.retire",
                            file=data_id, on_retry=self._count_retry)

    def _count_retry(self, **kw) -> None:
        with self._lock:
            self.retries += 1
        if self._on_retry is not None:
            self._on_retry(**kw)

    # ----------------------------------------------------------- frontend
    def _raise_pending_error(self) -> None:
        # caller holds the lock
        if self._error is not None:
            err, self._error, self._error_id = self._error, None, None
            self._cv.notify_all()      # un-pause the worker (it retries)
            raise WriteBehindError("async write-back failed") from err

    def submit(self, data_id: str, pages: Dict[int, bytes]) -> int:
        """Queue dirty pages (newest bytes win per page). Blocks only when
        the queue is at max_pages (backpressure). Returns 0 — the actual
        write is accounted by the drain thread when the batch retires.

        Never raises a captured write-back failure: submit runs inside
        eviction paths (including on prefetch workers, where a raise would
        be mistaken for a read error and the pending error lost) — the
        durability barrier that surfaces failures is `drain()`. While an
        error is pending the worker is paused, so backpressure is waived
        (the queue may overshoot max_pages) — blocking here would deadlock
        against the very flush that clears the error."""
        if not pages:
            return 0
        with self._cv:
            while (self._n_pending >= self.max_pages
                   and self._error is None and not self._shutdown):
                self._cv.wait()
            batch = self._pending.setdefault(data_id, {})
            for p, data in pages.items():
                if p not in batch:
                    self._n_pending += 1
                batch[p] = data
            self._gen[data_id] = self._gen.get(data_id, 0) + 1
            self.max_depth_pages = max(self.max_depth_pages,
                                       self.pending_pages_locked())
            self._cv.notify_all()
        return 0

    def pending_pages_locked(self) -> int:
        # caller holds the lock
        n = self._n_pending
        if self._inflight is not None:
            n += len(self._inflight[1])
        return n

    def pending_pages(self) -> int:
        with self._lock:
            return self.pending_pages_locked()

    def empty(self) -> bool:
        """Lock-free emptiness probe for hot read paths. Safe as a
        lookup-skip: an eviction publishes its queue insert *before*
        releasing the page-cache lock, so any reader whose cache lookup
        already missed is guaranteed to observe a non-empty queue here;
        and a just-retired batch is on disk, so reading disk is fresh."""
        return self._n_pending == 0 and self._inflight is None

    def generation(self, data_id: str) -> int:
        """Monotonic count of submits for a file — the stale-fill guard.

        A disk reader that captures the generation *before* reading and
        observes it unchanged *after* inserting its fill into the cache
        knows no eviction raced the read: `lookup` alone cannot prove
        that, because a batch that was submitted AND retired inside the
        window has already left the queue (the disk then holds newer
        bytes than the fill). `discard` drops the counter; the reset
        reads as a generation change, which errs toward dropping a
        (possibly fine) fill — the safe direction.
        """
        with self._lock:
            return self._gen.get(data_id, 0)

    def lookup(self, data_id: str, page: int) -> Optional[bytes]:
        """Newest not-yet-retired bytes for a page, or None. Pending beats
        in-flight (a resubmission after the batch was popped is newer)."""
        with self._lock:
            batch = self._pending.get(data_id)
            if batch is not None and page in batch:
                return batch[page]
            if self._inflight is not None and self._inflight[0] == data_id:
                return self._inflight[1].get(page)
            return None

    def discard(self, data_id: str) -> None:
        """Drop queued pages of a file about to be deleted; waits out an
        in-flight batch so the writer never races the unlink. An error
        captured for this file dies with it — it must not pause the
        worker or fail a later unrelated drain."""
        with self._cv:
            self._gen.pop(data_id, None)
            while True:     # an in-flight batch that fails re-queues itself
                batch = self._pending.pop(data_id, None)
                if batch:
                    self._n_pending -= len(batch)
                if self._error_id == data_id:
                    self._error, self._error_id = None, None
                self._cv.notify_all()
                if (self._inflight is None
                        or self._inflight[0] != data_id):
                    return
                self._cv.wait()

    def drain(self) -> None:
        """Durability barrier: block until the queue is empty and the last
        batch retired; re-raise any captured write-back failure. A failed
        batch stays queued (still served by lookup) and is retried once
        the error has been surfaced here."""
        with self._cv:
            while self._pending or self._inflight is not None:
                if self._error is not None:
                    break
                self._cv.wait()
            self._raise_pending_error()

    def stats_dict(self) -> dict:
        with self._lock:
            return {"pages_retired": self.pages_retired,
                    "bytes_retired": self.bytes_retired,
                    "batches_retired": self.batches_retired,
                    "max_depth_pages": self.max_depth_pages,
                    "pending_pages": self.pending_pages_locked(),
                    "retries": self.retries}

    def close(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout=10)
