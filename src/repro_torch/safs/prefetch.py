"""Multi-worker readahead scheduler — overlap SSD page reads with compute.

A copy of `repro.safs.prefetch`. The readers it runs fill the page cache
with `bytes` only: the worker threads make no CUDA call, and the copy of
a block to the card stays on the thread that asked for it.

FlashGraph's contribution (and this paper's §3.4.2/§3.4.3) is that SEM
performance lives or dies on overlapping disk with compute: while the
eigensolver contracts one group of subspace blocks, SAFS should already be
streaming the *next* groups' pages. This is the readahead scheduler
the paper's SAFS runs:

  * `schedule(data_ids)` enqueues whole-file batched page reads on a pool
    of `io_workers` daemon threads (each read is one `read_pages_batch`
    in the backend — coalesced preadv runs, not a python page loop);
    the queue is bounded by `depth` files — the readahead window. Ids
    past the window are *dropped*, not queued: the caller re-announces
    its access pattern as the walk advances (`core.stream.SubspacePass`
    announces the full pass up front, then re-offers the sliding window
    each block visit), so a dropped id is re-offered once the window has
    advanced. This
    bounds both queue memory and cache thrash from overly deep readahead;
  * workers fill the shared PageCache with clean lines only (prefetch is
    read-only — it never dirties a page);
  * the consumer calls `wait(data_id)` (the backend does, inside `load`)
    before using a file; the time actually blocked there is the
    *un*-overlapped remainder. A reader exception is captured and
    re-raised from `wait` (as `PrefetchError`), and a dead worker pool is
    detected rather than waited on forever — `wait` never hangs;
  * overlap accounting: `overlap_seconds() = busy_seconds - wait_seconds`
    where busy sums reader wall time across workers (it can exceed
    wall-clock when io_workers > 1) — the disk time hidden behind
    compute. `bench_safs.py` reports it and the derived overlap fraction.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional

from repro_torch.obs import trace
from repro_torch.safs.faults import OnRetry, is_transient


class PrefetchError(RuntimeError):
    """A background reader failed; re-raised at the consumer's wait()."""


class Prefetcher:
    """Multi-worker readahead scheduler over a shared PageCache.

    `reader(data_id) -> int` performs the actual cache fill for one file
    and returns bytes read from disk (the backend provides it; it skips
    pages already resident and batches the rest into vectored runs).

    io_workers: reader threads issuing concurrent fills (NVMe wants queue
        depth; one python thread per in-flight file works the GIL because
        preadv releases it).
    depth: readahead window — max files queued beyond the ones in flight.
    retries: whole-fill retries a worker attempts on a *transient* reader
        error before capturing it for `wait()` — a second defense above
        the page-level retry inside `PageFile.read_run` (which already
        absorbs transient preadv errors; this layer catches transient
        failures that escape it, e.g. around the fill's staging logic).
        Retries are counted (`stats()["read_retries"]`), emitted as
        `safs.retry` trace events and reported through `on_retry`.
    """

    def __init__(self, reader: Callable[[str], int], *,
                 io_workers: int = 2, depth: int = 8, retries: int = 1,
                 on_retry: Optional[OnRetry] = None):
        self._reader = reader
        self.retries = max(0, int(retries))
        self._on_retry = on_retry
        self.read_retries = 0
        self.io_workers = max(1, int(io_workers))
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Deque[str] = deque()
        self._done: Dict[str, threading.Event] = {}
        self._errors: Dict[str, BaseException] = {}
        self._tasks: Dict[str, Callable[[], int]] = {}
        self._shutdown = False
        self.busy_seconds = 0.0
        self.wait_seconds = 0.0
        self.bytes_prefetched = 0
        self.files_prefetched = 0
        self.files_dropped = 0      # offered past the readahead window
        self.tasks_run = 0          # generic pool tasks (scrub verifies)
        self.read_errors = 0
        self._threads = [threading.Thread(target=self._run, daemon=True,
                                          name=f"safs-ra-{i}")
                         for i in range(self.io_workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- workers
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._pending:
                    return
                data_id = self._pending.popleft()
                ev = self._done.get(data_id)
                task = self._tasks.pop(data_id, None)
            t0 = time.perf_counter()
            err: Optional[BaseException] = None
            n = 0
            for attempt in range(self.retries + 1):
                err = None
                try:
                    n = task() if task is not None else self._reader(data_id)
                    break
                except BaseException as e:  # captured, re-raised at wait()
                    err = e
                    if attempt >= self.retries or not is_transient(e):
                        break
                    with self._lock:
                        self.read_retries += 1
                    trace.event("safs.retry", site="prefetch", file=data_id,
                                attempt=attempt + 1,
                                error=type(e).__name__)
                    if self._on_retry is not None:
                        self._on_retry(site="prefetch", file=data_id,
                                       page=None, attempt=attempt + 1,
                                       error=e)
                    time.sleep(0.002 * (attempt + 1))
            dt = time.perf_counter() - t0
            with self._lock:
                self.busy_seconds += dt
                if err is not None:
                    self._errors[data_id] = err
                    self.read_errors += 1
                elif task is not None:
                    self.tasks_run += 1   # pool tasks don't skew the
                    #                       prefetch byte/file gauges
                else:
                    self.bytes_prefetched += n
                    self.files_prefetched += 1
            if ev is not None:
                ev.set()

    # ----------------------------------------------------------- frontend
    def schedule(self, data_ids) -> None:
        """Announce upcoming reads. Ids already in flight are ignored; ids
        past the `depth` readahead window are dropped (re-offer later)."""
        with self._cv:
            for d in data_ids:
                ev = self._done.get(d)
                if ev is not None and not ev.is_set():
                    continue             # already queued or in flight
                if len(self._pending) >= self.depth:
                    self.files_dropped += 1
                    continue
                self._errors.pop(d, None)
                self._done[d] = threading.Event()
                self._pending.append(d)
            self._cv.notify_all()

    def submit(self, key: str, fn: Callable[[], int]) -> bool:
        """Run an arbitrary zero-arg callable on the reader pool — the
        scrubber's paced verify passes share the prefetch workers instead
        of spawning their own. Bypasses the readahead window (the caller
        paces itself); join with `wait(key)`, which re-raises the task's
        exception as PrefetchError. Keys must not collide with data_ids
        (the scrubber prefixes "scrub::"). Returns False if `key` is
        already in flight."""
        with self._cv:
            ev = self._done.get(key)
            if ev is not None and not ev.is_set():
                return False
            self._errors.pop(key, None)
            self._tasks[key] = fn
            self._done[key] = threading.Event()
            self._pending.append(key)
            self._cv.notify_all()
        return True

    def wait(self, data_id: str, *, poll: float = 0.2) -> float:
        """Block until an in-flight prefetch of data_id completes (no-op if
        never scheduled). Returns (and accounts) the seconds blocked.

        Never hangs on a dead pool: if every worker thread has exited while
        the read is still unfinished, raises PrefetchError; a reader
        exception captured by the worker is chained and re-raised here.
        """
        with self._lock:
            ev = self._done.get(data_id)
        if ev is None:
            return 0.0
        # span only when a prefetch was actually in flight: its duration
        # is the *un*-overlapped disk time the consumer pays (§3.4.2)
        with trace.span("safs.prefetch_wait", file=data_id) as sp:
            t0 = time.perf_counter()
            while not ev.wait(poll):
                if not any(t.is_alive() for t in self._threads):
                    with self._lock:
                        self.wait_seconds += time.perf_counter() - t0
                        self._done.pop(data_id, None)
                    raise PrefetchError(
                        f"prefetch workers died with {data_id!r} unfinished")
            dt = time.perf_counter() - t0
            sp.set(seconds=dt)
            with self._lock:
                self.wait_seconds += dt
                self._done.pop(data_id, None)
                err = self._errors.pop(data_id, None)
        if err is not None:
            raise PrefetchError(f"prefetch of {data_id!r} failed") from err
        return dt

    def drain(self, *, ignore_errors: bool = True) -> None:
        """Wait for everything in flight (benchmark/flush epilogue)."""
        for d in list(self._done):
            try:
                self.wait(d)
            except PrefetchError:
                if not ignore_errors:
                    raise

    def overlap_seconds(self) -> float:
        """Disk-read time hidden behind foreground compute."""
        return max(0.0, self.busy_seconds - self.wait_seconds)

    def stats(self) -> dict:
        with self._lock:
            return {"busy_seconds": self.busy_seconds,
                    "wait_seconds": self.wait_seconds,
                    "overlap_seconds": self.overlap_seconds(),
                    "bytes_prefetched": self.bytes_prefetched,
                    "files_prefetched": self.files_prefetched,
                    "files_dropped": self.files_dropped,
                    "tasks_run": self.tasks_run,
                    "read_errors": self.read_errors,
                    "read_retries": self.read_retries,
                    "io_workers": self.io_workers,
                    "depth": self.depth}

    def close(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
