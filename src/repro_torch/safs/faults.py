"""Deterministic fault injection + bounded retry for the SAFS I/O path.

A copy of `repro.safs.faults` (pure Python; the port keeps its own copy
so that it imports nothing of the JAX package). The `ckpt.save` and
`solve.restart` sites below belong to the checkpoint layer, which the
port does not have yet (ROADMAP.md queue 1 item 4).

A four-hour single-machine solve (the paper's headline run, §4) WILL see
transient NVMe errors, preemptions and kills — FlashGraph-class SSD arrays
make flaky I/O a when, not an if. This module supplies both halves of the
robustness story:

  * `FaultPlan` — a seeded, site-keyed schedule of injected faults
    (transient `EIO`, short reads, latency spikes, hard `CrashPoint`s)
    that the SAFS layer consults at its real I/O boundaries, so any
    failure interleaving is reproducible in tests. Sites are the actual
    syscall/commit points of `pagefile.py` / `cache.py`:

      pread              each vectored preadv chunk (`PageFile.read_run`)
      pwritev            each vectored pwritev chunk (`_pwritev_runs`)
      journal.precommit  journal written, commit trailer NOT yet durable
      journal.commit     journal committed, in-place patch not yet started
      wb.retire          write-behind drain thread, before the journaled
                         batch write (`WriteBehind._run`)
      ckpt.save          between a checkpoint's page snapshot and its
                         state-manifest commit (`ckpt.solver`)
      solve.restart      the solver's restart boundary (checkpoint hook)
      prefetch           a readahead worker's whole-file fill

  * `RetryPolicy` / `with_retries` — bounded retry with exponential
    backoff + jitter on *transient* errors (OSError errno in
    `TRANSIENT_ERRNOS`). Exhaustion raises `SafsIOError` carrying
    file/page/attempt context; `CrashPoint` and `SafsIOError` itself are
    never retried. Every retry emits a `safs.retry` event through the
    `repro_torch.obs` tracer and hits the caller's `on_retry` hook (the backend
    counts them into `IOStats.retries`), so retry totals reconcile
    between `stats_dict()` and the trace.

Wiring: construct `SafsBackend(root, faults=plan, retry=policy)` — the
plan and policy are threaded into every `PageFile`, the write-behind
drain thread and the prefetch workers; the solver-side checkpointer
discovers the same plan via `store.backend.faults` for the `ckpt.save` /
`solve.restart` sites. One plan therefore scripts a whole solve's
failure schedule.
"""
from __future__ import annotations

import dataclasses
import errno
import fnmatch
import os
import random
import threading
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.obs import trace

TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EINTR, errno.ETIMEDOUT, errno.EBUSY,
})


class CrashPoint(RuntimeError):
    """A simulated mid-operation kill (test/crash-hook injection). Never
    retried: the on-disk state it leaves behind is exactly what a real
    kill leaves, and recovery happens on reopen, not in-line."""


class TransientIOError(OSError):
    """An injected transient I/O failure (errno EIO) — retryable."""

    def __init__(self, message: str):
        super().__init__(errno.EIO, message)


class SafsIOError(OSError):
    """A SAFS I/O operation failed permanently (retries exhausted, or a
    non-transient error wrapped with context). Carries the failing site,
    file, page and attempt count for post-mortems."""

    def __init__(self, message: str, *, site: str, file: str | None = None,
                 page: int | None = None, attempts: int = 1):
        super().__init__(errno.EIO, message)
        self.site = site
        self.file = file
        self.page = page
        self.attempts = attempts

    def __str__(self) -> str:  # keep the context visible in logs/asserts
        loc = f" file={self.file!r}" if self.file else ""
        if self.page is not None:
            loc += f" page={self.page}"
        return (f"{self.args[1]} [site={self.site}{loc} "
                f"attempts={self.attempts}]")


class CorruptPageError(SafsIOError):
    """A page's bytes failed checksum verification and re-reads did not
    clear the mismatch: silent corruption (media bit-rot, torn write, bad
    transfer). Never retried by `with_retries` — the data is wrong, not
    slow; repair happens from a verified checkpoint or the solve fails
    typed instead of converging on garbage."""

    def __init__(self, *, site: str, file: str | None = None,
                 page: int | None = None):
        super().__init__("page checksum mismatch", site=site, file=file,
                         page=page, attempts=1)


class IntegrityCounters:
    """Thread-safe integrity counter block shared by every PageFile of a
    backend (and its scrubber). Surfaces as `stats_dict()["integrity"]`;
    `crc_failures` reconciles 1:1 with `safs.corrupt` trace events and
    `scrub_passes` with `safs.scrub` events."""

    FIELDS = ("pages_verified", "crc_retries", "crc_failures",
              "scrub_passes", "pages_scrubbed", "scrub_corrupt",
              "pages_repaired")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self.FIELDS}

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                self._c[k] = self._c.get(k, 0) + int(v)

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._c)


def is_transient(err: BaseException) -> bool:
    """True for errors worth retrying: OSError with a transient errno.
    `SafsIOError` (already-exhausted retries) and `CrashPoint` are final."""
    if isinstance(err, SafsIOError):
        return False
    return isinstance(err, OSError) and err.errno in TRANSIENT_ERRNOS


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter (transient errors
    only). max_attempts counts the first try: max_attempts=1 disables
    retrying; the default absorbs 3 consecutive transient failures.
    `max_total_sleep` caps the *cumulative* backoff per operation — a
    latency-spike fault storm cannot stack unbounded exponential sleeps
    on the write-behind drain thread; once the budget is spent the
    remaining attempts run back-to-back."""
    max_attempts: int = 4
    base_delay: float = 0.002      # seconds before the first retry
    multiplier: float = 2.0
    max_delay: float = 0.25
    jitter: float = 0.5            # +[0, jitter) fraction on each delay
    max_total_sleep: float = 1.0   # cumulative sleep cap per operation


DEFAULT_RETRY = RetryPolicy()

OnRetry = Callable[..., None]


def with_retries(fn: Callable[[], object], policy: Optional[RetryPolicy], *,
                 site: str, file: str | None = None, page: int | None = None,
                 on_retry: Optional[OnRetry] = None):
    """Run `fn`, retrying transient failures per `policy` (None = single
    attempt). Each retry emits a `safs.retry` trace event and calls
    `on_retry(site=, file=, page=, attempt=, error=, slept_ms=)`.
    Cumulative backoff is capped at `policy.max_total_sleep` per call.
    Exhaustion raises `SafsIOError` (chained); non-transient errors
    propagate untouched."""
    if policy is None:
        return fn()
    delay = policy.base_delay
    attempt = 1
    slept = 0.0
    while True:
        try:
            return fn()
        except BaseException as e:
            if not is_transient(e):
                raise
            if attempt >= policy.max_attempts:
                raise SafsIOError(
                    f"I/O failed after {attempt} attempts: {e}",
                    site=site, file=file, page=page, attempts=attempt) from e
            pause = (min(delay, policy.max_delay)
                     * (1.0 + policy.jitter * random.random()))
            pause = max(0.0, min(pause, policy.max_total_sleep - slept))
            trace.event("safs.retry", site=site, file=file, page=page,
                        attempt=attempt, error=type(e).__name__)
            if on_retry is not None:
                on_retry(site=site, file=file, page=page, attempt=attempt,
                         error=e, slept_ms=pause * 1e3)
            time.sleep(pause)
            slept += pause
            delay *= policy.multiplier
            attempt += 1


# --------------------------------------------------------------------------
# Seeded fault schedules
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FaultRule:
    """One scheduled fault. Fires on hits `at .. at+times-1` of matching
    sites (1-based, counted per rule across all matching sites), or with
    probability `prob` per hit when `prob` is set (seeded via the plan).

    site: exact site name or fnmatch glob ("journal.*").
    kind: "eio" (raise TransientIOError) | "crash" (raise CrashPoint) |
          "latency" (sleep `delay` seconds) | "short_read" (truncate the
          first preadv of the chunk — exercises the short-read loop) |
          "bitflip" (silently corrupt one bit of the first page moving
          through the site: on "pread" the corruption is in the transfer,
          on "pwritev" it lands on the medium) | "torn_page" (on
          "pwritev": persist only the first half of the first page — a
          power-cut torn write). bitflip/torn_page never raise at the
          fault site; they exist to prove the checksum layer catches what
          the syscalls cannot.
    file_glob: optionally restrict to basenames matching this glob.
    """
    site: str
    kind: str
    at: int = 1
    times: Optional[int] = 1       # None = every matching hit from `at` on
    prob: Optional[float] = None
    delay: float = 0.005           # latency-spike seconds
    file_glob: Optional[str] = None

    def __post_init__(self):
        if self.kind not in ("eio", "crash", "latency", "short_read",
                             "bitflip", "torn_page"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A deterministic, thread-safe schedule of injected faults.

    The I/O layer calls `check(site, **ctx)` at each boundary; the plan
    counts the hit, fires any matching rules (raising / sleeping /
    returning the "short_read" action), and logs what fired so tests can
    assert the schedule actually executed (`fired`, `hits`)."""

    def __init__(self, rules: Sequence[FaultRule] = (), *, seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self._rng = random.Random(seed)
        self._hits: dict = {}               # site -> hit count
        self._rule_hits = [0] * len(self.rules)
        self._fired: List[dict] = []
        self._lock = threading.Lock()

    def check(self, site: str, **ctx) -> Optional[str]:
        """Consult the plan at an I/O boundary. Raises (eio/crash), sleeps
        (latency) or returns "short_read"; returns None when nothing
        fires. ctx (file=..., page=..., step=...) is recorded with the
        firing and matched against `file_glob`."""
        action: Optional[str] = None
        to_sleep = 0.0
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            for idx, r in enumerate(self.rules):
                if not fnmatch.fnmatchcase(site, r.site):
                    continue
                if r.file_glob is not None and not fnmatch.fnmatch(
                        os.path.basename(str(ctx.get("file", ""))),
                        r.file_glob):
                    continue
                self._rule_hits[idx] += 1
                k = self._rule_hits[idx]
                if r.prob is not None:
                    fire = self._rng.random() < r.prob
                else:
                    fire = k >= r.at and (r.times is None
                                          or k < r.at + r.times)
                if not fire:
                    continue
                self._fired.append({"site": site, "kind": r.kind, **ctx})
                if r.kind == "crash":
                    raise CrashPoint(f"injected crash at {site} (hit {k})")
                if r.kind == "eio":
                    raise TransientIOError(
                        f"injected EIO at {site} (hit {k})")
                if r.kind == "latency":
                    to_sleep = max(to_sleep, r.delay)
                else:                 # short_read / bitflip / torn_page
                    action = r.kind
        if to_sleep > 0.0:
            time.sleep(to_sleep)
        return action

    # ------------------------------------------------------- introspection
    def hits(self, site: str | None = None) -> int:
        with self._lock:
            if site is None:
                return sum(self._hits.values())
            return self._hits.get(site, 0)

    def fired(self, site: str | None = None,
              kind: str | None = None) -> List[dict]:
        with self._lock:
            return [f for f in self._fired
                    if (site is None or f["site"] == site)
                    and (kind is None or f["kind"] == kind)]
