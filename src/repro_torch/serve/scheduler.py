"""SolveScheduler — admission-controlled priority queue over one store
(port of `repro.serve.scheduler`).

The multi-tenant heart of the serving layer: N submitted `SolveSession`s,
up to `max_concurrent` running at once on worker threads, every one
confined to its own store namespace with the device allotment the
`BudgetArbiter` granted at admission. The dispatcher loop (`drain`, on the
caller's thread) does three things per tick:

  reap     finished workers — DONE/FAILED release the namespace and the
           arbiter share; SUSPENDED additionally *requeues* the session,
           which will resume from its committed checkpoint;
  preempt  when a strictly higher-priority job is waiting and no slot is
           free, raise the lowest-priority running preemptible session's
           `PreemptFlag` — it checkpoints at its next restart boundary and
           exits `SUSPENDED`, so short high-priority jobs jump the queue
           without losing the long job's progress;
  fill     pop pending jobs in (-priority, submit-order) order into free
           slots: `arbiter.admit` first (shares shrink for incumbents
           immediately), then the worker thread.

A fourth concern rides the same tick: the **watchdog**. Jobs carry a
wall-clock deadline (`JobSpec.deadline_s`, or the scheduler-wide
`default_deadline_s`); past it the watchdog first asks nicely (raise the
`PreemptFlag` — a cooperative worker checkpoints and exits SUSPENDED,
keeping its progress but giving up its slot for good: a deadline-expired
suspension is terminal, not requeued), and after `deadline_grace_s` more
it *abandons* a worker that still hasn't exited — the session is marked
FAILED, its namespace and arbiter share are released exactly once, and
the daemon thread is left to die detached so one hung solve can never
stall the other tenants or wedge `drain()`.

Worker exceptions can't go missing either: the thread target wraps
`session.run()` so anything escaping it (run() catching only `Exception`
leaves BaseException holes) lands in `session.error` as a full traceback
with state FAILED, and `_reap` force-fails any dead worker whose session
is still in a non-terminal state — every submitted job is accounted
DONE/SUSPENDED/FAILED in the serve report, never silently lost.

On the card every worker thread runs its solve on the device's default
stream: kernels of two sessions serialize there, and the store's
`non_blocking` host-to-device copies stay ordered against them. The
scheduler loads torch's CUDA linear algebra before any worker starts
(`device.load_cuda_linalg`): two workers making their first
`torch.linalg` call at once race in torch's lazy loader.

Admission control is a hard queue bound (`max_queued`), not a soft hint —
a serve front end that accepts unboundedly is just an OOM with extra
steps.
"""
from __future__ import annotations

import heapq
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from repro_torch.device import load_cuda_linalg
from repro_torch.obs import trace
from repro_torch.serve.session import DONE, FAILED, SUSPENDED, SolveSession


class AdmissionError(RuntimeError):
    """The queue is full — the caller must back off and resubmit."""


class _Worker:
    """One running slot: the session, its thread, and watchdog clocks."""

    __slots__ = ("session", "thread", "started", "expired_at")

    def __init__(self, session, thread):
        self.session = session
        self.thread = thread
        self.started = time.monotonic()
        self.expired_at: Optional[float] = None   # deadline preempt sent

    def job_wall_s(self, now: float) -> float:
        """Cumulative job wall-clock: prior segments + this one so far."""
        return getattr(self.session, "wall_s", 0.0) + (now - self.started)


class SolveScheduler:
    """Priority scheduler for SolveSessions over one shared TieredStore."""

    def __init__(self, store, arbiter, *, max_concurrent: int = 2,
                 max_queued: int = 64, poll_interval: float = 0.01,
                 default_deadline_s: Optional[float] = None,
                 deadline_grace_s: float = 2.0):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.store = store
        self.arbiter = arbiter
        self.max_concurrent = int(max_concurrent)
        self.max_queued = int(max_queued)
        self.poll_interval = float(poll_interval)
        # watchdog: per-job deadline_s overrides this scheduler-wide
        # default; grace is the extra time a deadline-expired worker gets
        # to checkpoint-suspend before it is abandoned as hung
        self.default_deadline_s = default_deadline_s
        self.deadline_grace_s = float(deadline_grace_s)
        # heap of (-priority, seq, session): highest priority first,
        # FIFO within a priority level
        self._pending: List[Tuple[int, int, SolveSession]] = []
        self._running: Dict[str, _Worker] = {}
        self.completed: List[SolveSession] = []
        self._seq = 0
        self.preempt_requests = 0
        self.requeues = 0
        self.timeouts = 0           # deadline preempts the watchdog sent
        self.abandoned = 0          # hung workers detached past the grace
        self.worker_crashes = 0     # threads killed by escaped exceptions
        # the workers' first CUDA linalg calls would race in torch's
        # loader: load it here, on the caller's thread
        load_cuda_linalg(getattr(store, "device", "cpu"))

    # ------------------------------------------------------------- intake
    def submit(self, session: SolveSession) -> None:
        if len(self._pending) + len(self._running) >= self.max_queued:
            raise AdmissionError(
                f"queue full ({self.max_queued} jobs in flight)")
        self._enqueue(session)

    def _enqueue(self, session: SolveSession) -> None:
        session.mark_queued()
        heapq.heappush(self._pending,
                       (-session.spec.priority, self._seq, session))
        self._seq += 1

    # ---------------------------------------------------------- dispatch
    def drain(self) -> List[SolveSession]:
        """Run the dispatcher loop until queue and slots are empty;
        returns every session in completion order."""
        while self._pending or self._running:
            self.tick()
            time.sleep(self.poll_interval)
        return self.completed

    def tick(self) -> None:
        """One dispatcher step: reap, watchdog, maybe preempt, fill.
        Exposed so tests can single-step scheduling decisions
        deterministically."""
        self._reap()
        self._watchdog()
        self._maybe_preempt()
        self._fill()

    def _run_worker(self, session: SolveSession) -> None:
        """Thread target: nothing escaping `run()` may lose the session.
        `run()` catches Exception itself; this net catches what it can't
        (BaseException, or a bug in run's own except/finally) and turns
        it into an accounted FAILED with the full traceback in the serve
        report instead of a silently dead thread."""
        try:
            session.run()
        except BaseException:
            session.error = traceback.format_exc()
            session.state = FAILED
            self.worker_crashes += 1

    def _reap(self) -> None:
        for sid in list(self._running):
            w = self._running[sid]
            if w.thread.is_alive():
                continue
            w.thread.join()
            del self._running[sid]
            session = w.session
            if session.state not in (DONE, FAILED, SUSPENDED):
                # dead worker, non-terminal state: the thread died before
                # run() could classify its exit (e.g. killed before entry)
                self.worker_crashes += 1
                if not getattr(session, "error", None):
                    session.error = ("worker thread died with session "
                                     f"in state {session.state!r}")
                session.state = FAILED
            # Namespace teardown in EVERY terminal state: a suspended
            # session's live blocks are dead weight — the committed page
            # snapshot in its checkpoint root is the only state that
            # survives, and resume rebuilds into a fresh namespace.
            self.store.drop_namespace(sid)
            self.arbiter.release(sid)
            if session.state == SUSPENDED and w.expired_at is None:
                self.requeues += 1
                self._enqueue(session)
            else:
                # deadline-expired suspensions are terminal: the snapshot
                # keeps the progress, but the job gives up its claim on
                # the cluster (requeueing it would loop forever)
                self.completed.append(session)

    def _watchdog(self) -> None:
        """Enforce per-job wall-clock deadlines: graceful checkpoint-
        suspend at the deadline, hard abandonment `deadline_grace_s`
        later for a worker that is hung (or whose solve can't reach a
        restart boundary). Abandonment releases the namespace and the
        arbiter share exactly once — `_reap` can't see the sid again."""
        now = time.monotonic()
        for sid in list(self._running):
            w = self._running[sid]
            deadline = getattr(w.session.spec, "deadline_s", None)
            if deadline is None:
                deadline = self.default_deadline_s
            if deadline is None:
                continue
            elapsed = w.job_wall_s(now)
            if elapsed <= deadline:
                continue
            if w.expired_at is None:
                w.expired_at = now
                w.session.guard.request()
                self.timeouts += 1
                trace.event("serve.deadline", job=sid,
                            elapsed_s=elapsed, deadline_s=deadline)
                continue
            if now - w.expired_at <= self.deadline_grace_s:
                continue
            if not w.thread.is_alive():
                continue    # just exited — next _reap accounts it
            del self._running[sid]
            self.abandoned += 1
            w.session.error = (f"deadline exceeded: {elapsed:.1f}s > "
                               f"{deadline:.1f}s budget and the worker "
                               f"did not suspend within the "
                               f"{self.deadline_grace_s:.1f}s grace")
            w.session.state = FAILED
            trace.event("serve.abandoned", job=sid, elapsed_s=elapsed)
            self.store.drop_namespace(sid)
            self.arbiter.release(sid)
            self.completed.append(w.session)

    def _maybe_preempt(self) -> None:
        if not self._pending or len(self._running) < self.max_concurrent:
            return
        head_priority = -self._pending[0][0]
        victims = [w.session for w in self._running.values()
                   if w.session.can_preempt
                   and w.session.spec.priority < head_priority]
        if not victims:
            return
        victim = min(victims, key=lambda s: s.spec.priority)
        victim.guard.request()
        self.preempt_requests += 1

    def _fill(self) -> None:
        while self._pending and len(self._running) < self.max_concurrent:
            _, _, session = heapq.heappop(self._pending)
            session.mark_dequeued()
            sid = session.spec.job_id
            self.arbiter.admit(sid, session.spec.priority)
            thread = threading.Thread(target=self._run_worker,
                                      args=(session,),
                                      name=f"solve-{sid}", daemon=True)
            self._running[sid] = _Worker(session, thread)
            thread.start()

    # ------------------------------------------------------------ surface
    def stats_dict(self) -> dict:
        """Live gauges for obs.metrics: queue depth, per-job progress,
        preemption/watchdog counters."""
        return {
            "pending": len(self._pending),
            "running": {sid: w.session.progress()
                        for sid, w in self._running.items()},
            "completed": len(self.completed),
            "max_concurrent": self.max_concurrent,
            "preempt_requests": self.preempt_requests,
            "requeues": self.requeues,
            "timeouts": self.timeouts,
            "abandoned": self.abandoned,
            "worker_crashes": self.worker_crashes,
        }
