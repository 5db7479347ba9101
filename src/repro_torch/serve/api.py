"""EigenService — the eigensolver-as-a-service front end (port of
`repro.serve.api`).

One object wires the whole multi-tenant stack over ONE shared store:

    EigenService
      ├─ TieredStore (shared; sessions live in `store.namespace(job_id)`)
      │    └─ SafsBackend / RamBackend (one page cache, one write-behind)
      ├─ BudgetArbiter (one device budget split by priority)
      ├─ SolveScheduler (admission, priority dispatch, preempt/resume)
      └─ MetricsRegistry (store/arbiter/scheduler gauges, pull-based)

`submit()` takes a JobSpec (or its dict form), `drain()` runs the queue to
empty, `report()` emits the machine-readable serve report: per-job wall
time / queue wait / preemption count / spectrum digest, per-namespace
logical and physical I/O, arbiter shares, backend totals. The report is
written to be *checkable* — `validate_report` asserts the serve-level
invariants (queue drained, zero lost jobs, per-namespace physical byte
sums reconciling EXACTLY against the backend's global counters), and
chip_smoke.py's serve phase gates on it.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Union

from repro_torch.core.tiered import TieredStore
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.arbiter import BudgetArbiter
from repro_torch.serve.scheduler import SolveScheduler
from repro_torch.serve.session import DONE, JobSpec, SolveSession

log = logging.getLogger("repro_torch.serve")


class EigenService:
    """Multi-tenant solve service over one shared TieredStore."""

    def __init__(self, store: TieredStore, *,
                 ckpt_root: Optional[str] = None,
                 device_budget: Optional[int] = None,
                 min_share: int = 1 << 20,
                 max_concurrent: int = 2, max_queued: int = 64,
                 poll_interval: float = 0.01, owns_store: bool = False,
                 default_deadline_s: Optional[float] = None,
                 deadline_grace_s: float = 2.0,
                 orphan_grace_s: Optional[float] = 3600.0):
        self.store = store
        self.ckpt_root = ckpt_root
        self._owns_store = owns_store
        self.arbiter = BudgetArbiter(store, device_budget=device_budget,
                                     min_share=min_share)
        self.scheduler = SolveScheduler(store, self.arbiter,
                                        max_concurrent=max_concurrent,
                                        max_queued=max_queued,
                                        poll_interval=poll_interval,
                                        default_deadline_s=default_deadline_s,
                                        deadline_grace_s=deadline_grace_s)
        self.sessions: List[SolveSession] = []
        # Startup GC: a serve root reused after a killed process still
        # holds the dead process's per-session page subdirs. No session
        # is live yet, so any namespace older than the age gate is an
        # orphan; sweeping here (not lazily) bounds disk leakage to one
        # process lifetime. orphan_grace_s=None disables the sweep.
        self.orphans_swept: List[str] = []
        backend = getattr(store, "backend", None)
        if (orphan_grace_s is not None
                and hasattr(backend, "sweep_orphan_namespaces")):
            self.orphans_swept = backend.sweep_orphan_namespaces(
                grace_s=float(orphan_grace_s))
            if self.orphans_swept:
                log.warning("swept %d orphan namespace(s) at startup: %s",
                            len(self.orphans_swept),
                            ", ".join(self.orphans_swept))
        self.registry = obs_metrics.MetricsRegistry()
        self.registry.register(
            "store", lambda: obs_metrics.snapshot_store(store))
        self.registry.register("namespaces", store.namespace_stats)
        self.registry.register("arbiter", self.arbiter)
        self.registry.register("scheduler", self.scheduler)

    # ------------------------------------------------------------- intake
    def submit(self, spec: Union[JobSpec, dict]) -> SolveSession:
        """Queue one job (raises `AdmissionError` when the queue is full);
        returns its session for progress polling."""
        if isinstance(spec, dict):
            spec = JobSpec.from_dict(spec)
        if any(s.spec.job_id == spec.job_id for s in self.sessions):
            raise ValueError(f"duplicate job_id {spec.job_id!r}")
        session = SolveSession(spec, self.store, self.ckpt_root)
        self.scheduler.submit(session)
        self.sessions.append(session)
        return session

    def drain(self) -> List[SolveSession]:
        """Run the scheduler until every submitted job reaches a terminal
        state (preempted jobs resume and finish before drain returns)."""
        return self.scheduler.drain()

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        """Machine-readable serve report. Flushes the store first — the
        write-behind drain is the barrier that makes per-namespace
        physical write sums reconcile exactly against backend totals."""
        self.store.flush()
        snap = self.registry.snapshot()
        backend = (snap.get("store") or {}).get("backend") or {}
        return {
            "jobs": [s.report() for s in self.sessions],
            "scheduler": snap.get("scheduler"),
            "arbiter": snap.get("arbiter"),
            "namespaces": snap.get("namespaces"),   # logical, per-session
            "backend": backend,                     # physical, shared
            "orphans_swept": list(self.orphans_swept),
            "gauges": obs_metrics.gauges(snap.get("store") or {}),
        }

    def close(self) -> None:
        if self._owns_store:
            self.store.close()


def build_service(*, backend: str = "ram", root: Optional[str] = None,
                  device_budget: int = 32 << 20,
                  cache_bytes: int = 8 << 20,
                  ckpt_root: Optional[str] = None,
                  max_concurrent: int = 2, max_queued: int = 64,
                  min_share: int = 1 << 20,
                  poll_interval: float = 0.01,
                  default_deadline_s: Optional[float] = None,
                  deadline_grace_s: float = 2.0,
                  orphan_grace_s: Optional[float] = 3600.0,
                  device=None) -> EigenService:
    """Stand up the full stack from scalars (the CLI's entry point): one
    backend, one store whose device budget the arbiter will split, one
    service that owns and closes them. `device=None` means the CUDA card
    and raises when there is none; `device="cpu"` runs every session on
    the CPU's plain versions. The defaults are the reference's, sized for
    graphs of about a thousand vertices: at n = 2^20 one (n, 4) float32
    block is 16 MiB, so pass a budget and a `min_share` sized to the
    jobs."""
    opts = {}
    if backend == "safs":
        if root is not None:
            opts["root"] = root
        opts["cache_bytes"] = cache_bytes
    store = TieredStore(device_budget_bytes=device_budget,
                        backend=backend, backend_opts=opts, device=device)
    return EigenService(store, ckpt_root=ckpt_root,
                        device_budget=device_budget, min_share=min_share,
                        max_concurrent=max_concurrent,
                        max_queued=max_queued,
                        poll_interval=poll_interval, owns_store=True,
                        default_deadline_s=default_deadline_s,
                        deadline_grace_s=deadline_grace_s,
                        orphan_grace_s=orphan_grace_s)


# ------------------------------------------------------------- validation
def validate_report(report: dict) -> List[str]:
    """Serve-level invariants; returns human-readable violations (empty =
    valid). Checked: queue fully drained, zero lost jobs (every job DONE),
    per-namespace PHYSICAL byte sums reconciling exactly against the
    backend's global IOStats (reads and writes — the multi-tenant
    accounting contract)."""
    errors: List[str] = []
    sched = report.get("scheduler") or {}
    if sched.get("pending"):
        errors.append(f"queue not drained: {sched['pending']} pending")
    if sched.get("running"):
        errors.append(f"queue not drained: "
                      f"{sorted(sched['running'])} still running")
    jobs = report.get("jobs") or []
    if not jobs:
        errors.append("no jobs in report")
    for j in jobs:
        if j.get("state") != DONE:
            errors.append(f"job {j.get('job_id')!r} lost: "
                          f"state={j.get('state')!r} "
                          f"error={j.get('error')!r}")
        elif j.get("spectrum") is None:
            errors.append(f"job {j.get('job_id')!r} done but no spectrum")
    backend = report.get("backend") or {}
    ns = backend.get("namespaces") or {}
    io = backend.get("io") or {}
    for field in ("host_bytes_read", "host_bytes_written"):
        total = sum(int(d.get(field, 0)) for d in ns.values())
        want = int(io.get(field, 0))
        if total != want:
            errors.append(
                f"physical accounting leak: per-namespace {field} sum "
                f"{total} != backend total {want}")
    return errors
