"""Serving launcher: a multi-tenant solve queue over one shared store
(port of `repro.launch.serve`).

  python -m repro_torch.launch.serve --jobs jobs.json --out report.json \
      --backend safs --device-budget $((32<<20)) --max-concurrent 2

The service runs on the CUDA card (every session's solve launches the
SpMM, gram and tsgemm kernels) unless `--device cpu`; without a card and
without `--device cpu` it raises.

`jobs.json` is a list of JobSpec dicts (or `{"jobs": [...]}`):

  [{"job_id": "embed-a", "kind": "eigsh",  "n": 1200, "nev": 4},
   {"job_id": "clust-b", "kind": "cluster", "n": 1200, "priority": 2},
   {"job_id": "pcg-c",   "kind": "lobpcg", "n": 800,  "nev": 4}]

All jobs share ONE store (one SAFS page cache, one write-behind queue, one
device budget split by the arbiter); the scheduler runs them with priority
dispatch and checkpoint-based preemption. The run emits a machine-readable
serve report (per-job wall time, queue wait, preemption count, spectrum
digests, per-namespace I/O reconciliation) and exits nonzero if
`validate_report` finds any serve-invariant violation (chip_smoke.py
runs `--demo` on the card and gates on it).

`--demo` ignores --jobs and runs the staged preemption scenario: saturate
the slots with low-priority background solves, wait until one is mid-
flight, then submit a high-priority rush job — the scheduler suspends a
background job (checkpoint → requeue), runs the rush job, and resumes.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from repro_torch.serve import JobSpec, build_service, validate_report


def _demo_specs():
    background = [
        JobSpec("bg-embed", kind="eigsh", n=1500, nnz=15000, nev=6,
                priority=0, tol=1e-8, max_iters=150),
        JobSpec("bg-lobpcg", kind="lobpcg", n=800, nnz=8000, nev=4,
                priority=0, tol=1e-5, max_iters=60),
        JobSpec("bg-cluster", kind="cluster", n=1200, k_classes=4, nev=4,
                priority=1, tol=1e-6),
    ]
    rush = JobSpec("rush-eigsh", kind="eigsh", n=400, nnz=4000, nev=2,
                   priority=5, tol=1e-5, max_iters=60)
    return background, rush


def _run_demo(service, *, start_timeout: float = 60.0) -> None:
    """Submit background jobs, wait until one is actually iterating, then
    drop the rush job on the queue so the preemption path exercises."""
    background, rush = _demo_specs()
    for spec in background:
        service.submit(spec)
    deadline = time.monotonic() + start_timeout
    while time.monotonic() < deadline:
        service.scheduler.tick()
        running = service.scheduler.stats_dict()["running"]
        if any(p["steps"] >= 1 for p in running.values()):
            break
        time.sleep(0.02)
    service.submit(rush)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-tenant eigensolver service over one store")
    ap.add_argument("--jobs", help="JSON file of JobSpec dicts")
    ap.add_argument("--out", help="write the serve report here (JSON); "
                                  "default stdout")
    ap.add_argument("--backend", choices=("safs", "ram"), default="safs")
    ap.add_argument("--root", help="SAFS page-file root (default: tmp)")
    ap.add_argument("--device-budget", type=int, default=32 << 20,
                    help="global device budget the arbiter splits [bytes]")
    ap.add_argument("--cache-bytes", type=int, default=8 << 20,
                    help="shared SAFS page-cache capacity [bytes]")
    ap.add_argument("--max-concurrent", type=int, default=2)
    ap.add_argument("--max-queued", type=int, default=64)
    ap.add_argument("--ckpt-root",
                    help="checkpoint root for suspend/resume (default: "
                         "tmp; preemption needs one)")
    ap.add_argument("--job-deadline", type=float, default=None,
                    metavar="SECONDS",
                    help="default per-job wall-clock deadline; the "
                         "watchdog suspends (then abandons) jobs past it")
    ap.add_argument("--deadline-grace", type=float, default=2.0,
                    metavar="SECONDS",
                    help="extra time a deadline-expired worker gets to "
                         "checkpoint-suspend before abandonment")
    ap.add_argument("--orphan-grace", type=float, default=3600.0,
                    metavar="SECONDS",
                    help="age gate for the startup orphan-namespace GC "
                         "(negative disables the sweep)")
    ap.add_argument("--demo", action="store_true",
                    help="run the staged preemption demo instead of --jobs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the store and every session run (cuda: "
                         "the card, raising when there is none)")
    args = ap.parse_args(argv)
    if not args.demo and not args.jobs:
        ap.error("need --jobs FILE or --demo")

    ckpt_root = args.ckpt_root or tempfile.mkdtemp(prefix="serve_ckpt_")
    service = build_service(
        backend=args.backend, root=args.root,
        device_budget=args.device_budget, cache_bytes=args.cache_bytes,
        ckpt_root=ckpt_root, max_concurrent=args.max_concurrent,
        max_queued=args.max_queued,
        default_deadline_s=args.job_deadline,
        deadline_grace_s=args.deadline_grace,
        orphan_grace_s=(None if args.orphan_grace < 0
                        else args.orphan_grace),
        device=None if args.device == "cuda" else "cpu")
    try:
        if args.demo:
            _run_demo(service)
        else:
            with open(args.jobs) as f:
                specs = json.load(f)
            if isinstance(specs, dict):
                specs = specs["jobs"]
            for d in specs:
                service.submit(d)
        t0 = time.monotonic()
        service.drain()
        report = service.report()
        report["queue_wall_s"] = time.monotonic() - t0
        errors = validate_report(report)
        report["valid"] = not errors
        report["errors"] = errors
        text = json.dumps(report, indent=2, default=_json_default)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        else:
            print(text)
        for j in report["jobs"]:
            print(f"[{j['state']:>9s}] {j['job_id']:<12s} "
                  f"prio={j['priority']} wall={j['wall_s']:.2f}s "
                  f"wait={j['queue_wait_s']:.2f}s "
                  f"preempts={j['preemptions']} "
                  f"sha={(j['spectrum'] or {}).get('sha', '-')}",
                  file=sys.stderr)
        sched = report["scheduler"]
        print(f"queue drained in {report['queue_wall_s']:.2f}s; "
              f"{sched['completed']} jobs, "
              f"{sched['preempt_requests']} preempt requests, "
              f"{sched['requeues']} requeues, "
              f"{sched.get('timeouts', 0)} deadline timeouts, "
              f"{sched.get('abandoned', 0)} abandoned; "
              f"valid={report['valid']}", file=sys.stderr)
        integ = (report.get("backend") or {}).get("integrity")
        if integ:
            print(f"integrity: {integ['pages_verified']} pages verified, "
                  f"{integ['crc_failures']} corrupt "
                  f"({integ['quarantined']} quarantined), "
                  f"{integ['pages_repaired']} repaired, "
                  f"{integ['scrub_passes']} scrub passes", file=sys.stderr)
        if report.get("orphans_swept"):
            print(f"orphan namespaces swept at startup: "
                  f"{', '.join(report['orphans_swept'])}", file=sys.stderr)
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1 if errors else 0
    finally:
        service.close()


if __name__ == "__main__":
    sys.exit(main())
