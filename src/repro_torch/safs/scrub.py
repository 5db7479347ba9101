"""Background integrity scrubber (port of `repro.safs.scrub`).

The repair half of the reference (`newest_verified_step`,
`repair_from_checkpoint`) reads checkpoint snapshots, and the port has
no checkpoint layer yet: both raise `NotImplementedError` until ROADMAP
queue 1 item 4 brings it.

Checksums only help against silent medium rot if something *reads* the
cold pages: a bit that flips under a history block nobody touches for an
hour would otherwise surface exactly when a restart needs that block.
The scrubber is the paced full-store verify pass (classic ZFS/ceph
"scrub") over a `SafsBackend`:

  * each pass walks every adopted page file and CRC-checks its pages
    straight off the medium (`backend.scrub_file` — the page cache is
    bypassed on purpose: scrub proves the bytes at rest, not the cached
    copies);
  * verify work runs on the backend's existing prefetch worker pool
    (`Prefetcher.submit`, keys `scrub::<data_id>`) so scrub I/O shares
    the same queue-depth budget as readahead instead of fighting it with
    its own threads; `pace_s` additionally sleeps between files so a
    scrub never saturates the device under a live solve;
  * detections are quarantined on the backend, counted
    (`integrity.scrub_corrupt` / `crc_failures`) and emitted as
    `safs.corrupt` trace events with site "scrub"; each completed pass
    emits exactly one `safs.scrub` event and bumps
    `integrity.scrub_passes` — the 1:1 pairs a trace report
    reconciles.

CLI::

    python -m repro_torch.safs.scrub ROOT           # one verify pass
    python -m repro_torch.safs.scrub ROOT --json    # machine-readable

(`--repair-from C` raises until the checkpoint layer is ported.)
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs import trace

__all__ = ["Scrubber", "newest_verified_step", "repair_from_checkpoint"]


class Scrubber:
    """Paced full-store verify passes over one SafsBackend.

    `run_once()` is synchronous (returns the pass summary); `start()`
    runs passes on a daemon thread every `interval_s` until `stop()`.
    `pace_s` sleeps between files within a pass (0 = as fast as the
    shared reader pool allows).
    """

    def __init__(self, backend, *, interval_s: float = 30.0,
                 pace_s: float = 0.0, use_pool: bool = True):
        self.backend = backend
        self.interval_s = float(interval_s)
        self.pace_s = float(pace_s)
        # use_pool=False verifies inline on the caller's thread — for
        # tests and the CLI, where there is no foreground solve to
        # overlap with and determinism beats concurrency
        self.use_pool = bool(use_pool)
        self.passes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- one pass
    def run_once(self) -> dict:
        """Verify every page file once; returns the pass summary dict
        {files, pages, corrupt: [(data_id, page), ...], seconds}."""
        t0 = time.perf_counter()
        ids = list(self.backend.data_ids())
        corrupt: List[Tuple[str, int]] = []
        results: Dict[str, list] = {}

        def verify(data_id: str):
            def task() -> int:
                results[data_id] = self.backend.scrub_file(data_id)
                return 0
            return task

        pool = getattr(self.backend, "prefetcher", None)
        for d in ids:
            if self.use_pool and pool is not None:
                key = "scrub::" + d
                if not pool.submit(key, verify(d)):
                    # already in flight from a previous pass — join it
                    pool.wait(key)
                    pool.submit(key, verify(d))
                pool.wait(key)
            else:
                results[d] = self.backend.scrub_file(d)
            if self.pace_s > 0:
                time.sleep(self.pace_s)
        pages = 0
        for d in ids:
            pf = self.backend._files.get(d)
            if pf is not None:
                pages += pf.n_pages
            for i in results.get(d, []):
                corrupt.append((d, int(i)))
        dt = time.perf_counter() - t0
        self.passes += 1
        self.backend.integrity.add(scrub_passes=1)
        # exactly one safs.scrub event per pass: reconciles 1:1 with
        # integrity.scrub_passes (report --validate asserts this)
        trace.event("safs.scrub", files=len(ids), pages=pages,
                    corrupt=len(corrupt), seconds=dt)
        return {"files": len(ids), "pages": pages, "corrupt": corrupt,
                "seconds": dt}

    # ---------------------------------------------------------- background
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception as e:     # scrub must never kill a serve
                    trace.event("safs.scrub_error", error=type(e).__name__)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="safs-scrub")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ------------------------------------------------------------------ repair
_NO_CKPT = ("repairing pages from a checkpoint needs the checkpoint layer, "
            "which is not ported yet: ROADMAP.md queue 1 item 4 "
            "(checkpoint/resume)")


def newest_verified_step(ckpt_root: str) -> Optional[int]:
    """Newest committed page-snapshot step that passes verification (in
    the reference). Raises: the checkpoint layer is not ported."""
    raise NotImplementedError(_NO_CKPT)


def repair_from_checkpoint(backend, ckpt_root: str,
                           targets: Optional[Sequence[Tuple[str, int]]]
                           = None) -> dict:
    """Re-fill quarantined pages from the newest verified snapshot (in
    the reference). Raises: the checkpoint layer is not ported."""
    raise NotImplementedError(_NO_CKPT)


# --------------------------------------------------------------------- CLI
def main(argv: Optional[Iterable[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Verify a SAFS page store at rest; optionally repair "
                    "corrupt pages from a verified checkpoint snapshot.")
    ap.add_argument("root", help="SAFS store root (the backend's page dir)")
    ap.add_argument("--repair-from", metavar="CKPT_ROOT", default=None,
                    help="page-checkpoint root to source repairs from")
    ap.add_argument("--trace", default=None,
                    help="write trace events to this JSONL file")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable summary")
    args = ap.parse_args(list(argv) if argv is not None else None)

    tracer = trace.install(trace.Tracer()) if args.trace else None
    from repro_torch.safs.backend import SafsBackend
    backend = SafsBackend(args.root, enable_prefetch=False,
                          write_behind=False)
    try:
        summary = Scrubber(backend, use_pool=False).run_once()
        repair = None
        if args.repair_from and summary["corrupt"]:
            repair = repair_from_checkpoint(backend, args.repair_from,
                                            summary["corrupt"])
        report = {"scrub": {"files": summary["files"],
                            "pages": summary["pages"],
                            "corrupt": summary["corrupt"],
                            "seconds": round(summary["seconds"], 4)},
                  "repair": repair,
                  "integrity": backend.stats_dict()["integrity"]}
        if args.json:
            print(json.dumps(report))
        else:
            print(f"scrub: {summary['files']} files, "
                  f"{summary['pages']} pages, "
                  f"{len(summary['corrupt'])} corrupt")
            for d, p in summary["corrupt"]:
                print(f"  CORRUPT {d} page {p}")
            if repair is not None:
                print(f"repair: step={repair['step']} "
                      f"repaired={len(repair['repaired'])} "
                      f"unrepaired={len(repair['unrepaired'])}")
        bad = (repair["unrepaired"] if repair is not None
               else summary["corrupt"])
        return 1 if bad else 0
    finally:
        backend.close()
        if tracer is not None:
            tracer.write_jsonl(args.trace)
            trace.uninstall()


if __name__ == "__main__":
    raise SystemExit(main())
