"""SAFS page store — Table 3 / §3.4.2 measurements on the file backend.
Port of `benchmarks/bench_safs.py`.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_safs \
        --smoke [--device cpu] [--out SAFS.json]

Four ladders on real page files, plus the integrity tax:

  read_throughput  pages/s at 4 KiB and 64 KiB page size, three ways:
                   the *legacy* path (one Python pread per page), the
                   *batched* vectored engine (coalesced preadv runs), and
                   the batched engine driven by the multi-worker readahead
                   pool; beside them the *bare* floor — the same files read
                   sequentially with `os.preadv` in 1 MiB chunks, with no
                   page bookkeeping and no CRC — which says how much of the
                   page path's time is its own and how much the medium's.
  safs_stream      MvTimesMatAddMv with the subspace on disk, prefetch
                   OFF vs ON — the §3.4.2 claim that overlapping page
                   reads with compute recovers most of the in-memory
                   rate; reports the overlap fraction (busy time hidden
                   behind compute / total busy).
  safs_endurance   physical disk writes vs logical tier writes during an
                   append+restart-compress cycle — write-back + pinning
                   keep the medium's write traffic at or below logical
                   (Table 3 endurance argument); also the write-behind
                   queue's high-water depth.
  safs_cache       page-cache hit rate for the reorthogonalization
                   re-read pattern (most-recent-block pinning, §3.4.4):
                   the CGS2 append→4×re-scan cycle run twice, once with
                   the pin lifecycle engaged and once with the cache
                   degraded to plain LRU (`pin_pages=False`).
  safs_integrity   what verify-on-read costs the batched engine, and the
                   rate of a full scrub pass.

The subspace is a `MultiVector(impl="auto")` in a SAFS-backed
`TieredStore`: on the card its gram and tsgemm run the hand-written
kernels while the page path stays Python on the host. Page counts and
logical bytes count work, not time, and equal the reference's for the
same sizes. The page files go under a new temporary directory (`TMPDIR`
chooses the filesystem). Runs on the CUDA card unless `--device cpu`;
times are host-clock seconds around synchronized work; with `--out` the
metrics are written as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import MultiVector, TieredStore
from repro_torch.device import resolve_device, synchronize
from repro_torch.safs import SafsBackend, Scrubber
from repro_torch.safs.pagefile import PageFile
from repro_torch.safs.prefetch import Prefetcher

BARE_CHUNK = 1 << 20      # the bare floor's read size


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _mk(store, n, m, b, group_size=2):
    rng = np.random.default_rng(0)
    mv = MultiVector(store, n, group_size=group_size)
    for _ in range(m // b):
        mv.append_block(_f32(rng.standard_normal((n, b))))
    return mv


def _safs_store(root, n, b, device, *, enable_prefetch, page_size=4096,
                pin_pages=True):
    # cache holds ~3 blocks of a >8-block subspace: genuinely streaming
    return TieredStore(
        device_budget_bytes=2 * n * 4 * b, backend="safs",
        backend_opts={"root": root, "cache_bytes": 3 * n * 4 * b,
                      "page_size": page_size,
                      "enable_prefetch": enable_prefetch,
                      "pin_pages": pin_pages}, device=device)


def _best_of(fn, repeats=3):
    # scheduling jitter swings raw rates several-fold; best-of-N is the
    # standard throughput answer
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _bare_read(path: str, nbytes: int) -> int:
    """Read a file front to back with `os.preadv` into one reused 1 MiB
    buffer; returns the bytes read."""
    buf = bytearray(BARE_CHUNK)
    fd = os.open(path, os.O_RDONLY)
    try:
        off = 0
        while off < nbytes:
            got = os.preadv(fd, [buf], off)
            if got <= 0:
                break
            off += got
        return off
    finally:
        os.close(fd)


# ------------------------------------------------------------ throughput
def _read_throughput(root, page_size, *, nfiles, file_kb):
    """pages/s for the legacy per-page pread loop vs the batched vectored
    engine vs the readahead pool, over freshly written page files, beside
    a bare sequential read of the same files."""
    os.makedirs(root, exist_ok=True)
    paths = []
    for f in range(nfiles):
        arr = _f32(np.random.default_rng(f).standard_normal(
            file_kb * 256))                            # file_kb KiB of data
        pf = PageFile(os.path.join(root, f"t{f}.pages"),
                      page_size=page_size, shape=arr.shape, dtype="float32")
        pf.write_pages(pf.split(arr))
        pf.close()
        paths.append(os.path.join(root, f"t{f}.pages"))
    pfs = [PageFile(p) for p in paths]
    n_pages = sum(pf.n_pages for pf in pfs)
    file_bytes = sum(pf.n_pages * pf.page_size for pf in pfs)

    def legacy():                        # one python pread per page
        for pf in pfs:
            for i in pf.page_indices():
                pf.read_page(i)

    def batched():                       # coalesced vectored runs
        for pf in pfs:
            pf.read_pages_batch(range(pf.n_pages))

    def bare():                          # the medium's floor
        for pf in pfs:
            _bare_read(pf.path, pf.n_pages * pf.page_size)

    t_legacy = _best_of(legacy)
    t_batched = _best_of(batched)
    t_bare = _best_of(bare)

    by_name = {p: pf for p, pf in zip(paths, pfs)}
    pool = Prefetcher(
        lambda p: sum(len(d) for d in
                      by_name[p].read_pages_batch(
                          range(by_name[p].n_pages)).values()),
        io_workers=4, depth=nfiles)

    def pooled():
        pool.schedule(paths)
        pool.drain()

    pooled()                             # warm the worker threads
    t_pool = _best_of(pooled)
    pool.close()
    for pf in pfs:
        pf.delete()

    return {
        "page_size": page_size,
        "n_pages": n_pages,
        "legacy_pages_per_s": n_pages / max(t_legacy, 1e-9),
        "batched_pages_per_s": n_pages / max(t_batched, 1e-9),
        "readahead_pool_pages_per_s": n_pages / max(t_pool, 1e-9),
        "speedup_batched_vs_legacy": t_legacy / max(t_batched, 1e-9),
        "speedup_pool_vs_legacy": t_legacy / max(t_pool, 1e-9),
        "bare_bytes": file_bytes,
        "bare_GB_per_s": file_bytes / max(t_bare, 1e-9) / 1e9,
        "bare_pages_per_s": n_pages / max(t_bare, 1e-9),
        "batched_over_bare_time": t_batched / max(t_bare, 1e-9),
    }


def _scrub_cost(root, *, nfiles, file_kb):
    """verify-on-read overhead (batched reads, CRC on vs off) and full
    scrub-pass throughput over a freshly written store."""
    os.makedirs(root, exist_ok=True)
    for f in range(nfiles):
        arr = _f32(np.random.default_rng(100 + f).standard_normal(
            file_kb * 256))
        pf = PageFile(os.path.join(root, f"s{f}.pages"),
                      shape=arr.shape, dtype="float32")
        pf.write_pages(pf.split(arr))
        pf.close()
    paths = [os.path.join(root, f"s{f}.pages") for f in range(nfiles)]

    def read_all(verify):
        pfs = [PageFile(p, verify=verify) for p in paths]
        t0 = time.perf_counter()
        for pf in pfs:
            pf.read_pages_batch(range(pf.n_pages))
        dt = time.perf_counter() - t0
        n = sum(pf.n_pages for pf in pfs)
        for pf in pfs:
            pf.close()
        return n, dt

    n_pages, t_raw = read_all(False)
    _, t_verified = read_all(True)

    backend = SafsBackend(root, enable_prefetch=True, write_behind=False)
    scrub = Scrubber(backend, use_pool=True)
    summary = scrub.run_once()
    backend.close()
    return {
        "n_pages": n_pages,
        "read_pages_per_s_raw": n_pages / max(t_raw, 1e-9),
        "read_pages_per_s_verified": n_pages / max(t_verified, 1e-9),
        "verify_overhead": t_verified / max(t_raw, 1e-9) - 1.0,
        "scrub_pages_per_s": summary["pages"] / max(summary["seconds"],
                                                    1e-9),
    }


def _reorth_hit_rate(root, n, b, m, dev, pin_pages):
    """The reorth re-read pattern (§3.4.4): per expansion the newest block
    is appended (demoting its predecessor to disk) and the whole subspace
    is re-scanned four times by the CGS2 passes."""
    store = _safs_store(root, n, b, dev, enable_prefetch=False,
                        pin_pages=pin_pages)
    rng = np.random.default_rng(3)
    mv = MultiVector(store, n, group_size=2)
    for _ in range(m // b):
        mv.append_block(_f32(rng.standard_normal((n, b))))
        w = store.as_tensor(_f32(rng.standard_normal((n, b))))
        hc = mv.mv_trans_mv(w)
        w = w - mv.mv_times_mat(hc)
        h2 = mv.mv_trans_mv(w)
        w = w - mv.mv_times_mat(h2)
    rate = store.backend.stats_dict()["io"]["hit_rate"]
    store.close()
    return rate


# ------------------------------------------------------------- ladders
def collect(*, smoke: bool = False, device=None, n: int | None = None,
            b: int = 4, m: int | None = None, nfiles: int | None = None,
            file_kb: int | None = None) -> dict:
    """Run every ladder; the sizes default to the reference's (its smoke
    sizes with `smoke`)."""
    dn, dm = (12000, 32) if smoke else (60000, 64)
    dfiles, dkb = (4, 512) if smoke else (8, 2048)
    n, m = n or dn, m or dm
    nfiles, file_kb = nfiles or dfiles, file_kb or dkb
    dev = resolve_device(device)
    out: dict = {"schema": "bench_safs/v1", "smoke": smoke,
                 "device": str(dev), "n": n, "b": b, "m": m,
                 "nfiles": nfiles, "file_kb": file_kb}
    root = tempfile.mkdtemp(prefix="bench_safs_")
    out["root"] = root
    try:
        out["read_throughput"] = {
            str(ps): _read_throughput(os.path.join(root, f"rt{ps}"), ps,
                                      nfiles=nfiles, file_kb=file_kb)
            for ps in (4096, 65536)}

        stream = {}
        small = _f32(np.random.default_rng(1).standard_normal((m, b)))
        for tag, pref in (("prefetch_off", False), ("prefetch_on", True)):
            store = _safs_store(os.path.join(root, tag), n, b, dev,
                                enable_prefetch=pref)
            mv = _mk(store, n, m, b)
            store.flush()
            store.reset_stats()
            synchronize(dev)
            t0 = time.perf_counter()
            mv.mv_times_mat(store.as_tensor(small))
            synchronize(dev)
            if pref:
                store.backend.prefetcher.drain()
            stream[tag] = {"us": (time.perf_counter() - t0) * 1e6,
                           "logical_bytes_read": store.stats.host_bytes_read}
            pf = store.backend.stats_dict()["prefetch"]
            stream[tag].update(
                overlap_seconds=pf["overlap_seconds"],
                busy_seconds=pf["busy_seconds"],
                overlap_fraction=(pf["overlap_seconds"]
                                  / max(pf["busy_seconds"], 1e-9)))
            store.close()
        out["safs_stream"] = stream

        # endurance: logical vs physical writes over append + compress
        store = _safs_store(os.path.join(root, "endurance"), n, b, dev,
                            enable_prefetch=True)
        mv = _mk(store, n, m, b)
        q = store.as_tensor(_f32(np.random.default_rng(2).standard_normal(
            (m, m // 2))))
        synchronize(dev)
        t0 = time.perf_counter()
        mv.compress(q, [b] * (m // 2 // b))
        synchronize(dev)
        us = (time.perf_counter() - t0) * 1e6
        store.flush()
        snap = store.backend.stats_dict()   # cache+prefetch+wb in one call
        out["safs_endurance"] = {
            "us": us,
            "logical_bytes_written": store.stats.host_bytes_written,
            "physical_bytes_written": snap["io"]["host_bytes_written"],
            "disk_over_logical_writes":
                (snap["io"]["host_bytes_written"]
                 / max(store.stats.host_bytes_written, 1)),
            "write_behind": snap["write_behind"],
        }
        # the endurance store's own lookup mix (a compress pass never
        # re-reads its newest block, so the pin cannot help it)
        compress_rate = snap["io"]["hit_rate"]
        store.close()

        pinned = _reorth_hit_rate(os.path.join(root, "cache_pinned"), n, b,
                                  m, dev, True)
        lru_only = _reorth_hit_rate(os.path.join(root, "cache_lru"), n, b,
                                    m, dev, False)
        out["safs_cache"] = {
            "page_hit_rate": pinned,
            "lru_only_hit_rate": lru_only,
            "pinned_over_lru": pinned / max(lru_only, 1e-9),
            "compress_pass_hit_rate": compress_rate,
        }

        out["safs_integrity"] = _scrub_cost(
            os.path.join(root, "integrity"), nfiles=nfiles,
            file_kb=file_kb)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def run(csv_rows: list, device=None):
    """Harness entry (`python -m repro_torch.benchmarks.run safs`): CSV
    rows off collect() at the reference's sizes."""
    m = collect(device=device)
    for ps, r in m["read_throughput"].items():
        csv_rows.append((
            "safs_read", f"page={ps}",
            1e6 * r["n_pages"] / r["batched_pages_per_s"],
            f"batched_over_legacy={r['speedup_batched_vs_legacy']:.2f}"))
    for tag, r in m["safs_stream"].items():
        csv_rows.append(("safs_stream", f"m={m['m']},{tag}", r["us"],
                         f"overlap_s={r['overlap_seconds']:.4f}"))
    e = m["safs_endurance"]
    csv_rows.append(("safs_endurance", f"m={m['m']}", e["us"],
                     f"disk_over_logical_writes="
                     f"{e['disk_over_logical_writes']:.2f}"))
    csv_rows.append(("safs_cache", f"m={m['m']}", 0.0,
                     f"page_hit_rate={m['safs_cache']['page_hit_rate']:.2f},"
                     f"lru_only={m['safs_cache']['lru_only_hit_rate']:.2f}"))
    return csv_rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down sizes (the reference's smoke sizes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, metavar="SAFS.json",
                    help="write the metrics here")
    args = ap.parse_args(argv)
    metrics = collect(smoke=args.smoke, device=args.device)
    if args.out:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        print(f"wrote {args.out}")
    r4 = metrics["read_throughput"]["4096"]
    print(f"4 KiB pages: legacy {r4['legacy_pages_per_s']:,.0f} pages/s, "
          f"batched {r4['batched_pages_per_s']:,.0f} pages/s "
          f"({r4['speedup_batched_vs_legacy']:.1f}x), "
          f"pool {r4['readahead_pool_pages_per_s']:,.0f} pages/s "
          f"({r4['speedup_pool_vs_legacy']:.1f}x); bare preadv "
          f"{r4['bare_GB_per_s']:.2f} GB/s = "
          f"{r4['bare_pages_per_s']:,.0f} pages/s")
    on = metrics["safs_stream"]["prefetch_on"]
    print(f"prefetch overlap fraction: {on['overlap_fraction']:.2f}")
    wb = metrics["safs_endurance"]["write_behind"]
    if wb:
        print(f"write-behind peak queue depth: {wb['max_depth_pages']} pages")
    sc = metrics["safs_cache"]
    print(f"reorth page hit rate: {sc['page_hit_rate']:.3f} pinned vs "
          f"{sc['lru_only_hit_rate']:.3f} LRU-only "
          f"({sc['pinned_over_lru']:.1f}x)")
    ig = metrics["safs_integrity"]
    print(f"integrity: verify-on-read overhead "
          f"{100 * ig['verify_overhead']:.1f}%, scrub pass "
          f"{ig['scrub_pages_per_s']:,.0f} pages/s")
    return metrics


if __name__ == "__main__":
    main()
