"""The port's SAFS page store (`repro_torch.safs`) against the reference.

The reference's own cases (tests/test_safs.py) with the import swapped,
plus what only two packages can show: a page file written by either one
reads back equal in the other and scrubs clean there, with `.meta`,
`.sums` and page bytes equal file for file; corruption and seeded fault
plans count and fire the same in both. Everything runs on the CPU in the
size-guarded `disk_tmp` fixture.
"""
import dataclasses
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.safs as ref_safs
from repro.graphs import pack_tiles as ref_pack_tiles
from repro.graphs import rmat_graph as ref_rmat_graph
from repro_torch.convert import tiled_from_arrays
from repro_torch.core import DEVICE, HOST, MultiVector, TieredStore
from repro_torch.safs import (CorruptPageError, CrashPoint, FaultPlan,
                              FaultRule, PageCache, PageFile, PrefetchError,
                              Prefetcher, SafsBackend, Scrubber, WriteBehind,
                              WriteBehindError, coalesce_runs, flip_bit,
                              make_backend)
from repro_torch.safs import scrub as port_scrub

pytestmark = pytest.mark.disk


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor of the same bytes."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(a) -> bytes:
    """The raw bytes of a numpy array or a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _safs(root, **kw):
    return SafsBackend(root, device="cpu", **kw)


# ------------------------------------------------------------------ pagefile
def test_pagefile_roundtrip_and_cold_reopen(disk_tmp):
    path = os.path.join(disk_tmp, "a.pages")
    arr = np.arange(5000, dtype=np.float32).reshape(100, 50)
    pf = PageFile(path, page_size=4096, shape=arr.shape, dtype="float32")
    pf.write_pages(pf.split(arr))
    np.testing.assert_array_equal(pf.assemble(
        {i: pf.read_page(i) for i in pf.page_indices()}), arr)
    pf.close()
    # cold reopen recovers shape/dtype from the sidecar
    pf2 = PageFile(path)
    assert pf2.shape == (100, 50) and pf2.dtype == torch.float32
    assert pf2.dtype_name == "float32"
    np.testing.assert_array_equal(pf2.assemble(
        {i: pf2.read_page(i) for i in pf2.page_indices()}), arr)
    pf2.delete()
    assert not os.path.exists(path)


def test_crash_after_journal_commit_redoes_on_reopen(disk_tmp):
    """Kill mid-flush AFTER the journal committed: reopening must replay
    the journal, so every page shows the NEW contents."""
    path = os.path.join(disk_tmp, "c.pages")
    old = np.zeros((64, 64), np.float32)
    new = np.full((64, 64), 7.0, np.float32)
    pf = PageFile(path, page_size=4096, shape=old.shape, dtype="float32")
    pf.write_pages(pf.split(old))
    with pytest.raises(CrashPoint):
        pf.write_pages(pf.split(new), crash_after_pages=1)  # died mid-patch
    pf.close()
    pf2 = PageFile(path)   # recovery replays the committed journal
    got = pf2.assemble({i: pf2.read_page(i) for i in pf2.page_indices()})
    np.testing.assert_array_equal(got, new)
    assert not os.path.exists(path + ".journal")
    pf2.close()


def test_crash_before_journal_commit_keeps_old_pages(disk_tmp):
    """Kill mid-flush BEFORE the commit trailer: the uncommitted journal is
    discarded and every page shows the OLD contents (no torn pages)."""
    path = os.path.join(disk_tmp, "d.pages")
    old = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    new = old + 100.0
    pf = PageFile(path, page_size=4096, shape=old.shape, dtype="float32")
    pf.write_pages(pf.split(old))
    with pytest.raises(CrashPoint):
        pf.write_pages(pf.split(new), crash_in_journal=True)
    pf.close()
    pf2 = PageFile(path)
    got = pf2.assemble({i: pf2.read_page(i) for i in pf2.page_indices()})
    np.testing.assert_array_equal(got, old)
    assert not os.path.exists(path + ".journal")
    pf2.close()


def test_coalesce_runs_merges_adjacent_and_dedups():
    assert coalesce_runs([]) == []
    assert coalesce_runs([3]) == [(3, 1)]
    assert coalesce_runs([5, 0, 1, 2, 7, 6, 2]) == [(0, 3), (5, 3)]
    for idx in ([], [9, 1, 2, 3, 11, 10], list(range(2000, 0, -3))):
        assert coalesce_runs(idx) == ref_safs.coalesce_runs(idx)


def test_read_pages_batch_matches_per_page_reads(disk_tmp):
    """The vectored engine returns byte-identical pages to single preads,
    across runs longer than one iovec batch."""
    path = os.path.join(disk_tmp, "b.pages")
    arr = np.random.default_rng(0).standard_normal(70000).astype(np.float32)
    pf = PageFile(path, page_size=4096, shape=arr.shape, dtype="float32")
    pf.write_pages(pf.split(arr))
    idxs = [0, 1, 2, 40, 41, 5, pf.n_pages - 1]
    got = pf.read_pages_batch(idxs)
    assert sorted(got) == sorted(set(idxs))
    for i in got:
        assert got[i] == pf.read_page(i)
    np.testing.assert_array_equal(
        pf.assemble(pf.read_pages_batch(pf.page_indices())), arr)
    pf.delete()


def test_split_takes_tensors_and_refuses_wrong_sizes(disk_tmp):
    """A CPU tensor splits into the same pages as its numpy bytes; a wrong
    size or a device the host cannot read is refused."""
    arr = np.random.default_rng(1).standard_normal((300, 7)).astype(
        np.float32)
    pf = PageFile(os.path.join(disk_tmp, "t.pages"), shape=arr.shape,
                  dtype=torch.float32)
    assert pf.split(torch.from_numpy(arr)) == pf.split(arr)
    assert pf.dtype_name == "float32"
    with pytest.raises(ValueError, match="bytes"):
        pf.split(arr[:10])
    with pytest.raises(ValueError, match="CPU tensor"):
        pf.split(torch.empty((300, 7), device="meta"))
    with pytest.raises(TypeError, match="page files hold"):
        PageFile(os.path.join(disk_tmp, "c.pages"), shape=(2,),
                 dtype=torch.complex64)
    pf.delete()


# ------------------------------------------- page files across the packages
def _array(dtype: str) -> np.ndarray:
    a = np.random.default_rng(7).standard_normal((777, 5)).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _files(root: str) -> dict:
    out = {}
    for f in sorted(os.listdir(root)):
        with open(os.path.join(root, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _write(pkg: str, root: str, arr: np.ndarray) -> None:
    """Store `arr` as data_id "mv/b0" through one package's backend with
    the cache and the queue drained to disk, then close it."""
    if pkg == "ref":
        b = ref_safs.SafsBackend(root, enable_prefetch=False,
                                 write_behind=False)
        b.store("mv/b0", arr)
    else:
        b = _safs(root, enable_prefetch=False, write_behind=False)
        b.store("mv/b0", _tensor(arr))
    b.flush()
    b.close()


def _read_and_scrub(pkg: str, root: str):
    """Reopen `root` in one package: the block's bytes, the scrub pass."""
    if pkg == "ref":
        b = ref_safs.SafsBackend(root, enable_prefetch=False,
                                 write_behind=False)
        data = _bytes(b.load("mv/b0"))
        summary = ref_safs.Scrubber(b, use_pool=False).run_once()
    else:
        b = _safs(root, enable_prefetch=False, write_behind=False)
        t = b.load("mv/b0")
        data = _bytes(t)
        summary = Scrubber(b, use_pool=False).run_once()
    integrity = b.stats_dict()["integrity"]
    b.close()
    return data, summary, integrity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_page_files_cross_packages(disk_tmp, dtype, writer, reader):
    """A block written by one package reads back equal in the other and
    scrubs clean there; both packages write the same files, byte for
    byte (`.pages`, `.meta`, `.sums`)."""
    arr = _array(dtype)
    root_w = os.path.join(disk_tmp, "w")
    root_r = os.path.join(disk_tmp, "r")
    _write(writer, root_w, arr)
    _write(reader, root_r, arr)
    files = _files(root_w)
    assert set(files) == {"mv%2Fb0.pages", "mv%2Fb0.pages.meta",
                          "mv%2Fb0.pages.sums"}
    assert files == _files(root_r)
    assert f'"dtype": "{dtype}"'.encode() in files["mv%2Fb0.pages.meta"]
    data, summary, integrity = _read_and_scrub(reader, root_w)
    assert data == _bytes(arr)
    assert summary["corrupt"] == [] and summary["files"] == 1
    assert integrity["crc_failures"] == 0 and integrity["scrub_passes"] == 1
    assert integrity["pages_scrubbed"] == summary["pages"] > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_pagefile_reads_reference_pagefile(disk_tmp, dtype):
    """PageFile level: the port assembles the reference's pages into a
    tensor of the same type and bytes, and splits it back into the same
    payloads."""
    arr = _array(dtype)
    path = os.path.join(disk_tmp, "x.pages")
    ref_pf = ref_safs.PageFile(path, shape=arr.shape, dtype=arr.dtype)
    ref_pf.write_pages(ref_pf.split(arr))
    ref_pf.close()
    pf = PageFile(path)
    t = pf.assemble(pf.read_pages_batch(pf.page_indices()))
    assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == arr.shape
    assert _bytes(t) == _bytes(arr)
    ref_pf = ref_safs.PageFile(path)
    assert pf.split(t) == ref_pf.split(arr)
    ref_pf.close()
    pf.close()


# --------------------------------------------------------------- page cache
def _cache(capacity_pages=4, page_size=64):
    written = []

    def writer(data_id, pages):
        written.append((data_id, dict(pages)))
        return len(pages) * page_size

    return PageCache(capacity_pages * page_size, page_size, writer), written


def test_cache_lru_eviction_and_dirty_writeback():
    c, written = _cache(capacity_pages=2)
    c.put("a", 0, b"x" * 64, dirty=True)
    c.put("a", 1, b"y" * 64, dirty=False)
    c.put("b", 0, b"z" * 64, dirty=True)      # evicts ("a",0) → write-back
    assert written == [("a", {0: b"x" * 64})]
    assert c.get("a", 0) is None              # miss: evicted
    assert c.get("b", 0) == b"z" * 64         # hit
    assert c.stats.host_bytes_written == 64
    # clean eviction writes nothing (write-avoidance / endurance)
    c.put("b", 1, b"w" * 64, dirty=False)     # evicts clean ("a",1)
    assert len(written) == 1


def test_cache_pinning_protects_recent_block():
    c, written = _cache(capacity_pages=2)
    c.put("recent", 0, b"r" * 64, dirty=True)
    c.pin("recent")
    c.put("other", 0, b"o" * 64, dirty=False)
    c.put("other", 1, b"p" * 64, dirty=False)  # pressure: must skip pinned
    assert c.peek("recent", 0)                 # survived (no LRU touch)
    c.unpin("recent")
    c.put("other", 2, b"q" * 64, dirty=False)  # now evictable → write-back
    assert written and written[0][0] == "recent"


def test_cache_flush_batches_per_file():
    c, written = _cache(capacity_pages=8)
    for i in range(3):
        c.put("f", i, bytes([i]) * 64, dirty=True)
    n = c.flush()
    assert n == 3 * 64
    assert written == [("f", {0: b"\0" * 64, 1: b"\1" * 64, 2: b"\2" * 64})]
    assert c.flush() == 0                      # idempotent: now clean


PAGE, NFILES, NPAGES = 64, 3, 4
_ops = st.lists(
    st.one_of(
        st.tuples(st.just("put"), st.integers(0, NFILES - 1),
                  st.integers(0, NPAGES - 1), st.integers(0, 255),
                  st.booleans()),
        st.tuples(st.just("get"), st.integers(0, NFILES - 1),
                  st.integers(0, NPAGES - 1)),
        st.tuples(st.just("pin"), st.integers(0, NFILES - 1)),
        st.tuples(st.just("unpin"), st.integers(0, NFILES - 1)),
        st.tuples(st.just("flush"),),
        st.tuples(st.just("invalidate"), st.integers(0, NFILES - 1)),
    ),
    max_size=60)


@settings(max_examples=60, deadline=None)
@given(op_list=_ops, capacity_pages=st.integers(1, NFILES * NPAGES))
def test_cache_coherent_under_the_shipped_fill_rule(op_list, capacity_pages):
    """The cache property of the shipped design: a dirty put (a store)
    always replaces a line, while a clean put (a disk fill) over a
    resident line keeps the line's bytes — the line may be newer than
    the disk copy the filler read. So a resident line always holds the
    last dirty put, or the clean put that created it; and an insert with
    no file pinned leaves the cache within its budget."""
    c = PageCache(capacity_pages * PAGE, PAGE, lambda d, pages:
                  len(pages) * PAGE)
    expect = {}            # (file, page) -> bytes the line must hold
    for op in op_list:
        kind = op[0]
        if kind == "put":
            _, f, p, byte, dirty = op
            key, data = (f"f{f}", p), bytes([byte]) * PAGE
            fresh = not c.peek(*key)
            if dirty or fresh:
                expect[key] = data
            c.put(*key, data, dirty=dirty)
            if fresh and not c.pinned():   # an insert evicts to budget
                assert c.n_pages() <= capacity_pages
        elif kind == "get":
            got = c.get(f"f{op[1]}", op[2])
            if got is not None:
                assert got == expect[(f"f{op[1]}", op[2])]
        elif kind == "pin":
            c.pin(f"f{op[1]}")
        elif kind == "unpin":
            c.unpin(f"f{op[1]}")
        elif kind == "flush":
            c.flush()
        else:
            c.invalidate(f"f{op[1]}")
    for key, line in list(c._lines.items()):
        assert line.data == expect[key]


# ----------------------------------------------------- stores over the tier
def test_safs_streams_from_disk_under_tiny_cache(disk_tmp):
    """Cache smaller than one block: every grouped pass re-reads pages from
    the file, and the result still matches the dense product."""
    rng = np.random.default_rng(5)
    n, widths = 512, (4, 4, 4, 4)
    store = TieredStore(
        device_budget_bytes=2 * n * 4 * 4, backend="safs", device="cpu",
        backend_opts={"root": os.path.join(disk_tmp, "p"),
                      "cache_bytes": 2 * 4096})
    mv = MultiVector(store, n, group_size=2)
    blocks = [rng.standard_normal((n, w)).astype(np.float32) for w in widths]
    for b in blocks:
        mv.append_block(torch.from_numpy(b))
    # drain the write-behind queue: otherwise its victim buffer (legally)
    # serves the evicted pages and no read ever needs the medium
    store.flush()
    dense = np.concatenate(blocks, axis=1)
    small = rng.standard_normal((16, 3)).astype(np.float32)
    out = mv.mv_times_mat(torch.from_numpy(small)).numpy()
    np.testing.assert_allclose(out, dense @ small, rtol=1e-5, atol=1e-5)
    d = store.backend.stats
    assert d.host_bytes_read > 0 and d.host_bytes_written > 0
    store.close()


def test_recent_block_pin_survives_flood_and_hits_on_reread(disk_tmp):
    """§3.4.4: the most recently appended-then-demoted subspace block's
    pages stay pinned through a sequential scan larger than the cache and
    hit on the re-read; unrelated demotions do not steal the pin."""
    rng = np.random.default_rng(7)
    n, b, nblocks = 2048, 4, 8
    store = TieredStore(
        device_budget_bytes=2 * n * 4 * b, backend="safs", device="cpu",
        backend_opts={"root": os.path.join(disk_tmp, "pin"),
                      "cache_bytes": 3 * n * 4 * b, "page_size": 4096,
                      "enable_prefetch": False})
    mv = MultiVector(store, n, group_size=2)

    def block():
        return torch.from_numpy(
            rng.standard_normal((n, b)).astype(np.float32))

    for _ in range(nblocks):
        mv.append_block(block())
    cache = store.backend.cache
    recent = mv.block_names()[-2]          # newest on-"SSD" block
    assert cache.pinned() == {recent}
    mv.mv_times_mat(torch.from_numpy(
        rng.standard_normal((nblocks * b, 2)).astype(np.float32)))
    d = store.backend.stats
    hits0, misses0 = d.cache_hits, d.cache_misses
    store.get(recent)
    assert d.cache_hits == hits0 + store.backend.pagefile(recent).n_pages
    assert d.cache_misses == misses0
    for k in range(6):
        store.put(f"scratch/{k}", block())
    assert cache.pinned() == {recent}
    mv.append_block(block())
    assert cache.pinned() == {mv.block_names()[-2]}
    store.close()


def test_tier_semantics_identical_across_backends(disk_tmp):
    """Pin/demote/write-avoidance logic is backend-independent."""
    store = TieredStore(backend="safs", device="cpu",
                        backend_opts={"root": os.path.join(disk_tmp, "t")})
    store.put("x", torch.ones((64, 4)))
    store.demote("x")
    assert store.tier_of("x") == HOST
    w1 = store.stats.host_bytes_written
    store.promote("x")
    assert store.tier_of("x") == DEVICE
    store.demote("x")     # not dirty — must not write again
    assert store.stats.host_bytes_written == w1
    np.testing.assert_array_equal(store.get("x").numpy(),
                                  np.ones((64, 4), np.float32))
    store.close()


def test_store_data_ids_readonly_and_sync(disk_tmp):
    """`put(data_id=)` shares one backend file between entries (deleted
    with the last of them), a read-only entry refuses writes, and
    `sync_device_entries` writes device-only entries through."""
    from repro_torch.core import ReadOnlyError
    store = TieredStore(backend="safs", device="cpu",
                        backend_opts={"root": os.path.join(disk_tmp, "ids")})
    a = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    store.put("v", a, tier=HOST, data_id="shared")
    store.put("vt", a, tier=HOST, data_id="shared", readonly=True)
    assert store.data_ids() == ["shared"]
    assert store.backend.data_ids() == ["shared"]
    with pytest.raises(ReadOnlyError, match="read-only"):
        store.put("vt", a)
    assert torch.equal(store.get("vt"), a)
    store.host_pin("vt")
    assert store.backend.cache.pinned() == {"shared"}
    store.delete("v")
    assert store.backend.has("shared")        # "vt" still holds it
    store.delete("vt")
    assert not store.backend.has("shared")
    assert store.backend.cache.pinned() == set()
    store.put("d", a)                         # device tier only
    assert store.data_ids() == [] and store.resolve_data_id("d") == "d"
    store.sync_device_entries()
    assert store.tier_of("d") == DEVICE and store.data_ids() == ["d"]
    assert torch.equal(store.backend.load("d"), a)
    store.close()


# ----------------------------------------------------------------- prefetch
def test_prefetch_staging_is_correct_and_counted(disk_tmp):
    store = TieredStore(backend="safs", device="cpu",
                        backend_opts={"root": os.path.join(disk_tmp, "pf"),
                                      "cache_bytes": 1 << 20})
    arrs = {f"v{i}": np.random.default_rng(i).standard_normal(
        (256, 4)).astype(np.float32) for i in range(4)}
    for k, a in arrs.items():
        store.put(k, a, tier=HOST)
    store.flush()
    # fully cache-resident files are skipped ...
    store.prefetch(list(arrs))
    store.backend.prefetcher.drain()
    assert store.backend.prefetcher.stats()["files_prefetched"] == 0
    # ... and once the pages are gone, the same announcement stages them
    for k in arrs:
        store.backend.cache.invalidate(k)
    store.prefetch(list(arrs))
    store.backend.prefetcher.drain()
    assert store.backend.prefetcher.stats()["files_prefetched"] >= 1
    for k, a in arrs.items():
        np.testing.assert_array_equal(store.get(k).numpy(), a)
    store.close()


def test_prefetch_wait_propagates_reader_exception():
    """A reader that dies mid-read surfaces at wait(), not as a hang."""
    calls = []

    def reader(data_id):
        calls.append(data_id)
        if data_id == "bad":
            raise IOError("device gone")
        return 7

    pf = Prefetcher(reader, io_workers=1, depth=4)
    pf.schedule(["ok", "bad"])
    assert pf.wait("ok") >= 0.0
    with pytest.raises(PrefetchError):
        pf.wait("bad")
    assert pf.stats()["read_errors"] == 1
    pf.schedule(["bad"])          # a re-offer after the failure is taken
    with pytest.raises(PrefetchError):
        pf.wait("bad")
    pf.close()


def test_prefetch_wait_detects_dead_worker_pool():
    pf = Prefetcher(lambda d: 0, io_workers=1, depth=2)
    with pf._cv:                      # simulate a crashed worker thread
        pf._done["never"] = threading.Event()
    pf.close()                        # workers exit; "never" still unset
    with pytest.raises(PrefetchError):
        pf.wait("never", poll=0.01)


def test_prefetch_depth_bounds_queue():
    """Ids offered past the readahead window are dropped, not queued."""
    gate = threading.Event()
    pf = Prefetcher(lambda d: gate.wait(5) and 0, io_workers=1, depth=2)
    pf.schedule([f"f{i}" for i in range(8)])   # 1 in flight + 2 queued max
    assert pf.stats()["files_dropped"] >= 5
    gate.set()
    pf.drain()
    pf.close()


# ------------------------------------------------------------ write-behind
def test_write_behind_ack_survives_kill_mid_demotion(disk_tmp):
    """Every *acked* page (journal committed for its batch) is recovered
    by journal replay on reopen after a kill mid-demotion."""
    path = os.path.join(disk_tmp, "wb.pages")
    old = np.zeros((128, 32), np.float32)
    new = np.full((128, 32), 9.0, np.float32)
    pf = PageFile(path, page_size=4096, shape=old.shape, dtype="float32")
    pf.write_pages(pf.split(old))

    def writer(data_id, pages):
        return pf.write_pages(pages, crash_after_pages=1)

    wb = WriteBehind(writer, max_pages=1024)
    wb.submit("wb", pf.split(new))
    with pytest.raises(WriteBehindError) as ei:
        wb.drain()
    assert isinstance(ei.value.__cause__, CrashPoint)
    wb.close()
    pf.close()
    pf2 = PageFile(path)
    got = pf2.assemble({i: pf2.read_page(i) for i in pf2.page_indices()})
    np.testing.assert_array_equal(got, new)
    assert not os.path.exists(path + ".journal")
    pf2.delete()


def test_write_behind_serves_queued_pages_and_orders_rewrites(disk_tmp):
    path = os.path.join(disk_tmp, "vb.pages")
    arr = np.arange(2048, dtype=np.float32)
    pf = PageFile(path, page_size=4096, shape=arr.shape, dtype="float32")
    gate = threading.Event()

    def slow_writer(data_id, pages):
        gate.wait(5)
        return pf.write_pages(pages)

    wb = WriteBehind(slow_writer, max_pages=64)
    pages_v1 = pf.split(arr)
    pages_v2 = pf.split(arr + 100.0)
    wb.submit("vb", pages_v1)
    wb.submit("vb", pages_v2)      # newer bytes for the same pages
    assert wb.lookup("vb", 0) == pages_v2[0]   # newest wins pre-retire
    assert wb.lookup("vb", 99) is None
    gate.set()
    wb.drain()
    assert wb.lookup("vb", 0) is None          # retired: disk is current
    np.testing.assert_array_equal(
        pf.assemble({i: pf.read_page(i) for i in pf.page_indices()}),
        arr + 100.0)
    wb.close()
    pf.delete()


def test_backend_read_your_evictions_via_write_behind(disk_tmp):
    store = TieredStore(backend="safs", device="cpu", backend_opts={
        "root": os.path.join(disk_tmp, "rye"), "cache_bytes": 2 * 4096})
    a = np.random.default_rng(1).standard_normal((600, 4)).astype(np.float32)
    b = np.random.default_rng(2).standard_normal((600, 4)).astype(np.float32)
    store.put("x", a, tier=HOST)
    store.put("y", b, tier=HOST)   # evicts x's dirty pages
    np.testing.assert_array_equal(store.get("x").numpy(), a)
    np.testing.assert_array_equal(store.get("y").numpy(), b)
    store.close()


def _raced_backend(disk_tmp, sub, pages):
    backend = _safs(os.path.join(disk_tmp, sub), write_behind=True)
    old = np.arange(1024 * pages, dtype=np.float32)
    backend.store("x", torch.from_numpy(old))
    backend.flush()                                   # disk holds `old`
    backend.cache.invalidate("x")                     # force a disk fill
    return backend, old


def test_stale_clean_fill_cannot_outlive_write_behind_entry(disk_tmp):
    """A clean fill that reads old disk bytes while an eviction pushes
    newer bytes into the queue must not publish a stale clean line."""
    backend, _ = _raced_backend(disk_tmp, "race", 1)
    new = np.full(1024, 7.0, dtype=np.float32)
    new_payload = backend.pagefile("x").split(new)[0]
    real_pci = backend.cache.put_clean_if
    fired = []

    def racing_pci(data_id, page, data, fresh):
        if data_id == "x" and page == 0 and not fired:
            fired.append(True)   # the eviction wins the lock first
            backend.writebehind.submit("x", {0: new_payload})
        return real_pci(data_id, page, data, fresh)

    backend.cache.put_clean_if = racing_pci
    np.testing.assert_array_equal(backend.load("x"), new)   # not stale
    backend.cache.put_clean_if = real_pci
    backend.writebehind.drain()
    np.testing.assert_array_equal(backend.load("x"), new)
    backend.close()


def test_stale_clean_fill_guard_covers_retired_batch(disk_tmp):
    """The racing batch both lands AND retires inside the reader's window:
    only the submit-generation check can flag the stale fill."""
    backend, _ = _raced_backend(disk_tmp, "race2", 1)
    new = np.full(1024, 9.0, dtype=np.float32)
    new_payload = backend.pagefile("x").split(new)[0]
    real_pci = backend.cache.put_clean_if
    fired = []

    def racing_pci(data_id, page, data, fresh):
        if data_id == "x" and page == 0 and not fired:
            fired.append(True)
            backend.writebehind.submit("x", {0: new_payload})
            backend.writebehind.drain()   # batch fully retires to disk
        return real_pci(data_id, page, data, fresh)

    backend.cache.put_clean_if = racing_pci
    np.testing.assert_array_equal(backend.load("x"), new)   # re-read disk
    backend.cache.put_clean_if = real_pci
    assert not backend.cache.peek("x", 0)   # stale fill was never inserted
    np.testing.assert_array_equal(backend.load("x"), new)
    backend.close()


def test_stale_fill_guard_generation_captured_before_probe(disk_tmp):
    """The generation is captured BEFORE the staleness probes: an evict
    during another page's probe, retired during the disk read, is still
    caught."""
    backend, old = _raced_backend(disk_tmp, "race3", 2)
    pf = backend.pagefile("x")
    want = old.copy()
    want[:1024] = 3.0
    new_payload = pf.split(want)[0]
    real_get = backend.cache.get
    fired = []

    def probing_get(data_id, page, **kw):
        if data_id == "x" and page == 1 and not fired:
            fired.append(True)   # evict lands between probe(0) and capture
            backend.writebehind.submit("x", {0: new_payload})
        return real_get(data_id, page, **kw)

    real_read = pf.read_pages_batch

    def draining_read(idxs):
        out = real_read(idxs)        # reads the pre-retire (stale) bytes
        backend.writebehind.drain()  # batch retires mid-read
        return out

    backend.cache.get = probing_get
    pf.read_pages_batch = draining_read
    np.testing.assert_array_equal(backend.load("x"), want)
    backend.cache.get = real_get
    pf.read_pages_batch = real_read
    np.testing.assert_array_equal(backend.load("x"), want)
    backend.close()


# ------------------------------------------------ integrity and fault plans
def _twin_backends(disk_tmp, **kw):
    ref = ref_safs.SafsBackend(os.path.join(disk_tmp, "ref"), **kw)
    port = _safs(os.path.join(disk_tmp, "port"), **kw)
    return ref, port


def test_flip_bit_raises_corrupt_page_and_quarantines_alike(disk_tmp):
    """At-rest rot: a flipped bit fails the CRC on the next read in both
    packages, with the same quarantine and integrity counters; a scrub
    pass finds the same page."""
    ref, port = _twin_backends(disk_tmp, enable_prefetch=False,
                               write_behind=False)
    arr = np.random.default_rng(3).standard_normal((900, 4)).astype(
        np.float32)
    for b, a in ((ref, arr), (port, torch.from_numpy(arr))):
        b.store("a", a)
        b.flush()
        b.cache.invalidate("a")
        flip_bit(b.pagefile("a").path, 1)
    with pytest.raises(ref_safs.CorruptPageError):
        ref.load("a")
    with pytest.raises(CorruptPageError) as ei:
        port.load("a")
    assert ei.value.page == 1 and ei.value.site == "pread"
    assert port.quarantined() == ref.quarantined() == [("a", 1)]
    assert port.stats_dict()["integrity"] == ref.stats_dict()["integrity"]
    assert Scrubber(port, use_pool=False).run_once()["corrupt"] == \
        ref_safs.Scrubber(ref, use_pool=False).run_once()["corrupt"] == \
        [("a", 1)]
    assert port.stats_dict()["integrity"] == ref.stats_dict()["integrity"]
    ref.close()
    port.close()


def _fault_plan(mod):
    return mod.FaultPlan([
        mod.FaultRule(site="pread", kind="eio", at=2, times=2),
        mod.FaultRule(site="pwritev", kind="eio", at=1, times=1),
        mod.FaultRule(site="journal.*", kind="latency", delay=0.0),
        mod.FaultRule(site="pread", kind="short_read", prob=0.5),
    ], seed=11)


def test_seeded_fault_plan_fires_the_same_sites(disk_tmp):
    """One seeded schedule of transient faults drives both packages
    through the same workload (synchronous paths): the same sites are
    hit as often, the same rules fire in the same order, the retries
    absorb them alike and the data survives."""
    plans = {"ref": _fault_plan(ref_safs), "port": _fault_plan(
        __import__("repro_torch.safs", fromlist=["FaultPlan"]))}
    kw = dict(enable_prefetch=False, write_behind=False,
              cache_bytes=8 * 4096)
    ref = ref_safs.SafsBackend(os.path.join(disk_tmp, "ref"),
                               faults=plans["ref"], **kw)
    port = _safs(os.path.join(disk_tmp, "port"), faults=plans["port"], **kw)
    rng = np.random.default_rng(4)
    blocks = [rng.standard_normal((700, 4)).astype(np.float32)
              for _ in range(4)]
    for i, a in enumerate(blocks):
        ref.store(f"b{i}", a)
        port.store(f"b{i}", torch.from_numpy(a))
    for b in (ref, port):
        b.flush()
    for i, a in enumerate(blocks * 2):
        np.testing.assert_array_equal(ref.load(f"b{i % 4}"), a)
        np.testing.assert_array_equal(port.load(f"b{i % 4}"), a)

    def fired(plan):
        return [(f["site"], f["kind"], os.path.basename(f["file"]),
                 f.get("page")) for f in plan.fired()]

    for site in ("pread", "pwritev", "journal.precommit", "journal.commit"):
        assert plans["port"].hits(site) == plans["ref"].hits(site) > 0
    assert fired(plans["port"]) == fired(plans["ref"])
    assert {k for _, k, _, _ in fired(plans["port"])} == {
        "eio", "latency", "short_read"}
    io_p, io_r = port.stats_dict()["io"], ref.stats_dict()["io"]
    assert io_p["retries"] == io_r["retries"] == 3
    for k in ("host_bytes_read", "host_bytes_written", "host_reads",
              "host_writes", "cache_hits", "cache_misses"):
        assert io_p[k] == io_r[k], k
    ref.close()
    port.close()


# ------------------------------------------------------------- entry points
def test_make_backend_and_store_options(disk_tmp):
    b = make_backend("safs", root=os.path.join(disk_tmp, "mb"),
                     cache_bytes=4096, io_workers=1, readahead_depth=2,
                     write_behind=False, pin_pages=False, verify_reads=False)
    assert isinstance(b, SafsBackend) and not b.pin_memory
    assert b.writebehind is None and b.cache.capacity == 4096
    b.pin("x")
    assert b.cache.pinned() == set()           # pin_pages=False: plain LRU
    b.close()
    with pytest.raises(ValueError, match="unknown storage backend"):
        make_backend("tape")
    with pytest.raises(NotImplementedError, match="item 4"):
        port_scrub.repair_from_checkpoint(b, os.path.join(disk_tmp, "ck"))
    with pytest.raises(NotImplementedError, match="item 4"):
        port_scrub.newest_verified_step(os.path.join(disk_tmp, "ck"))


def test_scrub_cli_over_a_reference_store(disk_tmp, capsys):
    """`python -m repro_torch.safs.scrub ROOT` verifies a store at rest,
    here one the reference wrote: clean, then one rotten page."""
    root = os.path.join(disk_tmp, "cli")
    b = ref_safs.SafsBackend(root, enable_prefetch=False)
    b.store("a", np.ones((2000, 3), np.float32))
    b.close()
    assert port_scrub.main([root]) == 0
    assert "1 files" in capsys.readouterr().out
    flip_bit(os.path.join(root, "a.pages"), 0, bit=5)
    assert port_scrub.main([root, "--json"]) == 1
    assert '"corrupt": [["a", 0]]' in capsys.readouterr().out


def test_worker_threads_call_no_torch(disk_tmp):
    """The readahead workers and the write-behind drain thread run pure
    host I/O: a profile hook on every thread they start sees no call into
    torch while a store streams blocks in and out."""
    seen = []

    def hook(frame, event, arg):
        if event == "call" and "torch" in frame.f_code.co_filename.split(
                os.sep):
            seen.append((threading.current_thread().name,
                         frame.f_code.co_name))
        elif event == "c_call" and (getattr(arg, "__module__", "") or
                                    "").startswith("torch"):
            seen.append((threading.current_thread().name, arg.__name__))

    threading.setprofile(hook)
    try:
        store = TieredStore(4 * 1000 * 4 * 4, backend="safs", device="cpu",
                            backend_opts={"root": os.path.join(disk_tmp,
                                                               "thr"),
                                          "cache_bytes": 8 * 4096})
    finally:
        threading.setprofile(None)
    mv = MultiVector(store, 1000, group_size=2)
    rng = np.random.default_rng(0)
    for _ in range(6):
        mv.append_block(torch.from_numpy(
            rng.standard_normal((1000, 4)).astype(np.float32)))
    for _ in range(3):
        mv.mv_times_mat(torch.ones((24, 2)))
    store.flush()
    st_ = store.backend.stats_dict()
    assert st_["prefetch"]["files_prefetched"] > 0
    assert st_["write_behind"]["pages_retired"] > 0
    store.close()
    workers = [s for s in seen if s[0].startswith("safs-")]
    assert workers == []


def test_streamed_image_spans_hold_the_reference_spans():
    """`chunk_block_rows` and the image spans a streamed operator spills
    are the reference's: the same cuts, so the same entries and bytes."""
    r, c, v = ref_rmat_graph(1500, 12000, seed=9, symmetric=True)
    ref_tm = ref_pack_tiles(1500, 1500, r, c, v, block_shape=(64, 64),
                            min_block_nnz=2)
    tm = tiled_from_arrays(dataclasses.asdict(ref_tm))
    for target in (1, 1 << 14, 1 << 16, 1 << 30):
        assert tm.chunk_block_rows(target) == ref_tm.chunk_block_rows(target)
    assert tm.nnz == ref_tm.nnz
    np.testing.assert_array_equal(tm.to_dense(), ref_tm.to_dense())


def test_concurrent_stores_and_loads_reconcile(disk_tmp):
    """Stress: 16 threads (more than this machine's cores) store and load
    their own blocks through one backend whose cache is far smaller than
    the blocks, with readahead and write-behind on and a short switch
    interval. Every load returns the block's newest bytes, and after a
    flush the physical byte counters reconcile with the per-namespace
    split that is advanced at the same sites (a lost update breaks it)."""
    import sys
    backend = _safs(os.path.join(disk_tmp, "stress"), cache_bytes=8 * 4096,
                    io_workers=4, readahead_depth=4, wb_max_pages=64)
    errors = []

    def worker(k):
        rng = np.random.default_rng(k)
        try:
            for it in range(12):
                for j in range(2):
                    a = rng.standard_normal((700, 4)).astype(np.float32)
                    name = f"t{k}/b{j}"
                    backend.store(name, torch.from_numpy(a))
                    backend.prefetch([f"t{k}/b{1 - j}"])
                    if not np.array_equal(backend.load(name).numpy(), a):
                        errors.append((k, it, j))
        except Exception as e:          # reported by the assertion below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    backend.flush()
    snap = backend.stats_dict()
    io, split = snap["io"], snap["namespaces"]["_shared"]
    for key in ("host_bytes_read", "host_bytes_written", "host_reads",
                "host_writes"):
        assert io[key] == split[key], key
    assert io["host_bytes_written"] == snap["write_behind"]["bytes_retired"]
    assert snap["write_behind"]["pending_pages"] == 0
    backend.close()
