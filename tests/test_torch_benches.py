"""The port's four paper ladders (repro_torch.benchmarks) against the
reference's (benchmarks/), on the CPU.

Every field that counts work — bytes, passes, reads, writes, blocks, COO
entries, pages, the two imbalances, the image bytes — must equal the
reference's for the same inputs; times are not compared. Where the
reference's `run`/`collect` is too slow to run whole here, its ladder
functions run at a smaller size in both packages. The page-cache hit
rates and physical read bytes of the SAFS ladders depend on the
write-behind thread's and the readahead pool's timing (they vary from run
to run in the reference itself), so the reorthogonalization pattern's
hits, misses and physical bytes are held equal with write-behind off,
where both packages are deterministic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.bench_safs as ref_safs
import benchmarks.bench_spmm as ref_spmm
import benchmarks.bench_subspace_io as ref_subio
import benchmarks.bench_tasops as ref_tasops
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.graphs.tiles import csr_nbytes as ref_csr_nbytes
from repro_torch.benchmarks import (bench_safs, bench_spmm,
                                    bench_subspace_io, bench_tasops)
from repro_torch.core import TieredStore, bcgs2
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.tiles import csr_nbytes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few
    cores, and these solves run their own threads (and the reference's)
    beside torch's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _derived(row) -> dict:
    """The `k=v,k=v` column of a reference CSV row."""
    return dict(kv.split("=") for kv in row[3].split(",") if kv)


# ------------------------------------------------------------------ tiles
def test_csr_nbytes_matches_reference():
    r, c, _ = rmat_graph(2000, 12000, seed=1, symmetric=True)
    rr, _, _ = ref_rmat_graph(2000, 12000, seed=1, symmetric=True)
    assert csr_nbytes(r, 2000) == ref_csr_nbytes(rr, 2000)
    assert csr_nbytes(r, 2000, idx_bytes=4) == ref_csr_nbytes(rr, 2000, 4)


# ------------------------------------------------------------------- spmm
def test_spmm_ladder_counters_equal_reference(monkeypatch):
    """The reference's `run` at its n = 20,000 over a sparser graph (its
    graph draw patched to 3,000 edges, so the all-dense image stays
    small), against the port's `collect` on the same graph."""
    monkeypatch.setattr(ref_spmm, "rmat_graph", lambda n, nnz, **kw:
                        ref_rmat_graph(n, 3000, **kw))
    rows = ref_spmm.run([])
    port = bench_spmm.collect(n=20000, nnz=3000, device="cpu")
    bench_spmm.validate(port)
    for k in ("1", "4"):
        got = {r[0]: _derived(r) for r in rows if r[1] == f"k={k}"}
        assert int(got["fig6_spmm_blocked"]["nblocks"]) == \
            port["blocking"]["nblocks"]
        hyb = got["fig6_spmm_hybrid"]
        assert (int(hyb["nblocks"]), int(hyb["coo"]), int(hyb["bytes"])) == (
            port["hybrid"]["nblocks"], port["hybrid"]["coo"],
            port["hybrid"]["nbytes_image"])
        bal = got["fig6_spmm_balance"]
        assert bal["imb_naive"] == f"{port['balance']['imb_naive']:.3f}"
        assert bal["imb_lpt"] == f"{port['balance']['imb_lpt']:.3f}"
    # the same counts off the reference's own packing, unrounded
    r, c, v = ref_rmat_graph(20000, 3000, seed=0, symmetric=True)
    from repro.graphs import pack_tiles
    from repro.graphs.partition import (balance_tile_rows, imbalance,
                                        tile_row_costs)
    hyb = pack_tiles(20000, 20000, r, c, v, block_shape=(64, 64),
                     min_block_nnz=8)
    costs = tile_row_costs(np.asarray(hyb.row_ptr))
    lpt = balance_tile_rows(costs, 48, contiguous=False)
    assert port["balance"]["imb_lpt"] == imbalance(costs, lpt, 48)
    assert port["balance"]["imb_naive"] == imbalance(
        costs, np.arange(len(costs)) % 48, 48)


def test_spmm_smoke_validates():
    m = bench_spmm.collect(smoke=True, device="cpu")
    bench_spmm.validate(m)
    assert set(m["k"]) == {"1", "4"}
    for rec in m["k"].values():
        assert set(rec["us"]) == {"coo", "blocking", "hybrid"}
        assert 0 < rec["sem"]["ratio"] <= 1


# ----------------------------------------------------------------- tasops
def _ref_tas_io(n, b, m) -> dict:
    """The reference run's naive / +recent-cache / +lazy-scale steps, with
    its own `_mk` and store, at n (its run fixes n at 60,000)."""
    TS = ref_tasops.TieredStore
    small = jnp.asarray(np.random.default_rng(1).standard_normal((m, b)),
                        jnp.float32)
    store = TS(device_budget_bytes=n * 4 * b)
    mv = ref_tasops._mk(store, n, m, b)
    for i in range(mv.nblocks):
        store.unpin(mv._block_name(i))
        store.demote(mv._block_name(i))
    store.reset_stats()
    mv.mv_times_mat(small)
    out = {"naive": store.stats.host_bytes_read
           + store.stats.host_bytes_written}
    store2 = TS(device_budget_bytes=2 * n * 4 * b)
    mv2 = ref_tasops._mk(store2, n, m, b)
    store2.reset_stats()
    mv2.mv_times_mat(small)
    out["cache"] = (store2.stats.host_bytes_read
                    + store2.stats.host_bytes_written)
    store2.reset_stats()
    mv2.mv_scale(0.5)
    out["lazy_scale"] = (store2.stats.host_bytes_read
                         + store2.stats.host_bytes_written)
    return out


def test_tasops_io_bytes_equal_reference():
    port = bench_tasops.collect(smoke=True, device="cpu")
    bench_tasops.validate(port)
    n, b = port["n"], port["b"]
    for m in (16, 64, 256):
        want = _ref_tas_io(n, b, m)
        got = port["m"][str(m)]
        assert {k: got[k]["io_bytes"] for k in want} == want, m


# ------------------------------------------------------------ subspace_io
def test_demoted_mv_gives_the_byte_counts_test_stream_pins():
    """The port's `_demoted_mv` fixture reproduces tests/test_stream.py's
    byte-exact bounds: fused expansion 2 passes of the subspace, unfused
    4, fused compress exactly one read whatever k_keep."""
    n, b, nb = 512, 4, 8
    sub_bytes = n * b * 4 * nb
    w = np.random.default_rng(1).standard_normal((n, b)).astype(np.float32)
    for fused, passes in ((True, 2), (False, 4)):
        store = TieredStore(device="cpu")
        mv = bench_subspace_io._demoted_mv(store, n, b, nb)
        store.reset_stats()
        bcgs2(mv, store.as_tensor(w), fused=fused)
        assert store.stats.host_bytes_read == passes * sub_bytes
        assert store.stats.passes == passes
    for k_blocks in (2, 4, 6):
        q = np.random.default_rng(2).standard_normal(
            (nb * b, k_blocks * b)).astype(np.float32)
        for fused in (True, False):
            store = TieredStore(device="cpu")
            mv = bench_subspace_io._demoted_mv(store, n, b, nb)
            store.reset_stats()
            mv.compress(q, [b] * k_blocks, fused=fused)
            assert store.stats.host_bytes_read == (
                sub_bytes if fused else k_blocks * sub_bytes)
            if fused:
                assert store.stats.passes == 1


@pytest.fixture(scope="module")
def subio_smoke():
    return bench_subspace_io.collect(smoke=True, device="cpu")


def test_subspace_io_smoke_validates(subio_smoke):
    bench_subspace_io.validate(subio_smoke)


def test_subspace_io_expansion_and_compress_equal_reference(subio_smoke):
    n, b, nb = 4000, 4, 8                       # the reference's smoke sizes
    for name, fn in (("expansion", ref_subio._expansion_ladder),
                     ("compress", ref_subio._compress_ladder)):
        want = fn(n, b, nb)
        got = subio_smoke[name]
        for tag in ("fused", "unfused"):
            assert got[tag] == want[tag], (name, tag)
        assert got["fused_over_unfused"] == want["fused_over_unfused"]


def _x0(n_pad):
    """The reference eigsh's own start block (seed 0)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n_pad, 4),
                                        jnp.float32))


def test_subspace_io_e2e_and_safs_counters_equal_reference(tmp_path):
    """The e2e ladder and the SAFS column at a smaller graph (300
    vertices), from the reference's start blocks: restarts, bytes and
    passes equal, and the SAFS expansion's logical bytes and passes."""
    want = ref_subio._eigsh_e2e(300, 3000, 8)
    got = bench_subspace_io._eigsh_e2e(300, 3000, 8, "cpu", x0=_x0(320))
    for tag in ("fused", "unfused"):
        assert got[tag] == want[tag], tag
    want = ref_subio._safs_ladder(str(tmp_path / "ref"), 1000, 4, 8, 300, 8)
    got = bench_subspace_io._safs_ladder(str(tmp_path / "port"), 1000, 4, 8,
                                         300, 8, "cpu", x0=_x0(320))
    for tag in ("fused", "unfused"):
        for k in ("logical_bytes_read", "passes"):
            assert got[tag][k] == want[tag][k], (tag, k)
    assert got["eigsh_max_rel_err"] <= 1e-5


# ------------------------------------------------------------------- safs
def test_safs_smoke_counters_equal_reference():
    """The page and byte counts of the reference's smoke collect: pages
    per page size, logical and physical writes of the endurance cycle
    (the write-behind retires every page by the flush), the integrity
    pass's pages; the pinned hit rate above the LRU-only one in both."""
    want = ref_safs.collect(smoke=True)
    got = bench_safs.collect(smoke=True, device="cpu")
    for ps in ("4096", "65536"):
        assert got["read_throughput"][ps]["n_pages"] == \
            want["read_throughput"][ps]["n_pages"]
        assert got["read_throughput"][ps]["bare_bytes"] == \
            got["read_throughput"][ps]["n_pages"] * int(ps)
    for k in ("logical_bytes_written", "physical_bytes_written"):
        assert got["safs_endurance"][k] == want["safs_endurance"][k], k
    assert got["safs_integrity"]["n_pages"] == \
        want["safs_integrity"]["n_pages"]
    for m in (got, want):
        assert m["safs_cache"]["page_hit_rate"] > \
            m["safs_cache"]["lru_only_hit_rate"]


@pytest.mark.parametrize("pin_pages", [True, False])
def test_safs_reorth_hits_equal_reference_without_write_behind(tmp_path,
                                                              pin_pages):
    """bench_safs's reorthogonalization re-read pattern with write-behind
    off: page-cache hits, misses and physical bytes equal to the byte."""
    from repro.core import MultiVector as RMV, TieredStore as RTS
    from repro_torch.core import MultiVector
    n, b, m = 12000, 4, 32
    counts = []
    for tag, store_cls, mv_cls, kw, mvkw in (
            ("ref", RTS, RMV, {}, {"impl": "ref"}),
            ("port", TieredStore, MultiVector, {"device": "cpu"}, {})):
        store = store_cls(
            device_budget_bytes=2 * n * 4 * b, backend="safs",
            backend_opts={"root": str(tmp_path / tag),
                          "cache_bytes": 3 * n * 4 * b,
                          "enable_prefetch": False, "pin_pages": pin_pages,
                          "write_behind": False}, **kw)
        rng = np.random.default_rng(3)
        mv = mv_cls(store, n, group_size=2, **mvkw)
        for _ in range(m // b):
            mv.append_block(rng.standard_normal((n, b)).astype(np.float32))
            w = rng.standard_normal((n, b)).astype(np.float32)
            w = jnp.asarray(w) if tag == "ref" else store.as_tensor(w)
            w = w - mv.mv_times_mat(mv.mv_trans_mv(w))
            w = w - mv.mv_times_mat(mv.mv_trans_mv(w))
        io = store.backend.stats_dict()["io"]
        counts.append((io["cache_hits"], io["cache_misses"],
                       io["host_bytes_read"], store.stats.as_dict()))
        store.close()
    assert counts[1] == counts[0]


# ---------------------------------------------------------------- harness
def test_run_prints_the_reference_csv_columns(subio_smoke, monkeypatch,
                                              capsys):
    from repro_torch.benchmarks import run
    monkeypatch.setattr(bench_subspace_io, "collect",
                        lambda **kw: subio_smoke)
    run.main(["--device", "cpu", "subspace_io"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,case,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "subspace_io_expand", "subspace_io_compress", "subspace_io_e2e"]
    assert run.MODULES == ("spmm", "tasops", "eigen", "safs", "subspace_io",
                           "dist_e2e")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        run.main(["roofline"])


def test_run_dist_e2e_smoke_keeps_the_reference_contract(capsys):
    """dist_e2e through the harness: the smoke sizes (n = 1,500) on a
    (1, 1, 1) mesh in this process, local and fused paths from one start
    block; the CSV rows the reference's harness prints, and the JSON
    contract (the reference's REQUIRED_FIELDS) that validate checks."""
    from benchmarks import bench_dist_e2e as ref_bench
    from repro_torch.benchmarks import bench_dist_e2e, run
    assert bench_dist_e2e.REQUIRED_FIELDS == ref_bench.REQUIRED_FIELDS
    run.main(["--device", "cpu", "dist_e2e"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,case,us_per_call,derived"
    assert [ln.split(",")[1] for ln in lines[1:]] == [
        "n=1500", "n=1500", "pod_compressed"]
    assert [ln.split(",")[2] for ln in lines[1:3]] == ["local", "dist"]
    m = bench_dist_e2e.collect(smoke=True, device="cpu")
    bench_dist_e2e.validate(m)
    for sect, key in ref_bench.REQUIRED_FIELDS:
        assert key in m[sect]
    assert m["parity"]["rtol_1e5_ok"] and m["timings"]["fused_expansions"]
    assert not m["pod_compressed"]["accumulates"]
    broken = dict(m, parity=dict(m["parity"], rtol_1e5_ok=False))
    with pytest.raises(ValueError, match="parity failed"):
        bench_dist_e2e.validate(broken)
