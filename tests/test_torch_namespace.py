"""The shared-store layer of the port against the reference: namespaces,
per-namespace budgets, pins and IOStats splits, `drop_namespace`,
`sweep_orphan_namespaces`, the compress cap, and `MultiVector`'s own
store.

The reference's store-only cases (tests/test_serve.py) run the same
sequence through both packages, and `namespace_stats()` must be equal;
what only the port shows (threads over one store, solves in namespaces)
is held to the port's own solo run.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.tiered as R
from repro.core.multivector import MultiVector as RefMultiVector
from repro.safs.backend import SafsBackend as RefSafsBackend
from repro_torch.core import GraphOperator, MultiVector, solve
from repro_torch.core.tiered import IOStats, StoreNamespace, TieredStore
from repro_torch.graphs import normalized_adjacency, pack_tiles, rmat_graph
from repro_torch.safs import SafsBackend


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few
    cores, and these solves run their own threads (and the reference's)
    beside torch's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(budget, **kw):
    """The same store in both packages (the port's on the CPU)."""
    return (R.TieredStore(device_budget_bytes=budget, **kw),
            TieredStore(device_budget_bytes=budget, device="cpu", **kw))


def _same(ref, port):
    assert port.namespace_stats() == ref.namespace_stats()
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert sorted(port.names()) == sorted(ref.names())
    assert {n: port.tier_of(n) for n in port.names()} == \
        {n: ref.tier_of(n) for n in ref.names()}
    assert port.device_bytes() == ref.device_bytes()


# ===================================================== namespaces (resource)
def test_namespace_isolation_and_accounting():
    stores = _both(1 << 20)
    for store in stores:
        a = store.namespace("a")
        b = store.namespace("b")
        a.put("x", np.full((64,), 1.0, np.float32))
        b.put("x", np.full((64,), 2.0, np.float32))
        assert float(np.asarray(a.get("x"))[0]) == 1.0
        assert float(np.asarray(b.get("x"))[0]) == 2.0
        assert a.names() == ["x"] and b.names() == ["x"]
        # host-tier traffic lands in the owning session's bucket and the
        # parent's counters alike: parent == Σ namespaces, field by field
        a.demote("x"), b.demote("x")
        a.get("x"), b.get("x")
        ns = store.namespace_stats()
        for field in ("host_bytes_written", "host_bytes_read",
                      "host_writes", "host_reads"):
            total = sum(d[field] for d in ns.values())
            assert total == getattr(store.stats, field) > 0, field
    assert isinstance(stores[1].namespace("a"), StoreNamespace)
    assert stores[1].namespace("a") is stores[1].namespace("a")
    _same(*stores)


@pytest.mark.parametrize("bad", ["", "a::b"])
def test_namespace_refuses_bad_session_ids(bad):
    for store in _both(1 << 20):
        with pytest.raises(ValueError, match="invalid session id"):
            store.namespace(bad)


def test_namespace_drop_reclaims_but_stats_survive():
    stores = _both(1 << 20)
    for store in stores:
        a = store.namespace("a")
        a.put("x", np.zeros(64, np.float32))
        a.demote("x")
        written = store.namespace_stats()["a"]["host_bytes_written"]
        assert written > 0
        a.close()
        assert store.names() == []
        # post-mortem accounting survives the drop
        assert store.namespace_stats()["a"]["host_bytes_written"] == written
        # a fresh facade under the same id starts empty
        assert store.namespace("a").names() == []
    _same(*stores)


def test_namespace_budget_evicts_own_entries_only():
    stores = _both(1 << 30)
    for store in stores:
        a, b = store.namespace("a"), store.namespace("b")
        blk = np.zeros((1024,), np.float32)          # 4 KiB each
        for i in range(4):
            a.put(f"v{i}", blk + i)
            b.put(f"v{i}", blk + i)
        store.set_namespace_budget("a", 8 << 10)     # room for 2 of a's
        assert store.namespace_budget("a") == 8 << 10
        assert sum(a.tier_of(f"v{i}") == "device" for i in range(4)) <= 2
        assert all(b.tier_of(f"v{i}") == "device" for i in range(4))
        assert a.device_bytes() <= 8 << 10 and a.device_budget == 8 << 10
        # values survive eviction (demoted, not dropped)
        assert float(np.asarray(a.get("v0"))[0]) == 0.0
        store.set_namespace_budget("a", None)
        assert store.namespace_budget("a") is None
    _same(*stores)


def test_host_pin_slot_per_namespace():
    """One §3.4.4 page pin per namespace: b's pin does not release a's."""
    for store in _both(1 << 30):
        pins = []
        store.backend.pin = lambda d, pins=pins: pins.append(("pin", d))
        store.backend.unpin = lambda d, pins=pins: pins.append(("unpin", d))
        a, b = store.namespace("a"), store.namespace("b")
        for ns in (a, b):
            ns.put("x", np.zeros(16, np.float32))
            ns.put("y", np.zeros(16, np.float32))
        a.host_pin("x")
        b.host_pin("x")
        a.host_pin("y")
        assert pins == [("pin", "a::x"), ("pin", "b::x"),
                        ("unpin", "a::x"), ("pin", "a::y")]


# ================================================ IOStats under threads
def test_iostats_concurrent_hammer_reconciles_exactly():
    stats = IOStats()
    n_threads, n_iter = 8, 2000

    def hammer():
        for _ in range(n_iter):
            stats.add(host_reads=1, host_bytes_read=128)

    ts = [threading.Thread(target=hammer) for _ in range(n_threads)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert stats.host_reads == n_threads * n_iter
    assert stats.host_bytes_read == n_threads * n_iter * 128


def test_store_concurrent_sessions_reconcile_exactly():
    """N threads, one store, one namespace each: per-ns logical sums must
    equal the parent's counters to the byte."""
    store = TieredStore(device_budget_bytes=32 << 10, device="cpu")
    n_threads, n_iter = 6, 120
    blk = np.zeros(512, np.float32)                     # 2 KiB

    def worker(sid):
        ns = store.namespace(sid)
        for i in range(n_iter):
            ns.put(f"v{i % 8}", blk + i)
            ns.get(f"v{i % 8}")

    ts = [threading.Thread(target=worker, args=(f"s{k}",))
          for k in range(n_threads)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    ns = store.namespace_stats()
    for field in ("host_bytes_written", "host_bytes_read",
                  "host_reads", "host_writes",
                  "cache_hits", "cache_misses"):
        assert sum(d[field] for d in ns.values()) == \
            getattr(store.stats, field), field
    assert store.device_bytes() <= 32 << 10
    assert store.device_bytes() == sum(
        store.namespace(f"s{k}").device_bytes() for k in range(n_threads))


# ================================== the compress cap ← namespace budget
@pytest.mark.parametrize("budget,passes", [(None, 1), (2 << 20, 3)])
def test_compress_chunks_under_small_namespace_budget(budget, passes):
    """A namespace whose budget is small chunks its fused compress pass
    (2 MiB → a 1 MiB cap → 3 single-width pass groups); an uncapped one
    does the whole compress in ONE pass. Both packages, the same
    passes, bytes and output."""
    n, widths = 40_000, (4, 4, 4)                # 640 KiB per output block
    q = np.eye(12, dtype=np.float32)
    outs = []
    for store, mv_cls in zip(_both(1 << 30), (RefMultiVector, MultiVector)):
        ns = store.namespace("s")
        if budget is not None:
            store.set_namespace_budget("s", budget)
        mv = mv_cls(ns, n, name="V")
        rng = np.random.default_rng(0)
        for w in widths:
            mv.append_block(rng.standard_normal((n, w)).astype(np.float32))
        before = store.stats.passes
        out = mv.compress(q, widths)
        assert store.stats.passes - before == passes
        # the compressed subspace lands under the namespace's prefix
        assert out.store is ns
        assert all(name.startswith("s::") for name in store.names())
        assert set(ns.names()) == {f"V/b{i}" for i in range(3)} | {
            f"{out.name}/b{i}" for i in range(3)}
        outs.append((np.asarray(out.to_dense()), store.namespace_stats()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    assert outs[1][1] == outs[0][1]


# ============================================ the SAFS backend's namespaces
@pytest.mark.disk
def test_safs_namespaces_split_and_drop(disk_tmp):
    """Per-session page subdirectories and physical splits on SAFS, the
    same in both packages; dropping a session removes its subdirectory
    and keeps its stats."""
    snaps = []
    for tag, cls in (("ref", R.TieredStore), ("port", TieredStore)):
        root = os.path.join(disk_tmp, tag)
        kw = {} if tag == "ref" else {"device": "cpu"}
        store = cls(1 << 30, backend="safs",
                    backend_opts={"root": root, "write_behind": False},
                    **kw)
        for sid in ("a", "b"):
            ns = store.namespace(sid)
            for i in range(3):
                ns.put(f"v{i}", np.full((2048,), i, np.float32))
                ns.demote(f"v{i}")
            ns.get("v0")
        store.flush()
        assert sorted(os.listdir(root)) == ["a", "b"]
        assert len([f for f in os.listdir(os.path.join(root, "a"))
                    if f.endswith(".pages")]) == 3
        store.namespace("a").close()
        assert sorted(os.listdir(root)) == ["b"]
        assert store.backend.data_ids() == [f"b::v{i}" for i in range(3)]
        snap = store.backend.stats_dict()
        snaps.append((store.namespace_stats(), snap["io"],
                      snap.get("namespaces")))
        store.close()
    assert snaps[1] == snaps[0]


@pytest.mark.disk
def test_sweep_orphan_namespaces(disk_tmp):
    """A root reused after a killed process: a stale session directory
    is reclaimed, a live one and a young one are spared — the same
    sessions in both packages."""
    swept = []
    for tag, cls in (("ref", RefSafsBackend), ("port", SafsBackend)):
        root = os.path.join(disk_tmp, tag)
        first = cls(root, write_behind=False)
        for sid in ("live", "stale", "young"):
            ones = np.ones(1024, np.float32)
            first.store(f"{sid}::x",
                        ones if tag == "ref" else torch.from_numpy(ones))
        first.close()
        old = time.time() - 7200
        for sid in ("live", "stale"):
            os.utime(os.path.join(root, sid), (old, old))
        backend = cls(root, write_behind=False)   # adopts all three
        assert sorted(backend.data_ids()) == ["live::x", "stale::x",
                                              "young::x"]
        swept.append(backend.sweep_orphan_namespaces(live=["live"],
                                                     grace_s=3600.0))
        assert sorted(os.listdir(root)) == ["live", "young"]
        assert sorted(backend.data_ids()) == ["live::x", "young::x"]
        backend.close()
    assert swept == [["stale"], ["stale"]]


@pytest.mark.disk
def test_multivector_builds_its_own_safs_store(disk_tmp):
    """`MultiVector(None, n, backend="safs", backend_opts=...)` makes its
    own SAFS-backed store, as the reference's does."""
    mvs = []
    for tag, cls, kw in (("ref", RefMultiVector, {}),
                         ("port", MultiVector, {"device": "cpu"})):
        mv = cls(None, 512, backend="safs", group_size=2,
                 backend_opts={"root": os.path.join(disk_tmp, tag),
                               "write_behind": False}, **kw)
        rng = np.random.default_rng(4)
        for _ in range(4):
            mv.append_block(rng.standard_normal((512, 4)).astype(np.float32))
        mvs.append(mv)
    ref, port = mvs
    assert isinstance(port.store, TieredStore)
    assert isinstance(port.store.backend, SafsBackend)
    np.testing.assert_array_equal(np.asarray(port.to_dense()),
                                  np.asarray(ref.to_dense()))
    assert port.store.stats.as_dict() == ref.store.stats.as_dict()
    for mv in mvs:
        mv.store.close()


# ======================================== solves in namespaces (one store)
@pytest.fixture(scope="module")
def tm():
    n = 400
    r, c, v = normalized_adjacency(n, *rmat_graph(n, 4000, seed=5,
                                                  symmetric=True))
    return pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)


def _ns_solve(tm, store):
    x0 = np.random.default_rng(0).standard_normal(
        (tm.shape[0], 4)).astype(np.float32)
    return solve(GraphOperator(tm, store=store), 4, method="krylov_schur",
                 tol=1e-6, max_iters=100, store=store, x0=x0)


def test_two_namespace_solves_split_like_solo_solves(tm):
    """The chip phase's check on the CPU: Krylov–Schur in two namespaces
    of one store, one after the other and then in two threads; each
    namespace's IOStats equal a solo solve's to the byte, the splits sum
    to the store's counters, and drop_namespace frees a namespace's
    device bytes and keeps its stats."""
    solo = _ns_solve(tm, TieredStore(device="cpu"))
    store = TieredStore(device="cpu")
    for sid in ("s0", "s1"):
        res = _ns_solve(tm, store.namespace(sid))
        assert res.io_stats == solo.io_stats
        np.testing.assert_array_equal(res.eigenvalues, solo.eigenvalues)
    results = {}
    threads = [threading.Thread(
        target=lambda sid=sid: results.__setitem__(
            sid, _ns_solve(tm, store.namespace(sid))))
        for sid in ("t0", "t1")]
    [t.start() for t in threads]
    [t.join(timeout=300) for t in threads]
    assert not any(t.is_alive() for t in threads)
    stats = store.namespace_stats()
    for sid in ("s0", "s1", "t0", "t1"):
        assert stats[sid] == solo.io_stats, sid
    for sid in ("t0", "t1"):
        np.testing.assert_array_equal(results[sid].eigenvalues,
                                      solo.eigenvalues)
    parent = store.stats.as_dict()
    for field in ("host_bytes_read", "host_bytes_written", "host_reads",
                  "host_writes", "cache_hits", "cache_misses", "passes",
                  "pass_bytes_read"):
        assert sum(d[field] for d in stats.values()) == parent[field], field
    before = store.namespace("t0").device_bytes()
    assert before > 0
    store.drop_namespace("t0")
    assert store.namespace("t0").device_bytes() == 0
    assert store.namespace_stats()["t0"] == stats["t0"]
