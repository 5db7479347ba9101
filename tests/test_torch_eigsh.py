"""Krylov–Schur in the port against the JAX package, restart by restart.

Both packages get the same operator (the reference's TiledMatrix fields
through `convert.tiled_from_arrays`) and the same start block: the
reference draws it with `jax.random.normal(PRNGKey(0), (n, 4))` inside
its eigsh (seed=0), and the test hands that draw to the port as `x0`.
Ritz values agree to rtol 1e-5 at every restart and the I/O counters
are equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GraphOperator as RefGraphOperator
from repro.core import TieredStore as RefTieredStore
from repro.core import eigsh as ref_eigsh
from repro.graphs import pack_tiles as ref_pack_tiles
from repro.graphs.synth import rmat_spectral as ref_rmat_spectral
from repro.graphs.synth import to_dense
from repro_torch.convert import tiled_from_arrays
from repro_torch.core import (GraphOperator, TieredStore, eigsh, solve,
                              solver_names, true_residuals)

N, NNZ, NEV, B = 1200, 10000, 8, 4
RTOL = 1e-5


@pytest.fixture(scope="module")
def graph():
    r, c, v = ref_rmat_spectral(N, NNZ, seed=5)
    tm = ref_pack_tiles(N, N, r, c, v, block_shape=(64, 64),
                        min_block_nnz=4)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      (tm.shape[0], B), jnp.float32))
    return (r, c, v), tm, x0


def _ref_solve(tm, fused, **kw):
    store = RefTieredStore()
    trace = []
    res = ref_eigsh(RefGraphOperator(tm, store=store, impl="ref"), NEV,
                    block_size=B, store=store, impl="ref", seed=0,
                    fused_passes=fused,
                    callback=lambda i, th, rs: trace.append(th), **kw)
    return res, trace


def _port_op(tm):
    store = TieredStore(device="cpu")
    return GraphOperator(tiled_from_arrays(dataclasses.asdict(tm)),
                         store=store), store


@pytest.mark.parametrize("fused", [True, False])
def test_ritz_values_restart_by_restart(graph, fused):
    _, tm, x0 = graph
    ref, ref_trace = _ref_solve(tm, fused, tol=0.0, max_restarts=3)
    op, store = _port_op(tm)
    trace = []
    res = eigsh(op, NEV, block_size=B, tol=0.0, max_restarts=3, store=store,
                x0=x0, fused_passes=fused,
                callback=lambda i, th, rs: trace.append(th))
    assert len(trace) == len(ref_trace) == 3
    for got, want in zip(trace, ref_trace):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert not res.converged and not ref.converged
    assert res.n_restarts == ref.n_restarts and res.n_ops == ref.n_ops
    assert res.io_stats == ref.io_stats


def test_converged_spectrum_matches_reference_and_dense(graph):
    (r, c, v), tm, x0 = graph
    ref, _ = _ref_solve(tm, True, tol=1e-6, max_restarts=200)
    op, store = _port_op(tm)
    res = eigsh(op, NEV, block_size=B, tol=1e-6, max_restarts=200,
                store=store, x0=x0)
    assert res.converged and ref.converged
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    assert res.n_restarts == ref.n_restarts
    assert res.io_stats == ref.io_stats
    ev = np.linalg.eigvalsh(to_dense(N, r, c, v).astype(np.float64))
    ev = ev[np.argsort(-np.abs(ev))][:NEV]
    np.testing.assert_allclose(np.sort(res.eigenvalues), np.sort(ev),
                               rtol=RTOL)
    assert tuple(res.eigenvectors.shape) == (op.n, NEV)
    assert np.all(true_residuals(op, res.eigenvectors, res.eigenvalues)
                  < 1e-4)


def test_solve_runs_krylov_schur(graph):
    _, tm, x0 = graph
    ref, _ = _ref_solve(tm, True, tol=1e-6, max_restarts=200)
    op, store = _port_op(tm)
    assert "krylov_schur" in solver_names()
    res = solve(op, NEV, method="krylov_schur", block_size=B, tol=1e-6,
                max_iters=200, store=store, x0=x0)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    assert res.io_stats == ref.io_stats
    # without x0 the port draws its own start block from a torch.Generator
    # on the operator's device: another start, the same spectrum
    res2 = solve(op, NEV, block_size=B, tol=1e-6, max_iters=200, seed=3)
    assert res2.converged
    np.testing.assert_allclose(np.sort(res2.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=RTOL)


def test_solve_raises_for_what_is_not_ported(graph, tmp_path):
    """The whole family is registered; tracing and checkpoint/resume work
    as in the reference (a traced solve returns its Tracer, a checkpointed
    one commits snapshots a resume continues from, Lanczos refuses both
    with ValueError), an unknown method is a ValueError, and the sharded
    operator's fused expansion, once refused here, runs: `solve` over a
    one-rank DistOperator takes the fused branch and finds the spectrum
    of the GraphOperator solves."""
    from repro_torch.ckpt import CheckpointPolicy, SolveCheckpointer
    from repro_torch.ckpt.checkpoint import valid_steps
    from repro_torch.obs import Tracer
    _, tm, x0 = graph
    op, store = _port_op(tm)
    assert {"lanczos", "lobpcg", "svd"} <= set(solver_names())
    path = tmp_path / "t.jsonl"
    res = solve(op, NEV, store=store, tol=1e-6, max_iters=200, x0=x0,
                trace=path)
    assert isinstance(res.trace, Tracer) and path.exists()
    root = str(tmp_path / "ck")
    op, store = _port_op(tm)
    full = solve(op, NEV, store=store, tol=1e-6, max_iters=200, x0=x0,
                 checkpoint=CheckpointPolicy(root=root, every_restarts=1))
    assert full.converged and full.resumed_step is None
    assert valid_steps(os.path.join(root, "state"))[-1] == full.n_restarts
    op, store = _port_op(tm)
    resumed = solve(op, NEV, store=store, tol=1e-6, max_iters=200,
                    resume=root)
    assert resumed.resumed_step == full.n_restarts
    np.testing.assert_array_equal(resumed.eigenvalues, full.eigenvalues)
    with pytest.raises(ValueError, match="checkpoint/resume"):
        solve(op, NEV, method="lanczos", store=store, resume=root)
    with pytest.raises(ValueError, match="unknown method"):
        solve(op, NEV, method="davidson", store=store)
    op, store = _port_op(tm)
    direct = eigsh(op, NEV, store=store, tol=1e-6, max_restarts=200,
                   checkpointer=SolveCheckpointer(
                       None, method="krylov_schur", resume_from=root,
                       params={"nev": NEV, "which": "LM",
                               "block_size": B}))
    np.testing.assert_array_equal(direct.eigenvalues, full.eigenvalues)

    from repro_torch.dist import DistOperator
    (r, c, v), _, _ = graph
    dop = DistOperator(N, r, c, v, device="cpu")
    fused = solve(dop, NEV, tol=1e-6, max_iters=200)
    assert fused.converged and dop.n_fused_steps > 0
    np.testing.assert_allclose(np.sort(fused.eigenvalues),
                               np.sort(full.eigenvalues), rtol=RTOL)


@pytest.mark.parametrize("fused", [True, False])
def test_e2e_io_counters_equal_reference(graph, fused):
    """The bench_subspace_io e2e solve (n=1200, nev=8, tol=1e-7), fused and
    unfused: the port converges at the same restart and streams the same
    bytes and passes as the reference. (The archived figures in
    results/BENCH_subspace_io.json, 26 restarts, came from an older jax;
    the reference itself now takes 29 restarts at this tolerance, which
    sits at the f32 floor.)"""
    _, tm, x0 = graph
    ref, _ = _ref_solve(tm, fused, tol=1e-7, max_restarts=200)
    op, store = _port_op(tm)
    res = eigsh(op, NEV, block_size=B, tol=1e-7, max_restarts=200,
                store=store, x0=x0, fused_passes=fused)
    assert res.converged == ref.converged
    assert res.n_restarts == ref.n_restarts
    assert res.io_stats == ref.io_stats
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)


def test_ritz_values_restart_by_restart_on_bf16_image():
    """Krylov–Schur over a bf16 image (numpy's ml_dtypes.bfloat16 blocks)
    of a packed normalized-adjacency R-MAT graph, in both packages from
    the same start block (the reference's draw from seed 0): Ritz values agree at rtol 1e-5 at every restart
    and the I/O counters, which count the bf16 image's bytes, are equal."""
    import ml_dtypes
    from repro.graphs import rmat_graph as ref_rmat_graph
    from repro.graphs.laplacian import normalized_adjacency as ref_normalized
    r, c, v = ref_rmat_graph(N, NNZ, seed=41, symmetric=True)
    r, c, v = ref_normalized(N, r, c, v)
    tm = ref_pack_tiles(N, N, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    tm16 = dataclasses.replace(tm, blocks=tm.blocks.astype(ml_dtypes.bfloat16))
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      (tm.shape[0], B), jnp.float32))
    ref_store = RefTieredStore()
    ref_trace = []
    ref = ref_eigsh(RefGraphOperator(tm16, store=ref_store, impl="ref"), NEV,
                    block_size=B, store=ref_store, impl="ref", seed=0,
                    tol=0.0, max_restarts=4,
                    callback=lambda i, th, rs: ref_trace.append(th))
    store = TieredStore(device="cpu")
    port_tm = dataclasses.replace(tiled_from_arrays(dataclasses.asdict(tm)),
                                  blocks=tm16.blocks)
    op = GraphOperator(port_tm, store=store)
    trace = []
    res = eigsh(op, NEV, block_size=B, tol=0.0, max_restarts=4, store=store,
                x0=x0, callback=lambda i, th, rs: trace.append(th))
    assert len(trace) == len(ref_trace) == 4
    for got, want in zip(trace, ref_trace):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert res.n_ops == ref.n_ops
    assert res.io_stats == ref.io_stats
    assert res.io_stats["host_bytes_read"] >= res.n_ops * tm16.nbytes_image()


# ------------------------------------------------------- the SAFS page store
def _safs_opts(root, defaults):
    """Page-store options: the defaults (prefetch and write-behind on, a
    64 MiB cache), or a cache of 6 pages with both threads off, where
    the physical counters are exact after a flush."""
    if defaults:
        return {"root": root}
    return {"root": root, "cache_bytes": 6 * 4096, "enable_prefetch": False,
            "write_behind": False}


@pytest.mark.disk
@pytest.mark.parametrize("defaults", [False, True])
@pytest.mark.parametrize("budget_blocks", [0, 3])
def test_krylov_schur_on_safs_matches_reference(graph, disk_tmp,
                                                budget_blocks, defaults):
    """The subspace in SAFS page files in both packages, at device budgets
    of 0 and 3 blocks: Ritz values at rtol 1e-5 and logical IOStats equal
    at every restart. With the threads off the physical counters are
    equal after a flush; with the defaults they stay within the logical
    ones."""
    _, tm, x0 = graph
    budget = budget_blocks * tm.shape[0] * B * 4
    ref_store = RefTieredStore(budget, backend="safs", backend_opts=_safs_opts(
        os.path.join(disk_tmp, "ref"), defaults))
    ref_trace = []
    ref_eigsh(RefGraphOperator(tm, store=ref_store, impl="ref"), NEV,
              block_size=B, store=ref_store, impl="ref", seed=0, tol=0.0,
              max_restarts=3, callback=lambda i, th, rs: ref_trace.append(
                  (th, ref_store.stats.as_dict())))
    store = TieredStore(budget, backend="safs", device="cpu",
                        backend_opts=_safs_opts(
                            os.path.join(disk_tmp, "port"), defaults))
    trace = []
    eigsh(GraphOperator(tiled_from_arrays(dataclasses.asdict(tm)),
                        store=store), NEV, block_size=B, store=store,
          tol=0.0, max_restarts=3, x0=x0,
          callback=lambda i, th, rs: trace.append((th,
                                                   store.stats.as_dict())))
    assert len(trace) == len(ref_trace) == 3
    for (got, io), (want, ref_io) in zip(trace, ref_trace):
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert io == ref_io
    ref_store.flush()
    store.flush()
    phys = store.backend.stats_dict()["io"]
    ref_phys = ref_store.backend.stats_dict()["io"]
    logical = store.stats
    if defaults:
        assert phys["host_bytes_read"] <= logical.host_bytes_read
        assert phys["host_bytes_written"] <= logical.host_bytes_written
    else:
        assert phys == ref_phys
        assert phys["host_bytes_read"] > 0 and phys["host_bytes_written"] > 0
    ref_store.close()
    store.close()


def _bf16_image(tm, dtype):
    port_tm = tiled_from_arrays(dataclasses.asdict(tm))
    if dtype == "float32":
        return tm, port_tm
    import ml_dtypes
    blocks = tm.blocks.astype(ml_dtypes.bfloat16)
    return (dataclasses.replace(tm, blocks=blocks),
            dataclasses.replace(port_tm, blocks=blocks))


@pytest.mark.disk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_image_matches_reference(disk_tmp, dtype):
    """GraphOperator(stream_image=True) over a SAFS store in both packages:
    the same spans spilled as read-only entries, matmat within 1e-6 of
    Σ|terms| of the reference's streamed matmat and equal to the port's
    resident one, IOStats equal, ReadOnlyError on a write to a span, and
    delete_image leaving no entries."""
    from repro.graphs import rmat_graph as ref_rmat_graph
    from repro.graphs.laplacian import normalized_adjacency as ref_normalized
    from repro_torch.core import ReadOnlyError
    r, c, v = ref_rmat_graph(N, NNZ, seed=41, symmetric=True)
    r, c, v = ref_normalized(N, r, c, v)
    ref_tm, tm = _bf16_image(ref_pack_tiles(N, N, r, c, v,
                                            block_shape=(64, 64),
                                            min_block_nnz=4), dtype)
    opts = {"cache_bytes": 8 * 4096}
    ref_store = RefTieredStore(backend="safs", backend_opts={
        "root": os.path.join(disk_tmp, "ref"), **opts})
    store = TieredStore(backend="safs", device="cpu", backend_opts={
        "root": os.path.join(disk_tmp, "port"), **opts})
    ref_op = RefGraphOperator(ref_tm, store=ref_store, impl="ref",
                              stream_image=True, image_chunk_bytes=1 << 16,
                              name="A")
    op = GraphOperator(tm, store=store, stream_image=True,
                       image_chunk_bytes=1 << 16, name="A")
    assert sorted(store.names()) == sorted(ref_store.names())
    assert len(op._spans) > 4 and op._has_coo
    assert store.stats.as_dict() == ref_store.stats.as_dict()
    resident = GraphOperator(tm, device="cpu")
    x = np.random.default_rng(3).standard_normal((op.n, B)).astype(
        np.float32)
    abs_a = np.abs(ref_tm.to_dense().astype(np.float64))
    scale = abs_a @ np.abs(x.astype(np.float64))
    for _ in range(2):
        y = op.matmat(torch.from_numpy(x))
        want = np.asarray(ref_op.matmat(jnp.asarray(x)))
        assert np.all(np.abs(y.numpy() - want) <= 1e-6 * scale)
        assert torch.equal(y, resident.matmat(torch.from_numpy(x)))
        assert store.stats.as_dict() == ref_store.stats.as_dict()
    span = op._spans[0].name
    with pytest.raises(ReadOnlyError, match="read-only"):
        store.put(span, torch.zeros(4))
    with pytest.raises(ReadOnlyError, match="read-only"):
        store.put("A/coo_vals", torch.zeros(4))
    assert torch.equal(op.matmat(torch.from_numpy(x)), y)  # image unharmed
    ref_op.matmat(jnp.asarray(x))
    op.delete_image()
    ref_op.delete_image()
    assert store.names() == [] and store.backend.data_ids() == []
    assert store.stats.as_dict() == ref_store.stats.as_dict()
    ref_store.close()
    store.close()


@pytest.mark.disk
def test_krylov_schur_on_streamed_image_matches_reference(graph, disk_tmp):
    """The paper's full out-of-core setting in both packages: subspace and
    matrix image in SAFS page files, Ritz values at rtol 1e-5 and
    logical IOStats equal at every restart."""
    _, tm, x0 = graph

    def opts(sub):
        return {"root": os.path.join(disk_tmp, sub),
                "cache_bytes": 16 * 4096}

    ref_store = RefTieredStore(2 * tm.shape[0] * B * 4, backend="safs",
                               backend_opts=opts("ref"))
    ref_op = RefGraphOperator(tm, store=ref_store, impl="ref",
                              stream_image=True, image_chunk_bytes=1 << 16)
    ref_trace = []
    ref_eigsh(ref_op, NEV, block_size=B, store=ref_store, impl="ref",
              seed=0, tol=0.0, max_restarts=2,
              callback=lambda i, th, rs: ref_trace.append(
                  (th, ref_store.stats.as_dict())))
    store = TieredStore(2 * tm.shape[0] * B * 4, backend="safs",
                        device="cpu", backend_opts=opts("port"))
    op = GraphOperator(tiled_from_arrays(dataclasses.asdict(tm)),
                       store=store, stream_image=True,
                       image_chunk_bytes=1 << 16)
    trace = []
    eigsh(op, NEV, block_size=B, store=store, tol=0.0, max_restarts=2,
          x0=x0, callback=lambda i, th, rs: trace.append(
              (th, store.stats.as_dict())))
    assert len(trace) == len(ref_trace) == 2
    for (got, io), (want, ref_io) in zip(trace, ref_trace):
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert io == ref_io
    ref_store.close()
    store.close()


# -------------------------------------------------- image formats on "SSD"
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_gio_images_cross_packages(tmp_path, writer):
    """`save_image` in one package, `load_image` in the other: the same
    fields, bytes and manifest; `stream_tile_rows` walks them alike."""
    from repro.graphs import gio as ref_gio
    from repro.graphs import rmat_graph as ref_rmat_graph
    from repro_torch.graphs import gio
    r, c, v = ref_rmat_graph(400, 3000, seed=1, symmetric=True)
    ref_tm = ref_pack_tiles(400, 400, r, c, v, block_shape=(16, 16),
                            min_block_nnz=2)
    tm = tiled_from_arrays(dataclasses.asdict(ref_tm))
    save, load = ((ref_gio.save_image, gio.load_image) if writer == "ref"
                  else (gio.save_image, ref_gio.load_image))
    save(str(tmp_path / "a"), ref_tm if writer == "ref" else tm)
    (ref_gio if writer == "port" else gio).save_image(
        str(tmp_path / "b"), tm if writer == "ref" else ref_tm)
    for f in ("manifest.json",):
        assert (tmp_path / "a" / f).read_bytes() == \
            (tmp_path / "b" / f).read_bytes()
    got = load(str(tmp_path / "a"))
    for name in ("blocks", "block_cols", "row_ptr", "coo_rows", "coo_cols",
                 "coo_vals"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref_tm, name))
    assert tuple(got.shape) == ref_tm.shape
    assert tuple(got.block_shape) == ref_tm.block_shape
    assert list(gio.stream_tile_rows(tm)) and all(
        a[0] == b[0] and a[3] == b[3] and np.array_equal(a[1], b[1])
        for a, b in zip(gio.stream_tile_rows(tm),
                        ref_gio.stream_tile_rows(ref_tm)))


def test_scsr_codec_matches_reference():
    """The paper's 2-byte SCSR+COO tile codec: the same bytes as the
    reference's for random tiles (empty, single-entry rows, dense rows),
    decoded back to the same entries."""
    from repro.graphs import tiles as ref_tiles
    from repro_torch.graphs import tiles
    rng = np.random.default_rng(8)
    for n_entries, shape in ((0, (64, 64)), (1, (8, 8)), (300, (64, 128)),
                             (5000, (512, 512))):
        rows = rng.integers(0, shape[0], n_entries).astype(np.int32)
        cols = rng.integers(0, shape[1], n_entries).astype(np.int32)
        keep = np.unique(rows.astype(np.int64) * shape[1] + cols,
                         return_index=True)[1]
        rows, cols = rows[keep], cols[keep]
        buf = tiles.scsr_encode_tile(rows, cols, shape)
        assert buf == ref_tiles.scsr_encode_tile(rows, cols, shape)
        got, want = tiles.scsr_decode_tile(buf), \
            ref_tiles.scsr_decode_tile(buf)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert tiles.scsr_tile_nbytes(rows) == \
            ref_tiles.scsr_tile_nbytes(rows) == len(buf)
    with pytest.raises(ValueError, match="exceeds SCSR max"):
        tiles.scsr_encode_tile(rows, cols, (tiles.MAX_TILE + 1, 8))
