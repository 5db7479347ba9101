"""Krylov–Schur in the port against the JAX package, restart by restart.

Both packages get the same operator (the reference's TiledMatrix fields
through `convert.tiled_from_arrays`) and the same start block: the
reference draws it with `jax.random.normal(PRNGKey(0), (n, 4))` inside
its eigsh (seed=0), and the test hands that draw to the port as `x0`.
Ritz values agree to rtol 1e-5 at every restart and the I/O counters
are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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


def test_solve_raises_for_what_is_not_ported(graph):
    _, tm, _ = graph
    op, store = _port_op(tm)
    for method in ("lanczos", "lobpcg", "svd"):
        with pytest.raises(NotImplementedError, match="item 4"):
            solve(op, NEV, method=method, store=store)
    with pytest.raises(ValueError, match="unknown method"):
        solve(op, NEV, method="davidson", store=store)
    for kw in ({"trace": "t.jsonl"}, {"checkpoint": object()},
               {"resume": "ckpt"}):
        with pytest.raises(NotImplementedError, match="item 5"):
            solve(op, NEV, store=store, **kw)
    with pytest.raises(NotImplementedError, match="item 5"):
        eigsh(op, NEV, store=store, checkpointer=object())


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
