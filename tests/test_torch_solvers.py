"""The rest of the solver family in the port against the JAX package:
block Lanczos, LOBPCG, the SVD, the spectral transforms and the
substrate they need (restricted passes, lazy MvScale and the other
Table 1 operations, SVQB), each on the same numpy inputs.

Both packages get the same operators (the reference's TiledMatrix fields
through `convert.tiled_from_arrays`) and the same start blocks: the
reference draws them with `jax.random.normal(PRNGKey(seed), ...)` inside
each solver, and the tests hand those draws to the port as `x0` / `v0`.
Tolerances, stated per test:
  * Ritz values, singular values and untransformed eigenvalues: rtol 1e-5;
  * LOBPCG's θ iterate for iterate: rtol 1e-5 (the two packages' float32
    Grams round differently, ~2e-6 at θ ≈ 1);
  * `IOStats`, passes and pass bytes: equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_eigen as ref_bench
from repro import core as R
from repro.core import residuals as ref_residuals
from repro.graphs import normalized_adjacency as ref_normalized_adjacency
from repro.graphs import pack_tiles as ref_pack_tiles
from repro.graphs import synth as ref_synth
from repro_torch import core as P
from repro_torch.benchmarks import bench_eigen
from repro_torch.convert import tiled_from_arrays
from repro_torch.core import residuals, solver as port_solver
from repro_torch.graphs import synth
from repro_torch.obs import Tracer

N, NNZ = 1200, 10000
RTOL = 1e-5


def _draw(shape, seed=0):
    """The reference solvers' start-block draw."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                      jnp.float32))


def _pack(n, r, c, v):
    return ref_pack_tiles(n, n, r, c, v, block_shape=(64, 64),
                          min_block_nnz=4)


@pytest.fixture(scope="module")
def tm():
    r, c, v = ref_synth.rmat_graph(N, NNZ, seed=5, symmetric=True)
    return _pack(N, *ref_normalized_adjacency(N, r, c, v))


def _ref_op(tm, store=None):
    return R.GraphOperator(tm, store=store, impl="ref")


def _port_op(tm, store=None, **kw):
    if store is None:
        kw.setdefault("device", "cpu")
    return P.GraphOperator(tiled_from_arrays(dataclasses.asdict(tm)),
                           store=store, **kw)


def _stores():
    return R.TieredStore(), P.TieredStore(device="cpu")


# ------------------------------------------------------------ graphs
@pytest.mark.parametrize("name, args, kw", [
    ("knn_band_graph", (1500,), dict(k=6, seed=3)),
    ("knn_band_graph", (700,), dict(k=4, bandwidth=9, seed=1)),
    ("clustered_web_graph", (800, 6000), dict(seed=2)),
    ("clustered_web_graph", (3000, 20000), dict(n_domains=16, seed=4,
                                                p_intra=0.7)),
    ("erdos_renyi", (900, 5000), dict(seed=6)),
    ("erdos_renyi", (900, 5000), dict(seed=6, symmetric=False)),
])
def test_synth_graphs_byte_identical(name, args, kw):
    want = getattr(ref_synth, name)(*args, **kw)
    got = getattr(synth, name)(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# ------------------------------------------------------------ substrate
def _fill(ref_mv, port_mv, widths, seed=1):
    rng = np.random.default_rng(seed)
    for w in widths:
        blk = rng.standard_normal((ref_mv.n, w)).astype(np.float32)
        ref_mv.append_block(jnp.asarray(blk))
        port_mv.append_block(blk)


def _pair(widths, n=300, seed=1):
    rs, ps = _stores()
    ref = R.MultiVector(rs, n, group_size=2)
    port = P.MultiVector(ps, n, group_size=2)
    _fill(ref, port, widths, seed)
    return (rs, ref), (ps, port)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_restricted_pass_and_raw_visits():
    """`block_ids` walks a subset in the given order (visitors see the
    original index), add_matmul's rows span the visited blocks only, and
    axis=None returns the raw parts; counters equal the reference's
    (tolerance: 1e-6 on the products)."""
    (rs, ref), (ps, port) = _pair([3, 2, 4, 3])
    small = np.random.default_rng(2).standard_normal((7, 5)).astype(
        np.float32)
    out = {}
    for tag, mv, mod in (("ref", ref, R), ("port", port, P)):
        p = mod.SubspacePass(mv, block_ids=[2, 0])
        seen = p.add_visit(lambda i, blk, peers: (i, tuple(blk.shape)),
                           axis=None)
        h = p.add_matmul(jnp.asarray(small) if mod is R
                         else torch.from_numpy(small))
        p.run()
        out[tag] = (seen.value, np.asarray(h.value[0]))
    assert out["port"][0] == out["ref"][0] == [(2, (300, 4)), (0, (300, 3))]
    _close(out["port"][1], out["ref"][1])
    with pytest.raises(ValueError):
        P.SubspacePass(port, block_ids=[4])
    assert ps.stats.as_dict() == rs.stats.as_dict()


def test_lazy_scale_and_table1_ops():
    """mv_scale is lazy (zero I/O) and applied once per read; mv_scale_diag,
    mv_add_mv, clone_view, conv_layout and set_block give the reference's
    values (1e-6) and its exact counters."""
    (rs, ref), (ps, port) = _pair([2, 3, 2])
    (rs2, ref2), (ps2, port2) = _pair([2, 3, 2], seed=4)
    for mv in (ref, port):
        mv.mv_scale(2.0)
        mv.mv_scale([1.0, -0.5, 3.0])
    assert ps.stats.as_dict() == rs.stats.as_dict()
    _close(port.to_dense(), ref.to_dense())
    vec = np.linspace(-1.0, 2.0, 7).astype(np.float32)
    ref.mv_scale_diag(jnp.asarray(vec))
    port.mv_scale_diag(vec)
    _close(port.to_dense(), ref.to_dense())
    ref_sum = ref.mv_add_mv(0.5, ref2, -2.0)
    port_sum = port.mv_add_mv(0.5, port2, -2.0)
    assert port_sum.block_widths() == [2, 3, 2]
    _close(port_sum.to_dense(), ref_sum.to_dense())
    idx = [6, 0, 3, 4]
    _close(port.clone_view(idx), ref.clone_view(idx))
    _close(port.conv_layout(), ref.conv_layout())
    blk = np.full((300, 3), 0.25, np.float32)
    for mv, b in ((ref, jnp.asarray(blk)), (port, blk)):
        mv.mv_scale(4.0)
        mv.set_block(1, b)          # resets the block's lazy scale only
    _close(port.block(1), ref.block(1))
    dense = port.to_dense()
    _close(dense, ref.to_dense())
    _close(dense[:, 2:5], blk)
    with pytest.raises(ValueError):
        port.set_block(0, blk)
    assert ps.stats.as_dict() == rs.stats.as_dict()
    assert ps2.stats.as_dict() == rs2.stats.as_dict()


def test_mv_random_draws_from_a_torch_generator():
    """mv_random takes an explicit generator (the same draws for the same
    seed); filled with the reference's draw through set_block the two
    subspaces agree exactly, with equal counters."""
    rs, ps = _stores()
    ref = R.MultiVector(rs, 256)
    port = P.MultiVector(ps, 256)
    ref.mv_random(jax.random.PRNGKey(3), [4, 2])
    port.mv_random(torch.Generator().manual_seed(3), [4, 2])
    draws = []
    for _ in range(2):
        mv = P.MultiVector(P.TieredStore(device="cpu"), 256)
        mv.mv_random(torch.Generator().manual_seed(5), [3, 1])
        draws.append(mv.to_dense())
    gen = torch.Generator().manual_seed(5)
    want = torch.cat([torch.randn((256, 3), generator=gen),
                      torch.randn((256, 1), generator=gen)], dim=1)
    assert torch.equal(draws[0], want) and torch.equal(draws[1], want)
    assert port.block_widths() == ref.block_widths() == [4, 2]
    for i in range(2):
        blk = ref.block(i)
        port.block(i)
        port.set_block(i, np.asarray(blk))
        ref.set_block(i, blk)
    np.testing.assert_array_equal(port.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    assert ps.stats.as_dict() == rs.stats.as_dict()


@pytest.mark.parametrize("n, b, cond", [(500, 4, 1.0), (1216, 8, 1e3),
                                        (333, 6, 1e5)])
def test_svqb_full_rank(n, b, cond):
    """On a full-rank block svqb gives an orthonormal Q and the reference's
    rank; T and Q equal the reference's up to column signs (rtol 1e-4 of
    the largest entry: eigh's vectors differ in the last bits)."""
    rng = np.random.default_rng(b)
    x = (rng.standard_normal((n, b))
         * np.logspace(0, np.log10(cond), b)).astype(np.float32)
    t_ref, r_ref = R.svqb_transform(jnp.asarray(x), impl="ref")
    q_ref, _ = R.svqb(jnp.asarray(x), impl="ref")
    t, rank = P.svqb_transform(torch.from_numpy(x))
    q, rank_q = P.svqb(torch.from_numpy(x))
    assert rank == rank_q == r_ref == b
    assert P.ortho_error(q) < 1e-4

    def signed(m):
        m = np.asarray(m, np.float64)
        return m * np.sign(m[np.argmax(np.abs(m), axis=0),
                             np.arange(m.shape[1])])

    for got, want in ((t.numpy(), t_ref), (q.numpy(), q_ref)):
        want = signed(want)
        np.testing.assert_allclose(signed(got), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_svqb_rank_detection_with_float32_tol():
    """A rank-2 block in 3 columns: the float32 Gram's null eigenvalue is
    rounding noise (~1e-8), so the rank test needs a tol for float32; with
    tol=1e-6 the port reports rank 2 and zeroes the null direction."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 2)).astype(np.float32)
    x = np.concatenate([x, (x[:, :1] + x[:, 1:])], axis=1)
    q, rank = P.svqb(torch.from_numpy(x), tol=1e-6)
    assert rank == 2
    norms = torch.linalg.norm(q, dim=0)
    assert int((norms > 0.5).sum()) == 2 and int((norms == 0).sum()) == 1
    kept = q[:, norms > 0.5]
    assert P.ortho_error(kept) < 1e-5


def test_ritz_residual_bounds_match_reference():
    rng = np.random.default_rng(3)
    s = rng.standard_normal((4, 12))
    y = rng.standard_normal((12, 5))
    np.testing.assert_allclose(
        residuals.ritz_residual_bounds(s, y),
        np.asarray(ref_residuals.ritz_residual_bounds(jnp.asarray(s),
                                                      jnp.asarray(y))),
        rtol=1e-5)


# ------------------------------------------------------------ operators
def test_normal_operator_from_tiles_matches_reference():
    """AᵀA over a directed graph: both images built non-symmetric, the
    product equal to the reference's (1e-5 of Σ|terms| bound, taken as
    rtol 1e-5, atol 1e-5), the image bytes accounted twice per apply."""
    n = 800
    r, c, v = ref_synth.clustered_web_graph(n, 6000, seed=2)
    tma, tmat = _pack(n, r, c, v), _pack(n, c, r, v)
    rs, ps = _stores()
    ref = R.NormalOperator.from_tiles(tma, tmat, store=rs, impl="ref")
    port = P.NormalOperator.from_tiles(
        tiled_from_arrays(dataclasses.asdict(tma)),
        tiled_from_arrays(dataclasses.asdict(tmat)), store=ps)
    assert not port.a.symmetric and not port.at.symmetric
    assert P.GraphOperator(tiled_from_arrays(dataclasses.asdict(tma)),
                           device="cpu").symmetric
    x = _draw((port.n, 3), seed=4)
    _close(port.matmat(torch.from_numpy(x)), ref.matmat(jnp.asarray(x)),
           rtol=1e-5, atol=1e-5)
    assert ps.stats.as_dict() == rs.stats.as_dict()
    assert not port.stream_image


@pytest.mark.disk
def test_normal_operator_streamed_images(disk_tmp):
    """from_tiles(stream_image=True) spills both images into the SAFS
    store: the product equals the resident operator's bit for bit (the
    spans' plans take the whole image's chunk; the COO sum runs in a fixed
    order under deterministic algorithms), the page reads equal the
    reference's, and delete_image drops both spills."""
    n = 800
    r, c, v = ref_synth.clustered_web_graph(n, 6000, seed=2)
    tma, tmat = _pack(n, r, c, v), _pack(n, c, r, v)
    ptma, ptmat = (tiled_from_arrays(dataclasses.asdict(t))
                   for t in (tma, tmat))
    kw = dict(backend="safs", backend_opts={"root": os.path.join(
        disk_tmp, "p")})
    ps = P.TieredStore(device="cpu", **kw)
    rs = R.TieredStore(backend="safs", backend_opts={"root": os.path.join(
        disk_tmp, "r")})
    port = P.NormalOperator.from_tiles(ptma, ptmat, store=ps,
                                       stream_image=True,
                                       image_chunk_bytes=1 << 16, name="N")
    ref = R.NormalOperator.from_tiles(tma, tmat, store=rs, impl="ref",
                                      stream_image=True,
                                      image_chunk_bytes=1 << 16, name="N")
    resident = P.NormalOperator.from_tiles(ptma, ptmat, device="cpu")
    assert port.stream_image and not resident.stream_image
    x = _draw((port.n, 2), seed=6)
    torch.use_deterministic_algorithms(True)
    try:
        got = port.matmat(torch.from_numpy(x))
        want = resident.matmat(torch.from_numpy(x))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got, want)
    _close(got, ref.matmat(jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    for key in ("host_bytes_read", "host_reads", "host_bytes_written"):
        assert ps.stats.as_dict()[key] == rs.stats.as_dict()[key], key
    assert any(name.startswith("N/At/") for name in ps.names())
    port.delete_image()
    assert not any(name.startswith("N/") for name in ps.names())
    ps.close()
    rs.close()


def test_estimate_spectral_range_with_v0(tm):
    """The same start vector gives the reference's interval (rtol 1e-5),
    which brackets the spectrum; without v0 the port draws its own."""
    lo_r, hi_r = R.estimate_spectral_range(_ref_op(tm))
    v0 = _draw((tm.shape[0], 1))
    lo, hi = P.estimate_spectral_range(_port_op(tm), v0=v0)
    np.testing.assert_allclose([lo, hi], [lo_r, hi_r], rtol=RTOL)
    assert lo < -1.0 < 1.0 < hi
    lo2, hi2 = P.estimate_spectral_range(_port_op(tm), seed=3, iters=20)
    assert lo2 < -0.9 and hi2 > 0.9
    with pytest.raises(ValueError, match="v0"):
        P.estimate_spectral_range(_port_op(tm), v0=v0[:10])


def test_capabilities_of_the_transforms(tm):
    op = _port_op(tm)
    assert P.capabilities(op) == frozenset()
    si = P.ShiftInvertOperator(op, -1.5, inner_solver="cg")
    ch = P.ChebyshevFilterOperator(op, (-1.0, 0.5), degree=6)
    for t in (si, ch):
        assert P.capabilities(t) == frozenset({P.CAP_SPECTRAL_TRANSFORM})
        assert t.device == op.device and t.n == op.n
    with pytest.raises(ValueError, match="vec"):
        ch.untransform(np.ones(2), None)
    with pytest.raises(ValueError, match="hi > lo"):
        P.ChebyshevFilterOperator(op, (0.5, 0.5))
    with pytest.raises(ValueError, match="cg"):
        P.ShiftInvertOperator(op, 0.0, inner_solver="gmres")


def test_capabilities_honour_the_legacy_attribute(tm):
    """An operator that predates the protocol and sets only the legacy
    `supports_fused_expand = True` declares the fused expansion, as the
    reference's `capabilities` adapts it; one with neither declares
    nothing; a shift-invert transform over the legacy operator drops the
    capability explicitly."""
    op = _port_op(tm)

    class Legacy:
        supports_fused_expand = True
        n, device = op.n, op.device

    class Plain:
        n, device = op.n, op.device

    for cls, want in ((Legacy, {P.CAP_FUSED_EXPAND}), (Plain, set())):
        assert P.capabilities(cls()) == frozenset(want)
        assert R.capabilities(cls()) == frozenset(want)
    si = P.ShiftInvertOperator(Legacy(), 0.5, inner_solver="cg")
    assert P.capabilities(si) == frozenset({P.CAP_SPECTRAL_TRANSFORM})


# ------------------------------------------------------------ Lanczos
@pytest.mark.parametrize("fused", [True, False])
def test_lanczos_matches_reference(tm, fused):
    """Block Lanczos, no restarts: the Ritz values and residual bounds of
    every expansion step (callback) and at the end at rtol 1e-5, with
    equal IOStats."""
    rs, ps = _stores()
    ref_trace, trace = [], []
    ref = R.lanczos_eigsh(
        _ref_op(tm, rs), 8, block_size=4, num_blocks=12, which="LM",
        store=rs, impl="ref", fused_passes=fused,
        callback=lambda i, th, r: ref_trace.append(th))
    res = P.lanczos_eigsh(
        _port_op(tm, ps), 8, block_size=4, num_blocks=12, which="LM",
        store=ps, fused_passes=fused, x0=_draw((tm.shape[0], 4)),
        callback=lambda i, th, r: trace.append(th))
    assert len(trace) == len(ref_trace) == 12
    for got, want in zip(trace, ref_trace):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    np.testing.assert_allclose(res.residuals, ref.residuals, rtol=1e-3,
                               atol=1e-6)
    assert (res.n_ops, res.m_subspace, res.converged) == (
        ref.n_ops, ref.m_subspace, ref.converged)
    assert res.io_stats == ref.io_stats
    assert tuple(res.eigenvectors.shape) == (tm.shape[0], 8)


# ------------------------------------------------------------ LOBPCG
def _lobpcg_expected_io(it: int, n: int, b: int, fused: bool):
    """The module-docstring accounting for a run that converges at
    iteration `it` (≥ 1) with P never fully deflating; B = n·b·4."""
    bb = n * b * 4
    if fused:
        return 3 * it + 1, (10 + 14 * (it - 1) + 2) * bb
    return 8 * it, (16 + 29 * (it - 1) + 2) * bb


def _ref_lobpcg(tm, store, **kw):
    trace = []
    res = R.lobpcg(
        _ref_op(tm, store), 4, block_size=8, which="LA", store=store,
        callback=lambda i, th, r: trace.append((th, r)), **kw)
    return res, trace


def _port_lobpcg(tm, store, **kw):
    trace = []
    res = P.lobpcg(
        _port_op(tm, store), 4, block_size=8, which="LA", store=store,
        x0=_draw((tm.shape[0], 8)),
        callback=lambda i, th, r: trace.append((th, r)), **kw)
    return res, trace


@pytest.mark.parametrize("fused", [True, False])
def test_lobpcg_iterate_for_iterate(tm, fused):
    """θ and the residual norms of every iteration against the
    reference's (θ rtol 1e-5; residuals rtol 2e-2 or 1e-5 absolute, a
    hundredth of tol: their leading digits decide convergence, and a
    converged pair sits at each package's own float32 floor), the same
    converged iteration at tol 1e-3 (the
    residual crosses it by a factor 2 in one step in both packages), and
    equal IOStats; the pass identity of the module docstring holds."""
    rs, ps = _stores()
    ref, ref_trace = _ref_lobpcg(tm, rs, tol=1e-3, max_iters=300,
                                 fused_passes=fused)
    res, trace = _port_lobpcg(tm, ps, tol=1e-3, max_iters=300,
                              fused_passes=fused)
    assert ref.converged and res.converged
    assert len(trace) == len(ref_trace) == res.n_restarts + 1
    for (th, r), (th_r, r_r) in zip(trace, ref_trace):
        np.testing.assert_allclose(th, th_r, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(r, r_r, rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    assert (res.n_restarts, res.n_ops, res.m_subspace) == (
        ref.n_restarts, ref.n_ops, ref.m_subspace)
    assert res.io_stats == ref.io_stats
    passes, nbytes = _lobpcg_expected_io(res.n_restarts, tm.shape[0], 8,
                                         fused)
    assert res.io_stats["passes"] == passes
    assert res.io_stats["pass_bytes_read"] == nbytes
    assert tuple(res.eigenvectors.shape) == (tm.shape[0], 4)


def _safs_store(mod, root, n, **kw):
    return mod.TieredStore(device_budget_bytes=2 * n * 4 * 8, backend="safs",
                           backend_opts={"root": root,
                                         "cache_bytes": 3 * n * 4 * 8},
                           **kw)


@pytest.mark.disk
@pytest.mark.parametrize("backend", ["ram", "safs"])
def test_lobpcg_pass_accounting_byte_exact(tm, disk_tmp, backend):
    """[X, W, P] in RAM or in SAFS page files: passes and pass bytes
    follow the docstring identity exactly and equal the reference's, with
    the same spectrum (rtol 1e-5)."""
    n = tm.shape[0]
    if backend == "ram":
        rs, ps = _stores()
    else:
        rs = _safs_store(R, os.path.join(disk_tmp, "ref"), n)
        ps = _safs_store(P, os.path.join(disk_tmp, "port"), n, device="cpu")
    ref, _ = _ref_lobpcg(tm, rs, tol=1e-3, max_iters=300)
    res, _ = _port_lobpcg(tm, ps, tol=1e-3, max_iters=300)
    assert res.converged and ref.converged
    passes, nbytes = _lobpcg_expected_io(res.n_restarts, n, 8, True)
    for r in (res, ref):
        assert r.io_stats["passes"] == passes, backend
        assert r.io_stats["pass_bytes_read"] == nbytes, backend
    assert res.io_stats == ref.io_stats
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    if backend == "safs":
        assert ps.backend.stats.host_bytes_read > 0
        ps.close()
        rs.close()


def test_lobpcg_stall_guard_and_impl_default(tm):
    """With an unreachable tol the solver stops at its float32 floor and
    returns the best iterate, whose eigenvalues are the reference's
    converged ones (rtol 1e-5); the port's `impl` defaults to "auto"."""
    ref, _ = _ref_lobpcg(tm, R.TieredStore(), tol=1e-3, max_iters=300)
    res, _ = _port_lobpcg(tm, P.TieredStore(device="cpu"), tol=1e-12,
                          max_iters=120, stall_iters=6)
    assert not res.converged and res.n_restarts < 119
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=RTOL)
    import inspect
    assert inspect.signature(P.lobpcg).parameters["impl"].default == "auto"
    from repro_torch.ckpt import SolveCheckpointer
    # a resume-only checkpointer on an empty root starts the solve afresh
    fresh = P.lobpcg(_port_op(tm), 4, tol=1e-3, max_iters=300,
                     checkpointer=SolveCheckpointer(
                         None, method="lobpcg", resume_from=os.devnull))
    assert fresh.converged and fresh.resumed_step is None
    with pytest.raises(ValueError, match="LA"):
        P.lobpcg(_port_op(tm), 4, which="LM")


# ------------------------------------------------------------ SVD
def test_svds_matches_reference():
    """The 800-vertex directed page graph: σ at rtol 1e-5, equal IOStats,
    and A v = u σ to 1e-4 of ‖σ‖."""
    n = 800
    r, c, v = ref_synth.clustered_web_graph(n, 6000, seed=2)
    tma, tmat = _pack(n, r, c, v), _pack(n, c, r, v)
    rs, ps = _stores()
    ref = R.svds(R.GraphOperator(tma, store=rs, impl="ref"),
                 R.GraphOperator(tmat, store=rs, impl="ref"), 5,
                 block_size=2, tol=1e-6, max_restarts=150, store=rs,
                 impl="ref")
    a_op = _port_op(tma, ps)
    res = P.svds(a_op, _port_op(tmat, ps), 5, block_size=2, tol=1e-6,
                 max_restarts=150, store=ps, x0=_draw((a_op.n, 2)))
    assert res.converged and ref.converged
    np.testing.assert_allclose(res.s, ref.s, rtol=RTOL)
    assert res.io_stats == ref.io_stats
    assert (res.n_restarts, res.n_ops) == (ref.n_restarts, ref.n_ops)
    av = a_op.matmat(res.v)
    err = torch.linalg.norm(av - res.u * torch.from_numpy(res.s).float())
    assert float(err) / np.linalg.norm(res.s) < 1e-4


# ------------------------------------------------------------ transforms
@pytest.mark.parametrize("inner", ["cg", "cgnr"])
def test_shift_invert_matches_reference(tm, inner):
    """σ below the spectrum: the untransformed eigenvalues equal the
    reference's (rtol 1e-5), as do the inner CG iterations, and the
    residuals are true residuals of A (< 1e-4)."""
    maxiter = 500 if inner == "cg" else 300
    ref_si = R.ShiftInvertOperator(_ref_op(tm), -1.5, inner_solver=inner,
                                   cg_tol=1e-8, cg_maxiter=maxiter)
    ref = R.solve(ref_si, 3, method="krylov_schur", tol=1e-6, max_iters=100,
                  block_size=4, impl="ref")
    si = P.ShiftInvertOperator(_port_op(tm), -1.5, inner_solver=inner,
                               cg_tol=1e-8, cg_maxiter=maxiter)
    res = P.solve(si, 3, method="krylov_schur", tol=1e-6, max_iters=100,
                  block_size=4, x0=_draw((tm.shape[0], 4)))
    assert res.converged and ref.converged
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    assert abs(si.n_inner_iters - ref_si.n_inner_iters) <= 0.02 * \
        ref_si.n_inner_iters
    assert np.all(res.residuals < 1e-4)
    assert res.io_stats == ref.io_stats


def test_chebyshev_filter_matches_reference(tm):
    """estimate_spectral_range, then p(A) damping everything below the top
    pairs: untransformed eigenvalues and true residuals at rtol 1e-5 of
    the reference's, equal IOStats."""
    ref_lo, _ = R.estimate_spectral_range(_ref_op(tm))
    lo, _ = P.estimate_spectral_range(_port_op(tm),
                                      v0=_draw((tm.shape[0], 1)))
    ref_ch = R.ChebyshevFilterOperator(_ref_op(tm), (ref_lo, 0.6), degree=8)
    ref = R.solve(ref_ch, 2, method="krylov_schur", tol=1e-6, max_iters=100,
                  block_size=2, impl="ref")
    ch = P.ChebyshevFilterOperator(_port_op(tm), (lo, 0.6), degree=8)
    res = P.solve(ch, 2, method="krylov_schur", tol=1e-6, max_iters=100,
                  block_size=2, x0=_draw((tm.shape[0], 2)))
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    np.testing.assert_allclose(res.residuals, ref.residuals, rtol=1e-2,
                               atol=1e-6)
    assert res.converged == ref.converged and res.io_stats == ref.io_stats


def test_lobpcg_on_a_transform_takes_la(tm):
    """LOBPCG through a shift-invert transform: "LM" becomes "LA" and the
    result is the reference's (rtol 1e-5)."""
    ref_si = R.ShiftInvertOperator(_ref_op(tm), -1.5, inner_solver="cg",
                                   cg_tol=1e-8, cg_maxiter=500)
    ref = R.solve(ref_si, 2, method="lobpcg", tol=1e-4, max_iters=60,
                  block_size=4, impl="ref")
    si = P.ShiftInvertOperator(_port_op(tm), -1.5, inner_solver="cg",
                               cg_tol=1e-8, cg_maxiter=500)
    res = P.solve(si, 2, method="lobpcg", tol=1e-4, max_iters=60,
                  block_size=4, x0=_draw((tm.shape[0], 4)))
    assert res.converged == ref.converged
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)


# ------------------------------------------------------------ dispatch
def test_registry_and_dispatch(tm):
    assert {"krylov_schur", "lanczos", "lobpcg", "svd"} <= set(
        P.solver_names())
    op = _port_op(tm)
    with pytest.raises(ValueError, match="unknown method"):
        P.solve(op, 1, method="nope")
    with pytest.raises(ValueError, match="at_op"):
        P.solve(op, 2, method="svd")
    t = P.solve(op, 2, method="lobpcg", tol=1e-3, max_iters=300,
                trace=Tracer())
    assert t.converged and t.trace.counts()["spans"] > 0
    with pytest.raises(ValueError, match="checkpoint/resume"):
        P.solve(op, 2, method="svd", checkpoint=object())
    seen = {}

    class Spy:
        name = "lobpcg"
        default_which = "LA"

        def solve(self, ctx):
            seen["which"], seen["x0"] = ctx.which, ctx.options.get("x0")
            return R.EigResult(eigenvalues=np.array([0.5]),
                               eigenvectors=None, residuals=np.zeros(1),
                               n_restarts=0, n_ops=0, m_subspace=0,
                               converged=True)

    real = port_solver._REGISTRY["lobpcg"]
    P.register_solver(Spy())
    try:
        si = P.ShiftInvertOperator(op, -1.5)
        res = P.solve(si, 1, method="lobpcg", x0="start")
        assert seen == {"which": "LA", "x0": "start"}
        np.testing.assert_allclose(res.eigenvalues, [-1.5 + 2.0])
        P.solve(op, 1, method="lobpcg")
        assert seen["which"] == "LA"
    finally:
        P.register_solver(real)
    assert port_solver._REGISTRY["lobpcg"] is real


@pytest.mark.parametrize("method, kw", [
    ("krylov_schur", dict(block_size=4, max_iters=100)),
    ("lanczos", dict(block_size=4, num_blocks=40)),
    ("lobpcg", dict(block_size=8, max_iters=300)),
])
def test_solve_dispatch_matches_reference(tm, method, kw):
    """Each member through `solve` with the reference's start block: the
    reference's eigenvalues (rtol 1e-5) and IOStats."""
    rs, ps = _stores()
    ref = R.solve(_ref_op(tm, rs), 4, method=method, which="LA", tol=1e-3,
                  store=rs, impl="ref", **kw)
    res = P.solve(_port_op(tm, ps), 4, method=method, which="LA", tol=1e-3,
                  store=ps, x0=_draw((tm.shape[0], kw["block_size"])), **kw)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
    assert res.io_stats == ref.io_stats
    assert res.converged == ref.converged


# ------------------------------------------------------------ bench + example
def _bench_start_blocks(nev=4):
    n = 1216            # the smoke graph's rows, padded to the block grid
    return {"krylov_schur": _draw((n, 4)), "lobpcg": _draw((n, 2 * nev))}


@pytest.mark.disk
def test_bench_eigen_smoke_against_reference():
    """`--smoke`: Krylov–Schur's logical counters equal the reference's
    current run to the byte; LOBPCG's follow the pass identity and its
    spectrum passes `validate`. (At the smoke's tol 1e-6 the reference's
    LOBPCG sits at its own float32 floor, ~2.7e-6, and converges when its
    noise dips below tol; the iteration counts then differ, see the next
    test.)"""
    ref = ref_bench.collect(smoke=True)["family"]
    got = bench_eigen.collect(smoke=True, device="cpu",
                              start_blocks=_bench_start_blocks())
    bench_eigen.validate(got)
    fam = got["family"]
    keys = ("iters", "n_ops", "host_bytes_read", "host_bytes_written",
            "passes", "pass_bytes_read", "bytes_per_converged_pair")
    for k in keys:
        assert fam["krylov_schur"][k] == ref["krylov_schur"][k], k
    lo = fam["lobpcg"]
    passes, nbytes = _lobpcg_expected_io(lo["iters"], 1216, 8, True)
    assert (lo["passes"], lo["pass_bytes_read"]) == (passes, nbytes)
    np.testing.assert_allclose(fam["krylov_schur"]["eigenvalues"],
                               ref["krylov_schur"]["eigenvalues"], rtol=RTOL)


@pytest.mark.disk
def test_bench_eigen_family_counters_equal_reference(disk_tmp):
    """The family comparison at tol 1e-5, where both packages' LOBPCG
    converge at the same iteration: every logical counter of both methods
    equals the reference's, and the spectra agree at rtol 1e-5."""
    ref = ref_bench._solver_family(os.path.join(disk_tmp, "r"), 1200, 10000,
                                   4, 1e-5)
    got = bench_eigen._solver_family(os.path.join(disk_tmp, "p"), 1200,
                                     10000, 4, 1e-5, "cpu",
                                     _bench_start_blocks())
    for m in ("krylov_schur", "lobpcg"):
        for k in ("iters", "n_ops", "host_bytes_read", "host_bytes_written",
                  "passes", "pass_bytes_read", "bytes_per_converged_pair"):
            assert got[m][k] == ref[m][k], (m, k)
        np.testing.assert_allclose(got[m]["eigenvalues"],
                                   ref[m]["eigenvalues"], rtol=RTOL)
    assert got["lobpcg_bytes_over_ks"] == ref["lobpcg_bytes_over_ks"]


def test_spectral_cluster_example_on_the_cpu(capsys):
    """`python -m repro_torch.examples.spectral_cluster --device cpu`: the
    planted partition is recovered by each method and view."""
    from repro_torch.examples import spectral_cluster
    for argv in ([], ["--method", "lobpcg"], ["--laplacian"]):
        purity = spectral_cluster.main(argv + ["--device", "cpu"])
        assert purity > 0.9
    assert "cluster purity" in capsys.readouterr().out
