"""The solver family's transforms, dispatch, bench and example in the port
against the JAX package (the second half of tests/test_torch_solvers.py,
split off so that `--dist loadfile` can run the halves on two workers;
its fixtures, helpers and tolerances are imported from there):
shift-invert (cg and cgnr inner solves), the Chebyshev filter, LOBPCG on
a transform, the registry and `solve` dispatch, `bench_eigen` and the
spectral-cluster example.
"""
import os

import numpy as np
import pytest
import torch

from benchmarks import bench_eigen as ref_bench
from repro import core as R
from repro_torch import core as P
from repro_torch.benchmarks import bench_eigen
from repro_torch.core import solver as port_solver
from repro_torch.obs import Tracer

# the first half's fixture, helpers and tolerance (its module, on
# pytest's path)
from test_torch_solvers import (RTOL, _draw, _lobpcg_expected_io, _port_op,
                                _ref_op, _stores, tm)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread, restored after each test: the inner CG
    solves are many small products, which run slowest when six xdist
    workers each spread them over every core (test_torch_hvp.py does the
    same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
