"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every case is marked `gpu` and skips without a CUDA device; on
a machine with one (no JAX needed) run

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerance: rtol 1e-6 of the output's largest magnitude for SpMM and
TSGEMM; a Gram entry sums n products, so its difference is held to 1e-6
of the sum of the products' magnitudes.
"""
import numpy as np
import pytest
import torch

from repro_torch.graphs import pack_tiles, rmat_graph
from repro_torch.kernels import ops, spmm_tile

RTOL = 1e-6


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = RTOL * max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,nnz,bm,k", [
    (256, 2000, 16, 4), (512, 4000, 32, 8), (1024, 8000, 64, 1),
    (4096, 40000, 64, 4)])
def test_spmm_kernel_vs_plain_on_card(cuda, n, nnz, bm, k, rng):
    r, c, v = rmat_graph(n, nnz, seed=n, symmetric=True)
    tm = pack_tiles(n, n, r, c, v, block_shape=(bm, bm), min_block_nnz=1)
    x = _t(rng.standard_normal((tm.shape[1], k)).astype(np.float32)).to(cuda)
    args = [_t(a).to(cuda) for a in (tm.blocks, tm.block_cols, tm.row_ptr)]
    before = spmm_tile.LAUNCHES
    got = ops.spmm_blocks(*args, x)
    assert spmm_tile.LAUNCHES == before + 1
    want = ops.spmm_blocks(*args, x, impl="ref")
    _close(got.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,b", [(2 ** 20, 4, 4), (4097, 3, 5),
                                   (1000, 24, 8)])
def test_gram_tsgemm_kernels_vs_plain_on_card(cuda, n, m, b, rng):
    a = _t(rng.standard_normal((n, m)).astype(np.float32)).to(cuda)
    bb = _t(rng.standard_normal((n, b)).astype(np.float32)).to(cuda)
    small = _t(rng.standard_normal((m, b)).astype(np.float32)).to(cuda)
    g = ops.gram(a, bb, alpha=2.0)
    assert torch.equal(g, ops.gram(a, bb, alpha=2.0))   # fixed sum order
    want = ops.gram(a, bb, alpha=2.0, impl="ref").cpu().double()
    absdot = 2.0 * a.abs().T.double() @ bb.abs().double()
    assert torch.all((g.cpu().double() - want).abs() <= RTOL * absdot.cpu())
    c = ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=bb)
    _close(c.cpu(), ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=bb,
                               impl="ref").cpu())
    with pytest.raises(TypeError, match="bf16|float32"):
        ops.gram(a.bfloat16(), bb.bfloat16())


@pytest.mark.gpu
def test_small_solve_on_card_matches_cpu(cuda):
    """The whole Krylov–Schur path through the kernels and a pinned host
    tier, held to the same solve on the CPU's plain versions."""
    from repro_torch.core import GraphOperator, TieredStore, eigsh
    from repro_torch.graphs import rmat_spectral
    from repro_torch.kernels import gram, tsgemm
    n = 1200
    r, c, v = rmat_spectral(n, 10000, seed=5)
    tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    x0 = np.random.default_rng(0).standard_normal((tm.shape[0], 4)).astype(
        np.float32)
    out = {}
    for dev in ("cpu", cuda):
        store = TieredStore(device=dev)
        op = GraphOperator(tm, store=store)
        counts = [m.LAUNCHES for m in (spmm_tile, gram, tsgemm)]
        trace = []
        res = eigsh(op, 8, tol=0.0, max_restarts=4, store=store, x0=x0,
                    callback=lambda i, th, rs: trace.append(th))
        out[str(dev)] = res, trace
        launched = [m.LAUNCHES - k for m, k in
                    zip((spmm_tile, gram, tsgemm), counts)]
        assert all(launched) == (dev != "cpu"), launched
    (cpu, cpu_trace), (gpu, gpu_trace) = out["cpu"], out[str(cuda)]
    for got, want in zip(gpu_trace, cpu_trace):        # restart by restart
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert gpu.io_stats == cpu.io_stats
    assert gpu.eigenvectors.is_cuda
