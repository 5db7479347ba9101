"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every case is marked `gpu` and skips without a CUDA device; on
a machine with one (no JAX needed) run

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerance: rtol 1e-6 of the output's largest magnitude for SpMM (split
rows sum their chunks in another order than the plain version; bf16
blocks are widened exactly, so the same holds for them) and TSGEMM; a
Gram entry sums n products, so its difference is held to 1e-6
of the sum of the products' magnitudes. The solver family's widths
(SpMM at k = 1, 2, 8; gram's tile kernels at 2, 8, 16 and 24 columns,
with gram(A, A) exactly symmetric; tsgemm's vec8x8 and pair2x2, also
bit for bit against the generic kernel) are held the same way, and
LOBPCG and the spectral transforms on the card to the same solves on
the CPU's plain versions (rtol 1e-5). Flash attention's backward is held
to its plain backward and to the float64 gradient (`FLASH_BWD_TOL`, with
the reasons), bit-identical run to run. Flash attention is held to its
plain version run in float32 on the same inputs: 2e-5 of the output's
largest magnitude for float32 (sums in another order and another exp),
2^-8 of it for bf16, whose output is rounded once to bf16 (half an ulp,
2^-9 to 2^-8 of the value) and whose weights go into the PV product as
a bf16 pair (P_hi + P_lo, 16 bits) on the tensor cores. A solve
suspended at a restart boundary and resumed on the card is held bit for
bit to the uninterrupted one under `torch.use_deterministic_algorithms`
(which needs `CUBLAS_WORKSPACE_CONFIG` set before cuBLAS starts: the
CholQR's small products run on cuBLAS). The SpMM ring kernel's own
cases on random normal blocks, which cancel, hold it and the plain
version to float32's sum bound of the float64 product (γ_{m+1}·Σ|terms|
for m terms, any order), and on small integers to the plain version bit
for bit.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.graphs import pack_tiles, rmat_graph
from repro_torch.kernels import flashattn, gram, ops, spmm_tile, tsgemm
from repro_torch.kernels.flashattn_ref import (attention_ref_lse,
                                               flash_attention_bwd_ref)
from repro_torch.kernels.spmm_ref import float32_sum_bound, spmm_f64

# cuBLAS reads it when its first handle is made; set before any test runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
@pytest.mark.parametrize("chunk", [None, 7])
def test_spmm_kernel_splits_heavy_rows(cuda, chunk):
    """One block row of 3,200 blocks among light and empty rows: its
    chunks run on separate CTAs and a second launch sums their partials
    in chunk order, bit-identical from run to run. The entries are small
    integers, so every partial sum is exact in float32 and any order of
    summation gives the same bits: the kernel must equal its plain
    version, which a block counted twice, missed or put in the wrong row
    would break."""
    g = np.random.default_rng(21)
    bm, bn, k, n_cols, n_rows = 32, 32, 4, 64, 48
    counts = g.integers(1, 40, n_rows)
    counts[[0, 9, n_rows - 1]] = 0
    counts[5] = 3200
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nb = int(ptr[-1])
    blocks = g.integers(-2, 3, (nb, bm, bn)).astype(np.float32)
    cols = g.integers(0, n_cols, nb).astype(np.int32)
    x = _t(g.integers(-2, 3, (n_cols * bn, k)).astype(np.float32)).to(cuda)
    args = [_t(a).to(cuda) for a in (blocks, cols, ptr)]
    plan = spmm_tile.plan(args[2], chunk=chunk)
    assert plan.row_ptr is args[2]
    assert plan.splits.shape[0] >= 1 and plan.heaviest <= plan.chunk
    if chunk is None:      # set against this card's SMs
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert plan.chunk == spmm_tile.default_chunk(nb, sms)
    before = spmm_tile.LAUNCHES
    got = ops.spmm_blocks(*args, x, plan=plan)
    assert spmm_tile.LAUNCHES == before + 1
    assert torch.equal(got, ops.spmm_blocks(*args, x, plan=plan))
    if chunk is None:      # the wrapper's own plan of row_ptr is the same
        assert torch.equal(got, ops.spmm_blocks(*args, x))
    want = ops.spmm_blocks(*args, x, impl="ref")
    _close(got.cpu(), want.cpu())
    assert torch.equal(got, want)
    rows = got.reshape(n_rows, bm, k)
    assert torch.all(rows[[0, 9, n_rows - 1]] == 0)
    # a plan of another row_ptr is refused, even one of the same block
    # rows and blocks (the heavy row moved) or of an equal copy
    moved = np.concatenate([[0], np.cumsum(np.roll(counts, 1))])
    for other in (ptr[:-1], moved, ptr):
        other = spmm_tile.plan(_t(other.astype(np.int32)).to(cuda),
                               chunk=chunk)
        with pytest.raises(ValueError, match="another row_ptr"):
            ops.spmm_blocks(*args, x, plan=other)
    with pytest.raises(ValueError, match="row_ptr covers"):
        ops.spmm_blocks(args[0][:-1], args[1][:-1], args[2], x, plan=plan)


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
@pytest.mark.parametrize("n,nnz,bm,k", [
    (256, 2000, 16, 4), (512, 4000, 32, 8), (1024, 8000, 64, 1),
    (4096, 40000, 64, 4)])
def test_spmm_bf16_kernel_vs_plain_on_card(cuda, n, nnz, bm, k):
    """bf16 blocks (16-byte loads of 8 values, widened to float32 in
    shared memory) against the plain version on the same bf16 blocks;
    Y float32, bit-identical run to run. A bf16 X is widened once by the
    wrapper, so it gives the bits of its float32 copy."""
    g = np.random.default_rng(61)
    r, c, v = rmat_graph(n, nnz, seed=n, symmetric=True)
    tm = pack_tiles(n, n, r, c, v, block_shape=(bm, bm), min_block_nnz=1)
    x = _t(g.standard_normal((tm.shape[1], k)).astype(np.float32)).to(cuda)
    blocks = _t(tm.blocks).to(cuda).bfloat16()
    args = [blocks] + [_t(a).to(cuda) for a in (tm.block_cols, tm.row_ptr)]
    before = spmm_tile.LAUNCHES, spmm_tile.LAUNCHES_BF16
    got = ops.spmm_blocks(*args, x)
    assert (spmm_tile.LAUNCHES, spmm_tile.LAUNCHES_BF16) == (before[0] + 1,
                                                             before[1] + 1)
    assert got.dtype == torch.float32
    assert torch.equal(got, ops.spmm_blocks(*args, x))
    _close(got.cpu(), ops.spmm_blocks(*args, x, impl="ref").cpu())
    xb = x.bfloat16()
    assert torch.equal(ops.spmm_blocks(*args, xb),
                       ops.spmm_blocks(*args, xb.float()))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 7])
def test_spmm_bf16_kernel_splits_heavy_rows(cuda, chunk):
    """The 3,200-block row of `test_spmm_kernel_splits_heavy_rows` with
    bf16 blocks of small integers (exact in bf16, and every sum of their
    products exact in float32): the kernel must equal its plain version,
    and the float32 image of the same values, bit for bit."""
    g = np.random.default_rng(21)
    bm, bn, k, n_cols, n_rows = 32, 32, 4, 64, 48
    counts = g.integers(1, 40, n_rows)
    counts[[0, 9, n_rows - 1]] = 0
    counts[5] = 3200
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nb = int(ptr[-1])
    blocks = _t(g.integers(-2, 3, (nb, bm, bn)).astype(np.float32)).to(cuda)
    cols = _t(g.integers(0, n_cols, nb).astype(np.int32)).to(cuda)
    x = _t(g.integers(-2, 3, (n_cols * bn, k)).astype(np.float32)).to(cuda)
    ptr = _t(ptr).to(cuda)
    plan = spmm_tile.plan(ptr, chunk=chunk)
    assert plan.splits.shape[0] >= 1
    b16 = blocks.bfloat16()
    before = spmm_tile.LAUNCHES
    got = ops.spmm_blocks(b16, cols, ptr, x, plan=plan)
    assert spmm_tile.LAUNCHES == before + 1
    assert torch.equal(got, ops.spmm_blocks(b16, cols, ptr, x, plan=plan))
    assert torch.equal(got, ops.spmm_blocks(b16, cols, ptr, x, impl="ref"))
    assert torch.equal(got, ops.spmm_blocks(blocks, cols, ptr, x, plan=plan))
    assert torch.all(got.reshape(n_rows, bm, k)[[0, 9, n_rows - 1]] == 0)
    with pytest.raises(ValueError, match="bn % 8 == 0"):
        ops.spmm_blocks(b16[:, :, :4].contiguous(), cols, ptr,
                        x[:n_cols * 4])


def _ring_image(g, bm, bn, counts, n_cols, ints=False):
    """A block image of `counts` blocks per block row (0 for an empty
    row) over n_cols block columns: float32 blocks (small integers with
    `ints`) and their int32 block columns and row_ptr, on the CPU."""
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nb = int(ptr[-1])
    if ints:
        blocks = g.integers(-2, 3, (nb, bm, bn)).astype(np.float32)
    else:
        blocks = g.standard_normal((nb, bm, bn)).astype(np.float32)
    cols = g.integers(0, n_cols, nb).astype(np.int32)
    return _t(blocks), _t(cols), _t(ptr)


def _within_sum_bound(got, blocks, cols, ptr, x):
    """got and the plain version each within float32_sum_bound of the
    float64 product: γ_{m+1}·Σ|terms| for a row of m nonzero terms, the
    bound on any float32 sum of those terms, whatever its order (random
    normal blocks cancel, so a tolerance on the output's magnitude does
    not fit them)."""
    none = torch.zeros(0, dtype=torch.int32, device=x.device)
    y64, terms, count = spmm_f64(blocks, cols, ptr, (none, none,
                                                     none.float()), x)
    bound = float32_sum_bound(terms, count, 0.0)
    want = ops.spmm_blocks(blocks, cols, ptr, x, impl="ref")
    for out in (got, want):
        assert torch.all((out.double() - y64).abs() <= bound)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,k", [
    (b, k) for b in (8, 16, 32, 64) for k in (1, 2, 4, 8)] + [
    (64, 3), (64, 5), (64, 16), (32, 24), (8, 40)])
def test_spmm_ring_kernel_vs_plain_on_card(cuda, dtype, bm, k):
    """The ring kernel at every block size and width the suite draws
    (8×8 panels of the sharded layer included), and at widths it pads (3,
    5) or runs in 16-column slabs (24, 40), on an image with empty rows
    and split rows: bit-identical over
    three calls, within float32's sum bound of the float64 product, as
    the plain version is, and, with bf16 blocks, bit-equal to the float32 image of
    the widened values (both sum in one order)."""
    g = np.random.default_rng(1000 * bm + k)
    n_rows, n_cols = 40, 24
    counts = g.integers(0, 12, n_rows)
    counts[[3, 17]] = 0
    counts[7] = 90
    blocks, cols, ptr = (t.to(cuda) for t in _ring_image(
        g, bm, bm, counts, n_cols))
    blocks = blocks.to(dtype)
    x = _t(g.standard_normal((n_cols * bm, k)).astype(np.float32)).to(cuda)
    plan = spmm_tile.plan(ptr, chunk=16)
    assert plan.splits.shape[0] > 0
    before = spmm_tile.LAUNCHES, spmm_tile.LAUNCHES_BY_K.get(k, 0)
    got = ops.spmm_blocks(blocks, cols, ptr, x, plan=plan)
    assert (spmm_tile.LAUNCHES, spmm_tile.LAUNCHES_BY_K[k]) == (
        before[0] + 1, before[1] + 1)
    for _ in range(2):
        assert torch.equal(got, ops.spmm_blocks(blocks, cols, ptr, x,
                                                plan=plan))
    _within_sum_bound(got, blocks, cols, ptr, x)
    assert torch.all(got.reshape(n_rows, bm, k)[[3, 17]] == 0)
    if dtype == torch.bfloat16:
        assert torch.equal(got, ops.spmm_blocks(blocks.float(), cols, ptr,
                                                x, plan=plan))


@pytest.mark.gpu
def test_spmm_ring_kernel_float32_groups_of_four_on_card(cuda):
    """float32 blocks whose bn is not a multiple of 8 (12×12: column
    groups of 4 columns), within float32's sum bound of the float64
    product as the plain version is."""
    g = np.random.default_rng(12)
    counts = g.integers(0, 30, 20)
    blocks, cols, ptr = (t.to(cuda) for t in _ring_image(
        g, 12, 12, counts, 9))
    for k in (1, 4, 8):
        x = _t(g.standard_normal((9 * 12, k)).astype(np.float32)).to(cuda)
        assert spmm_tile.launch_config(torch.float32, 12, 12,
                                       k)["group_width"] == 4
        got = ops.spmm_blocks(blocks, cols, ptr, x)
        assert torch.equal(got, ops.spmm_blocks(blocks, cols, ptr, x))
        _within_sum_bound(got, blocks, cols, ptr, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4, 8])
def test_spmm_items_around_the_ring_on_card(cuda, dtype, k):
    """Work items shorter than, as long as and longer than the ring (1,
    S, S + 1 and 3S + 2 blocks for S stages) and empty rows, whole and
    split into chunks of S blocks, on small integers (every sum exact in
    float32, so any order gives the same bits): equal to the plain
    version."""
    s = spmm_tile.STAGES
    cfg = spmm_tile.occupancy(dtype, 64, 64, k, cuda)
    assert cfg["stages"] == s and cfg["ctas_per_sm"] >= 1
    g = np.random.default_rng(7 + k)
    counts = np.array([0, 1, s, s + 1, 3 * s + 2, 0, 2, s - 1, 3 * s + 2])
    blocks, cols, ptr = (t.to(cuda) for t in _ring_image(
        g, 64, 64, counts, 16, ints=True))
    blocks = blocks.to(dtype)
    x = _t(g.integers(-2, 3, (16 * 64, k)).astype(np.float32)).to(cuda)
    want = ops.spmm_blocks(blocks, cols, ptr, x, impl="ref")
    for chunk in (None, s):
        plan = spmm_tile.plan(ptr, chunk=chunk)
        assert (plan.splits.shape[0] > 0) == (chunk == s)
        got = ops.spmm_blocks(blocks, cols, ptr, x, plan=plan)
        assert torch.equal(got, want)
        assert torch.all(got.reshape(-1, 64, k)[[0, 5]] == 0)


@pytest.mark.gpu
def test_spmm_launch_config_on_card(cuda):
    """The card's launch of the kernel is the one `launch_config`
    computes, at the rmat image's 64×64 blocks, with no spilled bytes at
    k = 1, 2, 4, 8."""
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 2, 4, 8):
            want = spmm_tile.launch_config(dtype, 64, 64, k)
            got = spmm_tile.occupancy(dtype, 64, 64, k, cuda)
            for key in ("threads", "stages", "smem_bytes", "stage_bytes"):
                assert got[key] == want[key], (dtype, k, key)
            assert got["group_width"] == want["group_width"] == 8
            assert got["local_bytes"] == 0, (dtype, k, got)
            assert got["ctas_per_sm"] >= 2, (dtype, k, got)


@pytest.mark.gpu
def test_spmm_refuses_misaligned_x_on_card(cuda):
    """The bulk copies move 16-byte units: an X that starts 4 bytes into
    a buffer is refused before launch, and nothing is counted."""
    g = np.random.default_rng(3)
    blocks, cols, ptr = (t.to(cuda) for t in _ring_image(
        g, 64, 64, np.array([2, 0, 3]), 4))
    flat = torch.zeros(4 * 64 * 4 + 4, device=cuda)
    x = flat[1:-3].view(4 * 64, 4)
    before = spmm_tile.LAUNCHES
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        ops.spmm_blocks(blocks, cols, ptr, x)
    assert spmm_tile.LAUNCHES == before
    x = flat[4:].view(4 * 64, 4)                   # 16 bytes in: aligned
    _within_sum_bound(ops.spmm_blocks(blocks, cols, ptr, x), blocks, cols,
                      ptr, x)


def _gram_case(cuda, n, m, b, seed):
    g = np.random.default_rng(seed)
    a = _t(g.standard_normal((n, m)).astype(np.float32)).to(cuda)
    bb = _t(g.standard_normal((n, b)).astype(np.float32)).to(cuda)
    return a, bb


def _gram_ok(got, a, bb, alpha, exact=False):
    """Within RTOL of Σ|terms| of the plain version, or with `exact` of
    the same products summed in float64."""
    if exact:
        want = alpha * a.double().T @ bb.double()
    else:
        want = ops.gram(a, bb, alpha=alpha, impl="ref").double()
    absdot = abs(alpha) * a.abs().T.double() @ bb.abs().double()
    assert torch.all((got.double() - want).abs() <= RTOL * absdot)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,b", [
    (2 ** 20, 4, 4), (4097, 3, 5), (1, 4, 4), (1, 3, 5), (700, 4, 4),
    (100, 4, 4), (3 * 2 ** 21 + 7, 4, 4), (2 ** 20 + 1, 24, 8)])
def test_gram_kernel_one_launch_bit_identical(cuda, n, m, b):
    """One launch per call (the last CTA to finish sums the partials),
    within tolerance of the plain version and bit-identical over 3 calls,
    at the solver's (4, 4) and at widths the generic kernel takes; n = 1,
    n below one CTA's rows and n past 2^22."""
    a, bb = _gram_case(cuda, n, m, b, seed=n % 1000 + m)
    outs = []
    for i in range(3):
        before = gram.LAUNCHES
        outs.append(ops.gram(a, bb, alpha=-0.5))
        assert gram.LAUNCHES == before + 1
    assert outs[0].shape == (m, b) and outs[0].dtype == torch.float32
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    _gram_ok(outs[0], a, bb, -0.5)
    if m == b == 4 and n > 1:
        # rows 4 bytes off a 16-byte boundary take the generic kernel
        buf = torch.empty(n * 4 + 1, device=cuda)
        a_off = buf[1:].view(n, 4)
        a_off.copy_(a)
        assert a_off.data_ptr() % 16
        _gram_ok(ops.gram(a_off, bb, alpha=-0.5), a, bb, -0.5)


@pytest.mark.gpu
def test_gram_ticket_counter_on_one_and_two_streams(cuda):
    """The last-CTA ticket counter is one per (device, stream) and back at
    0 after every launch: back-to-back grams on one stream, and grams
    interleaved on two streams, each give the bits of a lone call, over
    a mix of the kernels (vec4x4, generic, tile24x24, tile2x2, tile8x8)."""
    cases = [_gram_case(cuda, *shape, seed=71 + i) for i, shape in
             enumerate([(2 ** 20, 4, 4), (300_000, 4, 4), (5000, 3, 5),
                        (70_001, 24, 24), (2 ** 20 + 1, 2, 2),
                        (9000, 8, 8)])]
    before = dict(gram.LAUNCHES_BY_VARIANT)
    want = [ops.gram(x, y) for x, y in cases]
    torch.cuda.synchronize()
    ran = {k: v - before.get(k, 0) for k, v in gram.LAUNCHES_BY_VARIANT.items()}
    assert ran == {"vec4x4": 2, "generic": 1, "tile24x24": 1, "tile2x2": 1,
                   "tile8x8": 1}
    order = [0, 3, 1, 4, 2, 5, 0, 3]
    got = [ops.gram(*cases[i]) for i in order]
    torch.cuda.synchronize()
    assert all(torch.equal(g, want[i]) for g, i in zip(got, order))
    s1, s2 = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream(cuda))
    first, second = [0, 3, 4], [1, 2, 5]
    outs1, outs2 = [], []
    for _ in range(3):
        with torch.cuda.stream(s1):
            outs1 += [ops.gram(*cases[i]) for i in first]
        with torch.cuda.stream(s2):
            outs2 += [ops.gram(*cases[i]) for i in second]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want[first[i % 3]])
               for i, o in enumerate(outs1))
    assert all(torch.equal(o, want[second[i % 3]])
               for i, o in enumerate(outs2))
    keys = {(cuda.index or 0, s.cuda_stream) for s in (s1, s2)}
    counters = [gram._COUNTERS[k] for k in keys]
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert all(int(t.item()) == 0 for t in gram._COUNTERS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [
    (2 ** 20 + 1, 24), (2 ** 20, 8), (4097, 16), (1, 24), (100, 8),
    (2 ** 20, 2), (2 ** 20 + 1, 2), (3, 2), (3 * 2 ** 21 + 7, 16)])
def test_gram_tile_kernels(cuda, n, m):
    """The tile kernels at the solver family's widths: one launch of
    tile<m>x<m> per call, bit-identical over 3 calls, within RTOL of
    Σ|terms| of the plain version, and gram(A, A) exactly symmetric and
    bit-identical too (G[p, q] and G[q, p] sum the same products in the
    same order). n = 2^20 + 1 at 2 columns starts odd intervals 8 bytes
    off a 16-byte boundary; n = 1, 3 and 100 are below one tile. The
    diagonal of gram(A, A) sums n positive products, so Σ|terms| is the
    sum itself: there the oracle is the float64 sum of the products, since
    at n in the millions the plain version's float32 product on the card
    (cuBLAS) strays from it by more than RTOL, where the kernels do not."""
    a, bb = _gram_case(cuda, n, m, m, seed=n % 1000 + m)
    kind = f"tile{m}x{m}"
    for x, y in ((a, bb), (a, a)):
        outs = []
        for _ in range(3):
            before = (gram.LAUNCHES, gram.LAUNCHES_BY_VARIANT.get(kind, 0))
            outs.append(ops.gram(x, y, alpha=-0.5))
            assert (gram.LAUNCHES, gram.LAUNCHES_BY_VARIANT[kind]) == \
                (before[0] + 1, before[1] + 1)
        assert outs[0].shape == (m, m)
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        _gram_ok(outs[0], x, y, -0.5, exact=y is x)
    assert torch.equal(outs[0], outs[0].T)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(2 ** 20, 8), (1001, 8), (1, 8),
                                 (2 ** 20 + 1, 2), (4, 2), (1, 2)])
@pytest.mark.parametrize("with_c0", [True, False])
def test_tsgemm_fast_paths_bit_equal_generic(cuda, n, m, with_c0):
    """vec8x8 and pair2x2 (odd n: a last row alone) give the generic
    kernel's bits: the same data 4 bytes off a 16-byte boundary takes the
    generic kernel, and the results are equal, bit for bit."""
    g = np.random.default_rng(n % 991 + m)
    a = _t(g.standard_normal((n, m)).astype(np.float32)).to(cuda)
    small = _t(g.standard_normal((m, m)).astype(np.float32)).to(cuda)
    c0 = (_t(g.standard_normal((n, m)).astype(np.float32)).to(cuda)
          if with_c0 else None)
    kind = "vec8x8" if m == 8 else "pair2x2"
    before = dict(tsgemm.LAUNCHES_BY_VARIANT)
    got = ops.tsgemm(a, small, alpha=-1.25, beta=0.75, c0=c0)
    a_off = torch.empty(n * m + 1, device=cuda)[1:].view(n, m)
    a_off.copy_(a)
    c0_off = None
    if with_c0:
        c0_off = torch.empty(n * m + 1, device=cuda)[1:].view(n, m)
        c0_off.copy_(c0)
    oracle = ops.tsgemm(a_off, small, alpha=-1.25, beta=0.75, c0=c0_off)
    ran = {k: v - before.get(k, 0)
           for k, v in tsgemm.LAUNCHES_BY_VARIANT.items()}
    assert {k: v for k, v in ran.items() if v} == {kind: 1, "generic": 1}
    assert torch.equal(got, oracle)
    _close(got.cpu(), ops.tsgemm(a, small, alpha=-1.25, beta=0.75, c0=c0,
                                 impl="ref").cpu())


@pytest.mark.gpu
def test_a_variant_that_does_not_fit_raises(cuda, monkeypatch):
    """The C side launches only what fits: a compiled width named for
    another shape, or for a pointer off 16 bytes, is refused and the
    wrapper raises; nothing runs and the ticket counter stays at 0."""
    a, bb = _gram_case(cuda, 5000, 8, 8, seed=5)
    small = torch.ones((8, 8), device=cuda)
    monkeypatch.setattr(gram, "variant", lambda m, b, ok: "tile24x24")
    with pytest.raises(RuntimeError, match="tile24x24"):
        ops.gram(a, bb)
    monkeypatch.setattr(tsgemm, "variant", lambda m, b, ok: "pair2x2")
    with pytest.raises(RuntimeError, match="pair2x2"):
        ops.tsgemm(a, small)
    monkeypatch.setattr(gram, "variant", lambda m, b, ok: "tile8x8")
    a_off = torch.empty(5000 * 8 + 1, device=cuda)[1:].view(5000, 8)
    with pytest.raises(RuntimeError, match="tile8x8"):
        ops.gram(a_off, bb)
    torch.cuda.synchronize()
    assert all(int(t.item()) == 0 for t in gram._COUNTERS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,b", [(2 ** 20, 4, 4), (2 ** 20, 4, 8),
                                   (1000, 24, 8), (333, 5, 3), (1, 4, 8)])
@pytest.mark.parametrize("with_c0", [True, False])
def test_tsgemm_kernel_widths(cuda, n, m, b, with_c0):
    """One thread per row: float4 rows at (4, 4) and (4, 8), the generic
    kernel at other widths; with and without C0, within tolerance of the
    plain version and bit-identical run to run. The float4 kernel keeps
    the generic kernel's arithmetic order, so rows 4 bytes off a 16-byte
    boundary (the generic kernel) give the same bits."""
    g = np.random.default_rng(n % 997 + 10 * b)
    a = _t(g.standard_normal((n, m)).astype(np.float32)).to(cuda)
    small = _t(g.standard_normal((m, b)).astype(np.float32)).to(cuda)
    c0 = (_t(g.standard_normal((n, b)).astype(np.float32)).to(cuda)
          if with_c0 else None)
    kw = dict(alpha=1.5, beta=-0.75, c0=c0)
    before = tsgemm.LAUNCHES
    got = ops.tsgemm(a, small, **kw)
    assert tsgemm.LAUNCHES == before + 1
    assert got.shape == (n, b) and torch.equal(got, ops.tsgemm(a, small, **kw))
    _close(got.cpu(), ops.tsgemm(a, small, impl="ref", **kw).cpu())
    buf = torch.empty(n * m + 1, device=cuda)
    a_off = buf[1:].view(n, m)
    a_off.copy_(a)
    assert torch.equal(got, ops.tsgemm(a_off, small, **kw))


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


@pytest.mark.gpu
@pytest.mark.parametrize("kind, width", [
    ("spmm", 1), ("spmm", 2), ("spmm", 8), ("gram", 2), ("gram", 8),
    ("tsgemm", 2), ("tsgemm", 8)])
def test_solver_family_widths_vs_plain_on_card(cuda, kind, width):
    """The widths the rest of the solver family brings: SpMM at k = 1
    (estimate_spectral_range), 2 (the SVD) and 8 (LOBPCG at nev 8), on an
    image with split heavy rows; gram's tile kernels at (n, 2)ᵀ(n, 2)
    and (n, 8)ᵀ(n, 8); tsgemm's pair2x2 and vec8x8 at (n, 2)·(2, 2) and
    (n, 8)·(8, 8) with C0. One launch each, bit-identical over 3 calls,
    within tolerance of the plain version."""
    g = np.random.default_rng(100 + width)
    if kind == "spmm":
        n = 2 ** 14
        r, c, v = rmat_graph(n, 2 ** 17, seed=3, symmetric=True)
        tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
        args = [_t(a).to(cuda) for a in (tm.blocks, tm.block_cols,
                                         tm.row_ptr)]
        plan = spmm_tile.plan(args[2], chunk=16)
        assert plan.splits.shape[0] > 0
        x = _t(g.standard_normal((n, width)).astype(np.float32)).to(cuda)
        mod, call = spmm_tile, lambda: ops.spmm_blocks(*args, x, plan=plan)
        want = ops.spmm_blocks(*args, x, impl="ref")
    else:
        n = 2 ** 20 + 3
        a = _t(g.standard_normal((n, width)).astype(np.float32)).to(cuda)
        bb = _t(g.standard_normal((n, width)).astype(np.float32)).to(cuda)
        small = _t(g.standard_normal((width, width)).astype(
            np.float32)).to(cuda)
        if kind == "gram":
            mod, call = gram, lambda: ops.gram(a, bb)
        else:
            mod = tsgemm

            def call():
                return ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=bb)
            want = ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=bb,
                              impl="ref")
    outs = []
    for _ in range(3):
        before = mod.LAUNCHES
        outs.append(call())
        assert mod.LAUNCHES == before + 1
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    if kind == "gram":
        _gram_ok(outs[0], a, bb, 1.0)
    else:
        _close(outs[0].cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_lobpcg_on_card_matches_cpu(cuda, fused):
    """LOBPCG at nev 8 (b = 8) through the kernels, held iterate for
    iterate to the same solve on the CPU's plain versions (θ rtol 1e-5),
    with equal IOStats; gram, tsgemm and SpMM all launch."""
    from repro_torch.core import GraphOperator, TieredStore, lobpcg
    from repro_torch.graphs import rmat_spectral
    n = 1200
    r, c, v = rmat_spectral(n, 10000, seed=5)
    tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    x0 = np.random.default_rng(1).standard_normal((tm.shape[0], 8)).astype(
        np.float32)
    out = {}
    for dev in ("cpu", cuda):
        store = TieredStore(device=dev)
        counts = [m.LAUNCHES for m in (spmm_tile, gram, tsgemm)]
        trace = []
        res = lobpcg(GraphOperator(tm, store=store), 8, tol=0.0,
                     max_iters=6, store=store, x0=x0, fused_passes=fused,
                     callback=lambda i, th, rs: trace.append(th))
        launched = [m.LAUNCHES - k for m, k in
                    zip((spmm_tile, gram, tsgemm), counts)]
        assert all(launched) == (dev != "cpu"), launched
        out[str(dev)] = res, trace
    (cpu, cpu_trace), (gpu, gpu_trace) = out["cpu"], out[str(cuda)]
    assert len(gpu_trace) == len(cpu_trace) == 6
    for got, want in zip(gpu_trace, cpu_trace):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert gpu.io_stats == cpu.io_stats
    assert gpu.eigenvectors.is_cuda


@pytest.mark.gpu
def test_transforms_on_card_match_cpu(cuda):
    """Shift-invert (inner CG) and the Chebyshev filter through `solve` on
    the card: the CPU's untransformed eigenvalues at rtol 1e-5, and the
    same inner iterations."""
    from repro_torch.core import (ChebyshevFilterOperator, GraphOperator,
                                  ShiftInvertOperator, solve)
    from repro_torch.graphs import rmat_spectral
    n = 1200
    r, c, v = rmat_spectral(n, 10000, seed=5)
    tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    x0 = np.random.default_rng(2).standard_normal((tm.shape[0], 4)).astype(
        np.float32)
    got = {}
    for dev in ("cpu", cuda):
        si = ShiftInvertOperator(GraphOperator(tm, device=dev), -1.5,
                                 inner_solver="cg", cg_tol=1e-8,
                                 cg_maxiter=500)
        res = solve(si, 3, tol=1e-6, max_iters=100, block_size=4, x0=x0)
        ch = ChebyshevFilterOperator(GraphOperator(tm, device=dev),
                                     (-1.1, 0.6), degree=8)
        res_ch = solve(ch, 2, tol=1e-6, max_iters=100, block_size=4, x0=x0)
        got[str(dev)] = (res.eigenvalues, res_ch.eigenvalues,
                         si.n_inner_iters)
    (si_c, ch_c, it_c), (si_g, ch_g, it_g) = got["cpu"], got[str(cuda)]
    np.testing.assert_allclose(si_g, si_c, rtol=1e-5)
    np.testing.assert_allclose(ch_g, ch_c, rtol=1e-5)
    assert abs(it_g - it_c) <= 0.02 * it_c


def _safs_store(cuda, root, **opts):
    from repro_torch.core import TieredStore
    return TieredStore(backend="safs", device=cuda,
                       backend_opts={"root": str(root), **opts})


@pytest.mark.gpu
def test_safs_store_round_trips_blocks_written_by_kernels(cuda, tmp_path):
    """A block that a kernel is still writing when it is put (or demoted)
    goes to the page file whole: the store waits for the copy to the host
    before it checksums and splits the bytes. A tiny cache sends every
    block to the disk and back; loads come back pinned."""
    from repro_torch.core import HOST
    store = _safs_store(cuda, tmp_path / "s", cache_bytes=4 * 4096)
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((2 ** 22, 4), generator=g, device=cuda)
    want = {}
    for i in range(4):
        small = torch.randn((4, 4), generator=g, device=cuda)
        y = ops.tsgemm(a, small)               # launched, not waited for
        store.put(f"h{i}", y, tier=HOST)
        z = ops.tsgemm(a, small, alpha=2.0)
        store.put(f"d{i}", z)
        store.demote(f"d{i}")                  # dirty: written to the host
        want[f"h{i}"], want[f"d{i}"] = y, z
    store.flush()
    for name, t in want.items():
        assert torch.equal(store.get(name), t), name
    loaded = store.backend.load("h0")
    assert loaded.is_pinned() and loaded.device.type == "cpu"
    phys = store.backend.stats_dict()["io"]
    assert phys["host_bytes_read"] >= sum(
        t.numel() * 4 for t in want.values())
    store.close()


def _heavy_tiled(n_rows, heavy, seed, coo):
    """A square TiledMatrix of 32x32 blocks with one block row of `heavy`
    blocks among light and empty rows, random values, and a COO
    remainder when `coo`."""
    from repro_torch.graphs.tiles import TiledMatrix
    g = np.random.default_rng(seed)
    bm = 32
    counts = g.integers(1, 40, n_rows)
    counts[[0, 9, n_rows - 1]] = 0
    counts[5] = heavy
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nb = int(ptr[-1])
    n = n_rows * bm
    n_coo = 5000 if coo else 0
    return TiledMatrix(
        shape=(n, n), block_shape=(bm, bm),
        blocks=g.standard_normal((nb, bm, bm)).astype(np.float32),
        block_cols=g.integers(0, n_rows, nb).astype(np.int32),
        row_ptr=ptr,
        coo_rows=g.integers(0, n, n_coo).astype(np.int32),
        coo_cols=g.integers(0, n, n_coo).astype(np.int32),
        coo_vals=g.standard_normal(n_coo).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("coo", [False, True])
def test_streamed_matmat_bit_identical_to_resident(cuda, tmp_path, coo):
    """The streamed image runs each span with a plan built with the whole
    image's chunk, so the heavy row splits into the same chunks and a
    streamed matmat equals the resident one bit for bit, with one SpMM
    launch per non-empty span. With a COO remainder the two are equal
    bit for bit under deterministic algorithms (`index_add_` then sums
    in a fixed order). (bf16 streamed images are held to the reference
    on the CPU: numpy's bf16 type is not on the card's machine.)"""
    from repro_torch.core import GraphOperator
    tm = _heavy_tiled(48, 3200, seed=22, coo=coo)
    store = _safs_store(cuda, tmp_path / "img")
    resident = GraphOperator(tm, device=cuda)
    assert resident._plan.n_partials > 0           # the heavy row splits
    streamed = GraphOperator(tm, store=store, stream_image=True,
                             image_chunk_bytes=64 << 10)
    spans = sum(1 for c in streamed._spans if c.n_blocks)
    assert len(streamed._spans) == spans > 2
    assert any(c.plan.n_partials for c in streamed._spans)
    x = torch.randn((tm.shape[0], 4), device=cuda)
    before = spmm_tile.LAUNCHES
    torch.use_deterministic_algorithms(coo)
    try:
        y_s = streamed.matmat(x)
        y_r = resident.matmat(x)
    finally:
        torch.use_deterministic_algorithms(False)
    assert spmm_tile.LAUNCHES - before == spans + 1
    assert torch.equal(y_s, y_r)
    streamed.delete_image()
    assert store.names() == []
    store.close()


@pytest.mark.gpu
def test_page_path_threads_make_no_cuda_call(cuda, tmp_path):
    """A stream of gets from a CUDA SAFS store under
    `torch.cuda.set_sync_debug_mode("error")`: the readahead workers and
    the write-behind drain thread make no call into torch (a profile hook
    on the threads they start sees none), and neither the gets nor the
    fills synchronize the card."""
    import threading
    from repro_torch.core import HOST
    seen = []

    def hook(frame, event, arg):
        if event == "call" and "torch" in frame.f_code.co_filename.split(
                "/"):
            seen.append((threading.current_thread().name,
                         frame.f_code.co_name))
        elif event == "c_call" and (getattr(arg, "__module__", "") or
                                    "").startswith("torch"):
            seen.append((threading.current_thread().name, arg.__name__))

    threading.setprofile(hook)
    try:
        store = _safs_store(cuda, tmp_path / "thr", cache_bytes=64 * 4096)
    finally:
        threading.setprofile(None)
    g = torch.Generator(device=cuda).manual_seed(3)
    blocks = {f"b{i}": torch.randn((20000, 4), generator=g, device=cuda)
              for i in range(12)}
    for name, t in blocks.items():
        store.put(name, t, tier=HOST)
    store.flush()
    torch.cuda.synchronize()
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            got += list(store.stream(list(blocks), readahead=4))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for t, name in zip(got, list(blocks) * 3):
        assert torch.equal(t, blocks[name])
    st = store.backend.stats_dict()["prefetch"]
    assert st["files_prefetched"] > 0 and st["read_errors"] == 0
    store.close()
    assert [s for s in seen if s[0].startswith("safs-")] == []


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -8}


def _flash_inputs(cuda, dtype, b, h, hkv, sq, sk, d, seed):
    g = np.random.default_rng(seed)
    q, k, v = (_t(g.standard_normal(shape).astype(np.float32)).to(cuda)
               .to(dtype) for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                        (b, hkv, sk, d)))
    return q, k, v


def _flash_err(got, q, k, v, causal):
    want = ops.flash_attention(q.float(), k.float(), v.float(),
                               causal=causal, impl="ref")
    scale = float(want.abs().max())
    return float((got.float() - want).abs().max()) / scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_flash_kernel_vs_plain_on_card(cuda, d, causal, dtype):
    """GQA (4 query heads on 2 KV heads), a ragged length (200 is not a
    multiple of the 64-row tiles) and Sq < Sk."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for sq, sk in ((200, 200), (70, 130)):
        q, k, v = _flash_inputs(cuda, dtype, 2, 4, 2, sq, sk, d, seed=d)
        before = flashattn.LAUNCHES
        got = ops.flash_attention(q, k, v, causal=causal)
        assert flashattn.LAUNCHES == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        assert _flash_err(got, q, k, v, causal) <= FLASH_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 8, 1, 1024, 1024, 128, True),     # yi-9b's head dim and grouping
    (1, 2, 2, 96, 160, 64, False)])       # ragged, not causal
def test_flash_kernel_serve_shapes_bit_identical(cuda, b, h, hkv, sq, sk, d,
                                                 causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(cuda, torch.bfloat16, b, h, hkv, sq, sk, d,
                            seed=sq)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))
    assert _flash_err(got, q, k, v, causal) <= FLASH_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_tensor_cores_at_serve_length(cuda, causal):
    """The bf16 path (wgmma, TMA) at yi-9b's head dim and grouping, 8
    query heads on one KV head, over 2,048 positions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(cuda, torch.bfloat16, 1, 8, 1, 2048, 2048, 128,
                            seed=2048)
    before = flashattn.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flashattn.LAUNCHES == before + 1
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))
    assert _flash_err(got, q, k, v, causal) <= FLASH_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_hubert_head_dim(cuda, causal, dtype):
    """d = 80 at hubert-xlarge's prefill shape, q (2, 16, 2048, 80): the
    bf16 kernel runs it on 128 columns (TMA zero-fills 80-127), the
    float32 kernel has an instantiation of its own. One launch each. The
    output is laid out (B, S, H, 80), so a stored padded column would
    overwrite the next head's first columns, and the comparison would
    see it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(cuda, dtype, 2, 16, 16, 2048, 2048, 80,
                            seed=80)
    before = flashattn.LAUNCHES
    at_80 = flashattn.LAUNCHES_BY_D.get(80, 0)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flashattn.LAUNCHES == before + 1
    assert flashattn.LAUNCHES_BY_D[80] == at_80 + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert _flash_err(got, q, k, v, causal) <= FLASH_TOL[dtype]
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


# The backward against the plain backward on the same inputs (the
# kernel's O and LSE): float32 1e-5 of the largest magnitude (sums in
# another order); bf16 2^-7, the gradients being rounded once to bf16
# (2^-9 to 2^-8 of a value) from float32 sums, and the tensor-core route
# rounding P and dS to bf16 for their products (2e-3 to 4e-3 in all in a
# CPU model of it, tests/test_torch_flash_bwd.py). Against the float64
# gradient of the exact forward: float32 1e-5; bf16 2^-6, since
# D = rowsum(dO∘O) then takes the bf16-rounded O, whose error the
# difference dP − D can bring near the size of dS.
FLASH_BWD_TOL = {torch.float32: (1e-5, 1e-5),
                 torch.bfloat16: (2.0 ** -7, 2.0 ** -6)}


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _flash_bwd_check(cuda, dtype, b, h, hkv, sq, sk, d, causal, seed):
    """Kernel backward against the plain one and float64; returns the
    kernel's gradients."""
    g = np.random.default_rng(seed)
    q, k, v = (_t(g.standard_normal((b, s, n, d)).astype(np.float32))
               .to(cuda).to(dtype).transpose(1, 2)
               for s, n in ((sq, h), (sk, hkv), (sk, hkv)))
    do = _t(g.standard_normal((b, h, sq, d)).astype(np.float32)).to(
        cuda).to(dtype)
    o, lse = flashattn.flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(o, flashattn.flash_attention(q, k, v, causal=causal))
    o_ref, lse_ref = attention_ref_lse(q, k, v, causal=causal)
    assert float((lse - lse_ref).abs().max()) <= 1e-5 * float(
        lse_ref.abs().max()) + 1e-5
    before = flashattn.BWD_LAUNCHES
    got = flashattn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert flashattn.BWD_LAUNCHES == before + 1
    again = flashattn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    plain = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(),
                                    causal=causal)
    q6, k6, v6 = q.double(), k.double(), v.double()
    o6, lse6 = attention_ref_lse(q6, k6, v6, causal=causal)
    exact = flash_attention_bwd_ref(q6, k6, v6, o6, lse6, do.double(),
                                    causal=causal)
    tol_plain, tol_exact = FLASH_BWD_TOL[dtype]
    for x, y, p, e, t in zip(got, again, plain, exact, (q, k, v)):
        assert x.dtype == dtype and x.shape == t.shape
        assert torch.equal(x, y)
        assert _rel(x, p) <= tol_plain
        assert _rel(x, e) <= tol_exact
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_flash_backward_vs_plain_on_card(cuda, d, causal, dtype):
    """GQA (6 query heads on 2 KV heads), ragged lengths (not multiples of
    the 64-row tiles), Sq < Sk; strided (B, S, H, d) views; bit-identical
    run to run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for sq, sk in ((200, 200), (70, 130)):
        _flash_bwd_check(cuda, dtype, 2, 6, 2, sq, sk, d, causal, seed=d)


@pytest.mark.gpu
def test_flash_backward_at_qwen2_training_layer(cuda):
    """qwen2-1.5b's training layer: q (2, 12, 4096, 128), k/v (2, 2,
    4096, 128), bf16, causal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _flash_bwd_check(cuda, torch.bfloat16, 2, 12, 2, 4096, 4096, 128, True,
                     seed=4096)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 3, 6])
def test_flash_backward_zero_key_tiles(cuda, group, dtype):
    """Causal with Sq < Sk: keys 70 to 299 (part of the second 64-key tile
    and three whole tiles) see no query, so their dK and dV are exactly 0,
    though the gradients come from torch.empty."""
    torch.backends.cuda.matmul.allow_tf32 = False
    got = _flash_bwd_check(cuda, dtype, 1, 6, 6 // group, 70, 300,
                           64, True, seed=group)
    for t in got[1:]:
        assert bool((t[:, :, 70:] == 0).all())
        assert float(t[:, :, :70].abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("group", [1, 3, 6])
def test_flash_backward_head_groups(cuda, group, d, dtype):
    """6 query heads on 6 / group KV heads: G = 1 stores dK and dV from
    the key-tile CTAs, G > 1 sums per-head partials in order; causal and
    not, 150 rows (a ragged third tile), at every head dim."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for causal in (True, False):
        _flash_bwd_check(cuda, dtype, 2, 6, 6 // group, 150, 150, d,
                         causal, seed=10 * group + d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 127, 128, 129])
def test_flash_backward_tile_edges(cuda, length, dtype):
    """Lengths at the edges of the 64-row tiles, GQA 4:2, d 128:
    `length` queries over 129 keys, and (length > 1) 129 queries over
    `length` keys and `length` of both, causal. One key alone has
    dQ = dK = 0, which a check relative to the largest magnitude cannot
    hold, so length 1 runs as Sq only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _flash_bwd_check(cuda, dtype, 1, 4, 2, length, 129, 128, False,
                     seed=length)
    if length > 1:
        _flash_bwd_check(cuda, dtype, 1, 4, 2, 129, length, 128,
                         False, seed=length + 1)
        _flash_bwd_check(cuda, dtype, 1, 4, 2, length, length, 128,
                         True, seed=length + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [1, 3, 6])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 127, 128, 129])
def test_flash_f32_forward_groups_and_tile_edges(cuda, length, group):
    """The float32 forward (64 query rows a CTA, 128 keys a step) with 6
    query heads on 6 / group KV heads at lengths on either side of its
    tile edges: `length` queries over 129 keys and 129 queries over
    `length` keys, causal (Sq != Sk) and not, and `length` of both,
    causal; strided (B, S, H, d) views at d = 128 and 80. Each within
    2e-5 of the plain version, its LSE within 1e-5, bit-identical run to
    run, one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.random.default_rng(100 * group + length)
    shapes = [(length, 129, True), (length, 129, False), (129, length, True),
              (129, length, False), (length, length, True)]
    for d in (128, 80):
        for sq, sk, causal in shapes:
            q, k, v = (_t(g.standard_normal((1, s, n, d)).astype(np.float32))
                       .to(cuda).transpose(1, 2)
                       for s, n in ((sq, 6), (sk, 6 // group),
                                    (sk, 6 // group)))
            before = flashattn.LAUNCHES
            out, lse = flashattn.flash_attention_lse(q, k, v, causal=causal)
            assert flashattn.LAUNCHES == before + 1
            assert torch.equal(out, flashattn.flash_attention(
                q, k, v, causal=causal))
            want_lse = attention_ref_lse(q, k, v, causal=causal)[1]
            assert _flash_err(out, q, k, v, causal) <= FLASH_TOL[
                torch.float32]
            assert float((lse - want_lse).abs().max()) <= 1e-5 * float(
                want_lse.abs().max()) + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sum", "weighted sum"])
def test_flash_backward_of_broadcast_cotangents(cuda, kind):
    """bf16: the gradient of `out.sum()` (strides all 0) and of
    `(out.sum(dim=(0, 1, 2)) * w).sum()` with w of shape (d,) (strides
    (0, 0, 0, 1), which TMA's stride rule lets through) each reach the
    backward kernel once and match the plain backward of that cotangent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.random.default_rng(5)
    b, h, hkv, s, d = 2, 6, 2, 150, 64
    q, k, v = (_t(g.standard_normal(shape).astype(np.float32)).to(cuda)
               .bfloat16() for shape in ((b, h, s, d), (b, hkv, s, d),
                                         (b, hkv, s, d)))
    w = _t(g.standard_normal(d).astype(np.float32)).to(cuda).bfloat16()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves)
    loss = (out.sum() if kind == "sum"
            else (out.sum(dim=(0, 1, 2)) * w).sum())
    before = flashattn.BWD_LAUNCHES
    loss.backward()
    assert flashattn.BWD_LAUNCHES == before + 1
    do = torch.ones_like(out) if kind == "sum" else w.expand(out.shape)
    o, lse = flashattn.flash_attention_lse(q, k, v)
    plain = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float())
    for t, p in zip(leaves, plain):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(t.grad, p) <= FLASH_BWD_TOL[torch.bfloat16][0]


@pytest.mark.gpu
def test_flash_autograd_launches_on_card(cuda):
    """With inputs that need gradients, one forward launch (with LSE) and
    one backward launch, never the plain backward; without, the serving
    forward alone. Gradients equal the kernel backward's."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16()
               for s in ((1, 4, 96, 64), (1, 2, 96, 64), (1, 2, 96, 64)))
    f0, b0 = flashattn.LAUNCHES, flashattn.BWD_LAUNCHES
    ops.flash_attention(q, k, v)
    assert (flashattn.LAUNCHES, flashattn.BWD_LAUNCHES) == (f0 + 1, b0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves)
    do = torch.randn(out.shape, generator=g, device=cuda).bfloat16()
    out.backward(do)
    assert (flashattn.LAUNCHES, flashattn.BWD_LAUNCHES) == (f0 + 2, b0 + 1)
    o, lse = flashattn.flash_attention_lse(q, k, v)
    want = flashattn.flash_attention_bwd(q, k, v, o, lse, do)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,group", [(True, 2), (False, 1)])
def test_flash_second_derivative_on_card_matches_cpu(cuda, causal, group):
    """A Hessian-vector product through `ops.flash_attention` in float32:
    on the card the first-order products launch the kernels (one forward,
    and a backward for the graph plus one for the product's pass through
    dO) and the second-order terms take the plain route once; the
    product equals the CPU's (plain versions) within 1e-4 of its largest
    magnitude. A third derivative raises."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    h, s, d = 4, 80, 128
    shapes = ((1, h, s, d), (1, h // group, s, d), (1, h // group, s, d))
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in shapes)
    dirs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    got = {}
    for dev in ("cpu", cuda):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in (q, k, v)]
        counts = (flashattn.LAUNCHES, flashattn.BWD_LAUNCHES,
                  flashattn.GRAD2_CALLS)
        out = ops.flash_attention(*leaves, causal=causal)
        grads = torch.autograd.grad(0.5 * (out * out).sum(), leaves,
                                    create_graph=True)
        hv = torch.autograd.grad(grads, leaves,
                                 [torch.from_numpy(a).to(dev) for a in dirs],
                                 create_graph=True)
        got[str(dev)] = [t.detach().cpu() for t in hv]
        moved = (flashattn.LAUNCHES - counts[0],
                 flashattn.BWD_LAUNCHES - counts[1],
                 flashattn.GRAD2_CALLS - counts[2])
        assert moved == ((0, 0, 1) if dev == "cpu" else (1, 2, 1))
        with pytest.raises(RuntimeError, match="third derivative"):
            torch.autograd.grad(hv[0].sum(), leaves)
    for a, b in zip(got[str(cuda)], got["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.gpu
def test_hvp_operator_on_card_matches_cpu(cuda):
    """`HvpOperator.matmat` of reduced qwen2-1.5b on the card (one flash
    forward launch per layer) against the CPU's on the same weights and
    block, within 1e-4 of max |Hv|; the operator lives on the card by
    default."""
    from repro_torch import configs
    from repro_torch.examples.curvature_spectrum import hessian_operator
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.reduced("qwen2-1.5b")
    params = tf.init_model(0, cfg, device="cpu")
    cpu = hessian_operator(cfg, device="cpu", params=params)
    card = hessian_operator(cfg, params=adamw.tree_map(
        lambda t: t.to(cuda), params))
    assert card.device.type == "cuda" and card.n == cpu.n
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (cpu.n, 2)).astype(np.float32))
    f0 = flashattn.LAUNCHES
    got = card.matmat(x.to(cuda)).cpu()
    assert flashattn.LAUNCHES - f0 == cfg.n_layers
    want = cpu.matmat(x)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
def test_reduced_train_step_on_card_matches_cpu(cuda):
    """One train step of reduced("qwen2-1.5b") in float32 with remat, two
    microbatches, on the card (flash forward and backward kernels) and on
    the CPU (plain versions): loss and grad norm to 1e-5, every parameter
    to 2·lr (Adam's step-1 sign, as in tests/test_torch_train.py); the
    forward launches per step are layers × microbatches × 2 (remat
    recomputes each), the backward launches layers × microbatches."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.reduced("qwen2-1.5b"), remat=True)
    lr, mb = 1e-3, 2
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
             for k in ("tokens", "targets")}
    out = {}
    for dev in ("cpu", cuda):
        params, opt = steps.init_all(0, cfg, device="cpu")
        params = adamw.tree_map(lambda t: t.to(dev), params)
        opt = adamw.AdamWState(*(adamw.tree_map(lambda t: t.to(dev), x)
                                 for x in opt))
        fn = steps.build_train_step(cfg, num_microbatches=mb, peak_lr=lr,
                                    warmup=0, total_steps=10, device=dev)
        f0, b0 = flashattn.LAUNCHES, flashattn.BWD_LAUNCHES
        p, _, m = fn(params, opt, batch)
        out[str(dev)] = (p, m, flashattn.LAUNCHES - f0,
                         flashattn.BWD_LAUNCHES - b0)
    (pc, mc, fc, bc), (pg, mg, fg, bg) = out["cpu"], out[str(cuda)]
    assert (fc, bc) == (0, 0)
    assert (fg, bg) == (cfg.n_layers * mb * 2, cfg.n_layers * mb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-5)
    for a, b in zip(adamw.tree_leaves(pg), adamw.tree_leaves(pc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=2 * lr + 1e-6)


@pytest.mark.gpu
def test_flash_bf16_refuses_layouts_tma_cannot_read(cuda):
    """TMA needs 16-byte aligned bases and strides: the wrapper raises
    rather than take another path."""
    g = torch.Generator(device=cuda).manual_seed(0)
    wide = torch.randn((1, 2, 64, 72), generator=g, device=cuda).bfloat16()
    k = v = wide[..., :64].contiguous()
    odd = torch.randn((1, 2, 64, 68), generator=g, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        ops.flash_attention(odd[..., :64], k, v)      # row stride 136 B
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(wide[..., 1:65], k, v)    # base 2 B past
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        ops.flash_attention(k, odd[..., :64], odd[..., :64])
    got = ops.flash_attention(wide[..., :64], k, v)   # row stride 144 B
    assert torch.equal(got, ops.flash_attention(wide[..., :64].contiguous(),
                                                k, v))
    # the model's (B, S, H, d) projections, read as (B, H, S, d) views
    qs = torch.randn((2, 150, 8, 32), generator=g, device=cuda).bfloat16()
    kv = torch.randn((2, 150, 2, 2, 32), generator=g,
                     device=cuda).bfloat16()
    kt, vt = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    got = ops.flash_attention(qs.transpose(1, 2), kt, vt)
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, ops.flash_attention(
        qs.transpose(1, 2).contiguous(), kt.contiguous(), vt.contiguous()))


@pytest.mark.gpu
def test_flash_kernel_reads_strided_views(cuda):
    """The model passes (B, S, H, d) projections as (B, H, S, d) views."""
    g = np.random.default_rng(3)
    q = _t(g.standard_normal((2, 150, 8, 32)).astype(np.float32)).to(cuda)
    kv = _t(g.standard_normal((2, 150, 2, 2, 32)).astype(np.float32)).to(cuda)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    got = ops.flash_attention(q.transpose(1, 2), k, v)
    assert got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention(q.transpose(1, 2).contiguous(), k.contiguous(),
                               v.contiguous())
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    for d in (120, 256):      # danube's and recurrentgemma's (plain SWA)
        q, k, v = _flash_inputs(cuda, torch.float32, 1, 2, 2, 64, 64, d,
                                seed=0)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(q, k, v)
    q, k, v = _flash_inputs(cuda, torch.float32, 1, 2, 2, 64, 64, 64, seed=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="H % Hkv"):
        ops.flash_attention(q[:, :, :, :], k.repeat(1, 3, 1, 1),
                            v.repeat(1, 3, 1, 1))


@pytest.mark.gpu
def test_reduced_model_on_card_matches_cpu(cuda):
    """The serving path at reduced("yi-9b") in float32: prefill through
    the flash kernel (one launch per layer) and decode on the card against
    the same weights on the CPU's plain versions."""
    from repro_torch import configs
    from repro_torch.convert import params_from_arrays
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.reduced("yi-9b")
    cpu_params = tf.init_model(0, cfg, device="cpu")
    gpu_params = params_from_arrays(_numpy_tree(cpu_params), device=cuda)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 70))
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        before = flashattn.LAUNCHES
        logits, cache = tf.prefill_with_cache(params, cfg, toks[:, :66],
                                              cache_len=70, device=dev)
        assert flashattn.LAUNCHES - before == (cfg.n_layers if dev == cuda
                                               else 0)
        steps = [logits]
        for t in range(66, 70):
            lg, cache = tf.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                       t, device=dev)
            steps.append(lg)
        out[str(dev)] = [s.cpu() for s in steps]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "qwen2-1.5b", "h2o-danube-3-4b", "mistral-large-123b", "grok-1-314b",
    "arctic-480b", "llama-3.2-vision-90b", "recurrentgemma-2b",
    "mamba2-780m", "hubert-xlarge"])
def test_reduced_family_on_card_matches_cpu(cuda, name):
    """Each of the other nine architectures at its reduced size in
    float32, the same weights on the card and on the CPU: a decoder's
    prefill (+ patch embeddings for the VLM) and 4 decode steps, the
    encoder's forward over frames; flash launched once per causal or
    non-causal self-attention layer in the prefill or forward, never in
    decode, and nowhere on the CPU."""
    from repro_torch import configs
    from repro_torch.convert import params_from_arrays
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.reduced(name)
    cpu_params = tf.init_model(0, cfg, device="cpu")
    gpu_params = params_from_arrays(_numpy_tree(cpu_params), device=cuda)
    g = np.random.default_rng(6)
    flash_layers = sum(k == "attn" for k in cfg.pattern) * cfg.n_super + \
        sum(k == "attn" for k in cfg.pattern[:cfg.n_remainder])
    enc = None
    if cfg.frontend == "patch":
        enc = g.standard_normal((2, cfg.n_frontend_tokens,
                                 cfg.d_model)).astype(np.float32)
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        before = flashattn.LAUNCHES
        if not cfg.decoder:
            frames = np.random.default_rng(7).standard_normal(
                (2, 40, cfg.d_model)).astype(np.float32)
            out[str(dev)] = [tf.logits_fn(params, cfg, frames,
                                          device=dev).cpu()]
            assert flashattn.LAUNCHES - before == (
                flash_layers if dev == cuda else 0)
            continue
        toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 44))
        logits, cache = tf.prefill_with_cache(params, cfg, toks[:, :40],
                                              encoder=enc, cache_len=44,
                                              device=dev)
        assert flashattn.LAUNCHES - before == (flash_layers if dev == cuda
                                               else 0)
        steps = [logits]
        for t in range(40, 44):
            lg, cache = tf.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                       t, device=dev)
            steps.append(lg)
        assert flashattn.LAUNCHES - before == (flash_layers if dev == cuda
                                               else 0)
        out[str(dev)] = [s.cpu() for s in steps]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


# -------------------------------------------------- checkpoint / resume
class _Guard:
    """A stand-in preemption guard, armed after `after` callbacks."""

    def __init__(self, after):
        self.after, self.n, self.armed = after, 0, False

    def requested(self):
        return self.armed

    def cb(self, step, theta, res):
        self.n += 1
        self.armed = self.armed or self.n == self.after


def _ckpt_graph():
    from repro_torch.graphs import normalized_adjacency
    n = 4096
    r, c, v = rmat_graph(n, 40000, seed=5, symmetric=True)
    r, c, v = normalized_adjacency(n, r, c, v)
    return pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)


@pytest.mark.gpu
@pytest.mark.parametrize("method,kw", [
    ("krylov_schur", {"tol": 1e-5}), ("lobpcg", {"tol": 1e-4})])
def test_suspend_resume_bit_identical_on_card(cuda, tmp_path, method, kw):
    """Under deterministic algorithms (the COO side path's `index_add_`
    sums in a fixed order) a solve suspended at boundary 3 and resumed
    on the card equals the uninterrupted solve bit for bit."""
    from repro_torch.ckpt import CheckpointPolicy, SolveSuspended
    from repro_torch.core import GraphOperator, TieredStore, solve
    tm = _ckpt_graph()

    def run(**extra):
        store = TieredStore(device=cuda)
        return solve(GraphOperator(tm, store=store), 4, method=method,
                     max_iters=200, store=store, **kw, **extra)

    torch.use_deterministic_algorithms(True)
    try:
        full = run()
        g = _Guard(after=3)
        root = str(tmp_path / "ck")
        with pytest.raises(SolveSuspended) as ei:
            run(checkpoint=CheckpointPolicy(root=root, guard=g),
                callback=g.cb)
        res = run(resume=root)
    finally:
        torch.use_deterministic_algorithms(False)
    assert full.converged and res.converged
    assert ei.value.step == res.resumed_step == 3
    assert np.array_equal(res.eigenvalues, full.eigenvalues)
    assert res.n_restarts == full.n_restarts
    assert torch.equal(res.eigenvectors, full.eigenvectors)


@pytest.mark.gpu
def test_safs_ckpt_save_crash_and_resume_on_card(cuda, tmp_path):
    """A crash between a page snapshot and its state commit on a SAFS
    store on the card: the state commits stop at step 2, step 3's pages
    exist, and a resume into a fresh page root continues from step 2 to
    eigenvalues of the uninterrupted solve's spectrum."""
    from repro_torch.ckpt import CheckpointPolicy
    from repro_torch.ckpt.checkpoint import valid_steps
    from repro_torch.core import GraphOperator, TieredStore, solve
    from repro_torch.safs import CrashPoint, FaultPlan, FaultRule
    tm = _ckpt_graph()

    def run(root, plan=None, **extra):
        store = TieredStore(device=cuda, backend="safs", backend_opts={
            "root": str(tmp_path / root), "faults": plan})
        try:
            return solve(GraphOperator(tm, store=store), 4, tol=1e-5,
                         max_iters=200, store=store, **extra)
        finally:
            store.close()

    ref = run("ref")
    ck = str(tmp_path / "ck")
    plan = FaultPlan([FaultRule(site="ckpt.save", kind="crash", at=3)])
    with pytest.raises(CrashPoint):
        run("crash", plan, checkpoint=CheckpointPolicy(root=ck))
    assert valid_steps(os.path.join(ck, "state")) == [1, 2]
    assert 3 in valid_steps(os.path.join(ck, "pages"))
    res = run("fresh", resume=ck)
    assert res.resumed_step == 2 and res.converged
    # ±1 are eigenvalues many times over (one per connected component),
    # and which copies a solve finds follows the atomics of the COO side
    # path: each resumed eigenvalue lies within rtol 1e-5 of one of ref's
    rel = np.abs(res.eigenvalues[:, None] - ref.eigenvalues[None, :]) \
        / np.abs(ref.eigenvalues)[None, :]
    assert np.all(rel.min(axis=1) <= 1e-5), rel


# ------------------------------------------- shared store and the ladders
def _zero_launches():
    for mod in (spmm_tile, gram, tsgemm):
        mod.LAUNCHES = 0


def _launches():
    return {"spmm": spmm_tile.LAUNCHES, "gram": gram.LAUNCHES,
            "tsgemm": tsgemm.LAUNCHES}


@pytest.mark.gpu
def test_namespace_solves_on_card_split_like_solo(cuda):
    """chip_smoke.py phase 24 at 2^12: Krylov–Schur in two namespaces of
    one CUDA store, one after the other and in two threads, under
    deterministic algorithms: each namespace's IOStats split equals a
    solo solve's, the splits sum to the store's counters, every kernel
    launched, and dropping a namespace frees its device bytes."""
    import threading
    from repro_torch.core import GraphOperator, TieredStore, solve
    from repro_torch.graphs import normalized_adjacency
    n = 2 ** 12
    r, c, v = normalized_adjacency(n, *rmat_graph(n, 2 ** 15, seed=1,
                                                  symmetric=True))
    tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    kw = dict(method="krylov_schur", block_size=4, num_blocks=8, tol=1e-5,
              max_iters=100)

    def run(store):
        return solve(GraphOperator(tm, store=store), 8, store=store, **kw)

    torch.use_deterministic_algorithms(True)
    try:
        solo = run(TieredStore(device=cuda))
        store = TieredStore(device=cuda)
        _zero_launches()
        for sid in ("s0", "s1"):
            assert run(store.namespace(sid)).io_stats == solo.io_stats
        out = {}
        ts = [threading.Thread(target=lambda sid=sid: out.__setitem__(
            sid, run(store.namespace(sid)))) for sid in ("t0", "t1")]
        [t.start() for t in ts]
        [t.join(timeout=300) for t in ts]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert not any(t.is_alive() for t in ts) and set(out) == {"t0", "t1"}
    assert all(v > 0 for v in _launches().values()), _launches()
    stats = store.namespace_stats()
    for sid in ("s0", "s1", "t0", "t1"):
        assert stats[sid] == solo.io_stats, sid
    for res in out.values():
        np.testing.assert_allclose(res.eigenvalues, solo.eigenvalues,
                                   rtol=1e-5)
    parent = store.stats.as_dict()
    for f in ("host_bytes_read", "host_bytes_written", "passes",
              "pass_bytes_read", "cache_hits", "cache_misses"):
        assert sum(d[f] for d in stats.values()) == parent[f], f
    assert store.namespace("t0").device_bytes() > 0
    store.drop_namespace("t0")
    assert store.namespace("t0").device_bytes() == 0
    assert store.namespace_stats()["t0"] == stats["t0"]


@pytest.mark.gpu
def test_spmm_ladder_on_card(cuda):
    """chip_smoke.py phase 25 at the smoke size: every rung at k = 1 and
    4 within 1e-5 of Σ|terms| of its plain version, the blocked rungs on
    the SpMM kernel, the counts those of a CPU run."""
    from repro_torch.benchmarks import bench_spmm
    _zero_launches()
    m = bench_spmm.collect(smoke=True, device=cuda)
    assert spmm_tile.LAUNCHES > 0
    bench_spmm.validate(m)
    cpu = bench_spmm.collect(smoke=True, device="cpu")
    for key in ("blocking", "hybrid", "balance"):
        assert m[key] == cpu[key], key


@pytest.mark.gpu
def test_tasops_ladder_on_card(cuda):
    """chip_smoke.py phase 26 at the smoke size: the I/O ladder's bytes
    equal the CPU run's, gram and tsgemm launched."""
    from repro_torch.benchmarks import bench_tasops
    _zero_launches()
    m = bench_tasops.collect(smoke=True, device=cuda)
    assert gram.LAUNCHES > 0 and tsgemm.LAUNCHES > 0
    bench_tasops.validate(m)
    cpu = bench_tasops.collect(smoke=True, device="cpu")
    for ms, r in m["m"].items():
        for t in ("naive", "cache", "lazy_scale"):
            assert r[t]["io_bytes"] == cpu["m"][ms][t]["io_bytes"], (ms, t)


@pytest.mark.gpu
def test_subspace_io_ladder_on_card(cuda):
    """chip_smoke.py phase 27 at the smoke size: `validate` passes on the
    card's metrics, the expansion and compress counters equal the CPU
    run's, every kernel launched."""
    from repro_torch.benchmarks import bench_subspace_io
    _zero_launches()
    m = bench_subspace_io.collect(smoke=True, device=cuda)
    assert all(v > 0 for v in _launches().values()), _launches()
    bench_subspace_io.validate(m)
    for name in ("expansion", "compress"):
        cpu = getattr(bench_subspace_io, f"_{name}_ladder")(4000, 4, 8,
                                                             "cpu")
        for tag in ("fused", "unfused"):
            assert m[name][tag] == cpu[tag], (name, tag)


@pytest.mark.gpu
def test_safs_bench_on_card(cuda):
    """chip_smoke.py phase 28 at the smoke size: the page and byte counts
    of a CPU run, gram and tsgemm launched on the SAFS-backed subspace."""
    from repro_torch.benchmarks import bench_safs
    _zero_launches()
    m = bench_safs.collect(smoke=True, device=cuda)
    assert gram.LAUNCHES > 0 and tsgemm.LAUNCHES > 0
    cpu = bench_safs.collect(smoke=True, device="cpu")
    for ps in ("4096", "65536"):
        assert m["read_throughput"][ps]["n_pages"] == \
            cpu["read_throughput"][ps]["n_pages"]
    for k in ("logical_bytes_written", "physical_bytes_written"):
        assert m["safs_endurance"][k] == cpu["safs_endurance"][k], k
    assert m["safs_stream"]["prefetch_on"]["logical_bytes_read"] == \
        cpu["safs_stream"]["prefetch_on"]["logical_bytes_read"]


_SERVE_ON_CARD = """
import json, sys
import numpy as np
from repro_torch.kernels import gram, spmm_tile, tsgemm
from repro_torch.serve import JobSpec, build_service, validate_report
jobs = [dict(job_id="embed", kind="eigsh", n=2000, nnz=20000, nev=4,
             tol=1e-6, max_iters=80),
        dict(job_id="pcg", kind="lobpcg", n=1800, nnz=18000, nev=3,
             tol=1e-4, max_iters=80, priority=1)]
out = {}
for dev in ("cuda", "cpu"):
    svc = build_service(backend="ram", device_budget=32 << 20,
                        max_concurrent=2, device=dev)
    for mod in (spmm_tile, gram, tsgemm):
        mod.LAUNCHES = 0
    for d in jobs:
        svc.submit(JobSpec.from_dict(dict(d)))
    svc.drain()
    rep = svc.report()
    svc.close()
    out[dev] = {"launches": [spmm_tile.LAUNCHES, gram.LAUNCHES,
                             tsgemm.LAUNCHES],
                "errors": validate_report(rep),
                "eigenvalues": {j["job_id"]: (j["result"] or {}).get(
                    "eigenvalues") for j in rep["jobs"]},
                "json": json.loads(json.dumps(rep)) == rep}
print("RESULT " + json.dumps(out))
"""


@pytest.mark.gpu
def test_service_sessions_launch_the_kernels_on_card(cuda):
    """Two jobs through `build_service(device="cuda")` on the RAM tier, in
    a fresh process (so the two sessions make the process's first CUDA
    linalg calls, from two threads): a valid, JSON-clean report,
    eigenvalues at rtol 1e-5 of the same service on the CPU's plain
    versions, and SpMM, gram and tsgemm launched by the sessions."""
    import json
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    run = subprocess.run([sys.executable, "-c", _SERVE_ON_CARD],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
    out = json.loads(line[-1][len("RESULT "):])
    for dev in ("cuda", "cpu"):
        assert out[dev]["errors"] == [], out[dev]["errors"]
        assert out[dev]["json"]
    assert all(n > 0 for n in out["cuda"]["launches"]), out["cuda"]
    assert out["cpu"]["launches"] == [0, 0, 0]
    for jid, want in out["cpu"]["eigenvalues"].items():
        np.testing.assert_allclose(out["cuda"]["eigenvalues"][jid], want,
                                   rtol=1e-5)


# ------------------------------------------------------------ sharded layer
def _dist_cfg():
    return dict(graph=("rmat_spectral", 1500, 15000, 1), nev=4,
                block_size=2, tol=1e-7, max_restarts=100, x0_seed=0,
                local=True)


@pytest.mark.gpu
def test_dist_one_rank_on_card_matches_cpu(cuda):
    """A one-rank DistOperator under eigsh's fused expansion on the card
    launches SpMM, gram and tsgemm, and finds the CPU run's spectrum
    (rtol 1e-5) with the same IOStats from the same start block."""
    from repro_torch.core import eigsh
    from repro_torch.dist import DistOperator, Mesh
    from repro_torch.graphs import rmat_spectral
    n = 1500
    r, c, v = rmat_spectral(n, 15000, seed=1)
    x0 = np.random.default_rng(0).standard_normal((1504, 2)).astype(
        np.float32)
    before = (spmm_tile.LAUNCHES, gram.LAUNCHES, tsgemm.LAUNCHES)
    card = DistOperator(n, r, c, v, mesh=Mesh((1, 1, 1), device=cuda))
    got = eigsh(card, 4, block_size=2, tol=1e-7, max_restarts=100, x0=x0)
    after = (spmm_tile.LAUNCHES, gram.LAUNCHES, tsgemm.LAUNCHES)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    cpu = DistOperator(n, r, c, v, device="cpu")
    want = eigsh(cpu, 4, block_size=2, tol=1e-7, max_restarts=100, x0=x0)
    assert got.converged and card.n_fused_steps > 0
    np.testing.assert_allclose(np.sort(got.eigenvalues),
                               np.sort(want.eigenvalues), rtol=1e-5)
    assert got.io_stats == want.io_stats


@pytest.mark.gpu
def test_dist_panel_bridge_on_card(cuda, rng):
    """The reference's bridge at its default 8×8 float32 blocks through
    the SpMM kernel, against the plain version on the same inputs."""
    from repro_torch.dist import layout
    from repro_torch.dist.dspmm import pack_edge_panels, panel_spmm_blocksparse
    n, R, M = 512, 2, 2
    r, c, v = rmat_graph(n, 4000, seed=1, symmetric=True)
    n_pad = layout.padded_n(n, R, M)
    perm = layout.vertex_permutation(n_pad, R, M)
    pc, pr, pv, _ = pack_edge_panels(n_pad, perm[r], perm[c], v,
                                     r_groups=R, m_groups=M)
    x = _t(rng.standard_normal((n_pad // M, 4)).astype(np.float32))
    before = spmm_tile.LAUNCHES
    got = panel_spmm_blocksparse(pr[1, 0], pc[1, 0], pv[1, 0], x.to(cuda),
                                 n_pad // R)
    assert spmm_tile.LAUNCHES == before + 1
    want = panel_spmm_blocksparse(pr[1, 0], pc[1, 0], pv[1, 0], x,
                                  n_pad // R)   # a CPU tensor: the plain one
    _close(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,shape", [("nccl", (1, 1, 1)),
                                           ("gloo", (1, 1, 2))])
def test_dist_world_on_card(cuda, backend, shape):
    """A world of ranks on the card (nccl: one rank; gloo: two sharing
    the card, payloads staged through pinned host memory): the fused
    path's spectrum at rtol 1e-5 of the local path's, every rank's
    kernels launched and collective bytes equal to the design's count."""
    from repro_torch.dist import spawn
    from repro_torch.examples.dist_eigen_e2e import run_ranks
    outs = spawn(run_ranks, shape, backend=backend, device="cuda",
                 args=(_dist_cfg(),), timeout=300)
    head = outs[0]
    np.testing.assert_allclose(np.sort(head["dist"]["eigenvalues"]),
                               np.sort(head["local"]["eigenvalues"]),
                               rtol=1e-5)
    for o in outs:
        assert all(n > 0 for n in o["launches"].values()), o["launches"]
        for kind, want in o["analytic_bytes"].items():
            assert o["bytes"][kind] == want, (kind, o["bytes"])
        assert (o["bytes"].get("staged", 0) > 0) == (backend == "gloo")


@pytest.mark.gpu
def test_dist_nccl_refuses_more_ranks_than_cards(cuda):
    from repro_torch.dist import spawn
    from repro_torch.examples.dist_eigen_e2e import run_ranks
    ranks = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="one card per rank"):
        spawn(run_ranks, (1, 1, ranks), backend="nccl", device="cuda",
              args=(_dist_cfg(),))


@pytest.mark.gpu
def test_hvp_operator_under_remat_on_card(cuda):
    """remat=True (every published config's setting) through a double
    backward on the card: each recompute enters its context afresh, and
    the block equals the remat-off block within 1e-4 of max |Hv| (the
    embedding's backward adds with atomics, so not bit for bit)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.examples.curvature_spectrum import hessian_operator
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.reduced("qwen2-1.5b"), remat=True)
    params = tf.init_model(0, cfg, device=cuda)
    ops_ = {r: hessian_operator(dataclasses.replace(cfg, remat=r),
                                params=params) for r in (True, False)}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (ops_[True].n, 2)).astype(np.float32)).to(cuda)
    f0 = flashattn.LAUNCHES
    got = ops_[True].matmat(x)
    assert flashattn.LAUNCHES - f0 > cfg.n_layers     # recomputed
    want = ops_[False].matmat(x)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("backend,shape", [("nccl", (1, 1, 1)),
                                           ("gloo", (1, 1, 2))])
def test_sharded_train_on_card(cuda, tmp_path, backend, shape):
    """`train(mesh=)` of reduced qwen2-1.5b (float32, remat) in a world
    on the card (nccl: one rank; gloo: two sharing the card, staged
    through pinned host memory) against the unsharded `train()` on the
    card: losses and grad norms within rtol 1e-4, every step's
    collective bytes equal to the design's count, the held bytes equal
    to the specs', staged bytes only over gloo."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.dist import spawn
    from repro_torch.launch.train import rank_main
    from repro_torch.train import TrainConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.reduced("qwen2-1.5b"), remat=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)

    def tcfg(name):
        return TrainConfig(steps=3, ckpt_every=100, log_every=1000,
                           peak_lr=1e-3, warmup=2, num_microbatches=2,
                           ckpt_dir=str(tmp_path / name))
    want = train(cfg, tcfg("plain"), dcfg, log=lambda *_: None)
    outs = spawn(rank_main, shape, backend=backend, device="cuda",
                 args=(cfg, tcfg("mesh"), dcfg), timeout=300)
    for o in outs:
        for k in ("losses", "grad_norms"):
            np.testing.assert_allclose(o[k], want[k], rtol=1e-4)
        design = {k: v for k, v in o["analytic_bytes"].items() if v}
        for step in o["step_bytes"]:
            assert {k: v for k, v in step.items() if k != "staged"} == design
        held = o["held_bytes"]
        assert {k: held[k] for k in ("params", "moments")} == held["specs"]
        assert (o["mesh_bytes"].get("staged", 0) > 0) == (backend == "gloo")
        assert o["peak_device_bytes"] > 0
