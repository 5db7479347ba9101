"""The port's kernel layer against the JAX package's oracles.

On the CPU the port's `ops` take the plain PyTorch versions; they are
held against `repro.kernels.*_ref` (the Pallas kernels themselves do not
trace on this jax) on the shapes of tests/test_kernels.py plus ragged n,
empty block rows and the COO side path. Tolerance: rtol 1e-6, with an
absolute floor of 1e-6 times the output's largest magnitude, because the
two libraries sum the same f32 products in different orders (an element
that nearly cancels has no relative accuracy to compare).

Flash attention's plain version, `attention_ref`, is held to
`repro.kernels.flashattn_ref.attention_ref` at rtol/atol 2e-5, the
tolerance of tests/test_flashattn.py. The reference's Pallas body cannot
be the oracle: on jax 0.9.0 it fails to trace even with interpret=True
(`pltpu.TPUCompilerParams` is gone; ROADMAP.md queue 3). These tests draw
from their own seeded generators, not the session `rng`.

The CUDA kernels themselves are held to their plain versions on the card
by tests/test_torch_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import pack_tiles as ref_pack_tiles
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.kernels import ops as ref_ops
from repro.kernels.flashattn_ref import attention_ref as ref_attention
from repro.kernels.gram_ref import gram_ref as ref_gram
from repro.kernels.spmm_ref import coo_spmm_ref as ref_coo
from repro.kernels.spmm_ref import spmm_ref as ref_spmm
from repro.kernels.tsgemm_ref import tsgemm_ref as ref_tsgemm
from repro_torch.convert import tiled_from_arrays
from repro_torch.graphs import pack_tiles, rmat_graph, to_dense
from repro_torch.graphs import rmat_spectral
from repro_torch.kernels import flashattn as flash_kernel
from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import spmm_tile, tsgemm as tsgemm_kernel

RTOL = 1e-6


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = RTOL * max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- graphs

@pytest.mark.parametrize("n,nnz,bm,min_nnz", [
    (256, 2000, 16, 1), (600, 5000, 16, 2), (1200, 10000, 64, 4)])
def test_pack_tiles_byte_identical_to_reference(n, nnz, bm, min_nnz):
    r, c, v = rmat_graph(n, nnz, seed=n, symmetric=True)
    rr, rc, rv = ref_rmat_graph(n, nnz, seed=n, symmetric=True)
    for a, b in ((r, rr), (c, rc), (v, rv)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tm = pack_tiles(n, n, r, c, v, block_shape=(bm, bm),
                    min_block_nnz=min_nnz)
    ref = ref_pack_tiles(n, n, rr, rc, rv, block_shape=(bm, bm),
                         min_block_nnz=min_nnz)
    conv = tiled_from_arrays(dataclasses.asdict(ref))
    for got in (tm, conv):
        for f in dataclasses.fields(ref):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
            else:
                assert tuple(a) == tuple(b), f
    assert tm.nbytes_image() == ref.nbytes_image()


def test_rmat_spectral_matches_reference():
    from repro.graphs.synth import rmat_spectral as ref_rmat_spectral
    for a, b in zip(rmat_spectral(500, 3000, seed=3),
                    ref_rmat_spectral(500, 3000, seed=3)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ----------------------------------------------------------------- spmm

@pytest.mark.parametrize("n,nnz,bm,k", [
    (256, 2000, 16, 4), (512, 4000, 32, 8), (300, 1500, 16, 2),
    (1024, 8000, 64, 1),
])
def test_spmm_plain_vs_reference(n, nnz, bm, k, rng):
    r, c, v = rmat_graph(n, nnz, seed=n, symmetric=True)
    tm = pack_tiles(n, n, r, c, v, block_shape=(bm, bm), min_block_nnz=1)
    x = rng.standard_normal((tm.shape[1], k)).astype(np.float32)
    brs = ref_ops.block_rows_from_ptr(tm.row_ptr)
    want = ref_spmm(jnp.asarray(tm.blocks), jnp.asarray(tm.block_cols),
                    jnp.asarray(brs), tm.n_block_rows, jnp.asarray(x))
    got = ops.spmm_blocks(_t(tm.blocks), _t(tm.block_cols), _t(tm.row_ptr),
                          _t(x))
    _close(got, want)
    assert np.array_equal(ops.block_rows_from_ptr(tm.row_ptr), brs)


def test_spmm_empty_block_rows_are_zero(rng):
    # vertices 64..191 have no edges: two whole empty block rows
    n, bm = 256, 64
    r = np.array([0, 5, 200, 250, 7, 3], np.int32)
    c = np.array([5, 0, 250, 200, 3, 7], np.int32)
    v = np.ones(r.size, np.float32)
    tm = pack_tiles(n, n, r, c, v, block_shape=(bm, bm))
    mask = ops.empty_row_mask(tm.row_ptr, bm)
    assert np.array_equal(mask, ref_ops.empty_row_mask(tm.row_ptr, bm))
    assert not mask[64:192].any() and mask[:64].all()
    x = rng.standard_normal((n, 4)).astype(np.float32)
    got = ops.spmm_blocks(_t(tm.blocks), _t(tm.block_cols), _t(tm.row_ptr),
                          _t(x)).numpy()
    assert np.all(got[~mask] == 0.0)
    _close(got, to_dense(n, r, c, v) @ x)


def test_spmm_full_hybrid_vs_reference_and_dense(rng):
    n = 600
    r, c, v = rmat_graph(n, 5000, seed=7, symmetric=True)
    tm = pack_tiles(n, n, r, c, v, block_shape=(16, 16), min_block_nnz=2)
    assert tm.coo_vals.size and tm.nblocks
    x = rng.standard_normal((tm.shape[1], 4)).astype(np.float32)
    x[n:] = 0
    got = ops.spmm(tm, _t(x)).numpy()
    want = np.asarray(ref_ops.spmm(tm, jnp.asarray(x), impl="ref"))
    _close(got, want)
    np.testing.assert_allclose(got[:n], to_dense(n, r, c, v) @ x[:n],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,nnz,bm,k", [(256, 2000, 16, 4),
                                        (1024, 8000, 64, 4)])
def test_spmm_plain_bf16_vs_reference(n, nnz, bm, k):
    """bf16 blocks and bf16 X (the reference kernel test's dtype case)
    through `spmm_blocks(impl="ref")` against the reference's plain SpMM
    on the same bf16 values: every product of two bf16s is exact in
    float32, so only the order of the sums differs, within 1e-6 of
    Σ|terms|. Y is float32."""
    import ml_dtypes
    r, c, v = rmat_graph(n, nnz, seed=n + 1, symmetric=True)
    tm = pack_tiles(n, n, r, c, v, block_shape=(bm, bm), min_block_nnz=1)
    g = np.random.default_rng(51)
    blocks = (tm.blocks * g.uniform(0.5, 2.0, tm.blocks.shape)).astype(
        ml_dtypes.bfloat16)
    x = g.standard_normal((tm.shape[1], k)).astype(ml_dtypes.bfloat16)
    brs = ref_ops.block_rows_from_ptr(tm.row_ptr)
    want = ref_spmm(jnp.asarray(blocks), jnp.asarray(tm.block_cols),
                    jnp.asarray(brs), tm.n_block_rows, jnp.asarray(x))
    x_t = ops.from_numpy(x)
    got = ops.spmm_blocks(ops.from_numpy(blocks), _t(tm.block_cols),
                          _t(tm.row_ptr), x_t, impl="ref")
    assert x_t.dtype == torch.bfloat16 and got.dtype == torch.float32
    assert np.asarray(want).dtype == np.float32
    scale = ref_spmm(jnp.asarray(np.abs(blocks.astype(np.float32))),
                     jnp.asarray(tm.block_cols), jnp.asarray(brs),
                     tm.n_block_rows, jnp.asarray(np.abs(x.astype(
                         np.float32))))
    diff = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert np.all(diff <= 1e-6 * np.asarray(scale, np.float64)), \
        float(np.max(diff))


def test_spmm_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel takes float32 or bf16 blocks and X; bf16 blocks are read
    8 values to a 16-byte load, so their rows need bn % 8 == 0. Types and
    shapes are refused before the device is looked at, so this holds on
    the CPU too (the kernel itself needs a card)."""
    g = np.random.default_rng(52)
    ptr = _t(np.array([0, 1, 1, 2], np.int32))
    cols = _t(np.array([0, 1], np.int32))
    x = _t(g.standard_normal((32, 4)).astype(np.float32))
    blocks = _t(g.standard_normal((2, 16, 16)).astype(np.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmm_tile.spmm_blocksparse(blocks.half(), cols, ptr, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmm_tile.spmm_blocksparse(blocks, cols, ptr, x.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmm_tile.spmm_blocksparse(blocks.double(), cols, ptr, x)
    narrow = _t(g.standard_normal((2, 16, 12)).astype(np.float32))
    x12 = _t(g.standard_normal((24, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="bn % 8 == 0"):
        spmm_tile.spmm_blocksparse(narrow.bfloat16(), cols, ptr, x12)
    # the same shapes in float32 (bn % 4 == 0) and bf16 at bn = 16 pass
    # every check that does not need a card
    for b, xx in ((narrow, x12), (blocks.bfloat16(), x),
                  (blocks, x.bfloat16())):
        with pytest.raises(ValueError, match="CUDA"):
            spmm_tile.spmm_blocksparse(b, cols, ptr, xx)


def test_spmm_wrapper_refuses_misaligned_x():
    """The ring kernel's bulk copies move 16-byte units: a float32 X that
    starts 4 bytes into its buffer is refused before the device is looked
    at; a bf16 X is widened into a new tensor, so its offset is free."""
    g = np.random.default_rng(53)
    ptr = _t(np.array([0, 1, 1, 2], np.int32))
    cols = _t(np.array([0, 1], np.int32))
    blocks = _t(g.standard_normal((2, 16, 16)).astype(np.float32))
    flat = torch.zeros(32 * 4 + 4)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        spmm_tile.spmm_blocksparse(blocks, cols, ptr, flat[1:-3].view(32, 4))
    with pytest.raises(ValueError, match="blocks must be 16-byte aligned"):
        spmm_tile.spmm_blocksparse(
            torch.zeros(2 * 256 + 1)[1:].view(2, 16, 16), cols, ptr,
            flat[4:].view(32, 4))
    with pytest.raises(ValueError, match="CUDA"):
        spmm_tile.spmm_blocksparse(
            blocks, cols, ptr, flat.bfloat16()[1:-3].view(32, 4))
    with pytest.raises(ValueError, match="CUDA"):
        spmm_tile.spmm_blocksparse(blocks, cols, ptr, flat[4:].view(32, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_launch_config_covers_every_shape(dtype):
    """Every shape the wrapper takes (bn % 4 == 0 for float32 blocks, % 8
    for bf16, bm·bn ≤ 4096, bm·k ≤ 2048, bn·k ≤ 1024) has a launch of the
    ring kernel: X widths padded to WIDTHS and run in slabs of 16, at most
    MAX_ROWS rows a thread within MAX_THREADS, and the ring and the
    group partials within a block's shared memory."""
    step = 16 // torch.empty((), dtype=dtype).element_size()
    ks = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 24, 33, 100, 256)
    n = 0
    for bn in range(step, 1025, step):
        for bm in range(1, 4096 // bn + 1):
            for k in ks:
                if bm * k > 2048 or bn * k > 1024:
                    break
                for c0 in range(0, k, 16):
                    cfg = spmm_tile.launch_config(
                        dtype, bm, bn, spmm_tile.kernel_width(min(16,
                                                                  k - c0)))
                    assert cfg["threads"] <= spmm_tile.MAX_THREADS
                    assert cfg["smem_bytes"] <= spmm_tile.MAX_SMEM
                    per_pass = cfg["threads"] // cfg["groups_padded"]
                    assert bm <= spmm_tile.MAX_ROWS * per_pass
                n += 1
    assert n > 10_000
    assert [spmm_tile.kernel_width(k) for k in (1, 2, 3, 4, 5, 8, 9, 16,
                                                 17)] == [1, 2, 4, 4, 8, 8,
                                                          16, 16, 16]
    with pytest.raises(ValueError, match="no kernel"):
        spmm_tile.launch_config(dtype, 64, 64, 3)


def test_spmm_launch_config_of_the_rmat_image():
    """At the rmat image's 64×64 blocks: 128 threads of 8-column groups
    and 4 rows, 4 stages; float32 and bf16 share the group width (one
    summation order); at least 3 float32 CTAs (k ≤ 8) and 6 bf16 CTAs
    (k = 4) fit an SM's 228 KB of shared memory, 1 KB of it reserved a
    CTA."""
    sm_bytes, reserved = 233472, 1024
    for dtype, k, ctas in ((torch.float32, 4, 3), (torch.float32, 8, 3),
                           (torch.bfloat16, 4, 6)):
        cfg = spmm_tile.launch_config(dtype, 64, 64, k)
        assert (cfg["threads"], cfg["group_width"], cfg["groups"],
                cfg["stages"]) == (128, 8, 8, spmm_tile.STAGES)
        assert ctas * (cfg["smem_bytes"] + reserved) <= sm_bytes
    f32 = spmm_tile.launch_config(torch.float32, 64, 64, 4)
    assert f32["block_bytes"] == 64 * 64 * 4
    assert spmm_tile.launch_config(torch.float32, 12, 12,
                                   4)["group_width"] == 4
    assert spmm_tile.launch_config(torch.float32, 8, 8, 4)["threads"] == 32


def test_coo_path_vs_reference(rng):
    n, nnz = 500, 3000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    from repro_torch.kernels.spmm_ref import coo_spmm_ref
    got = coo_spmm_ref(_t(rows), _t(cols), _t(vals), _t(x), n)
    want = ref_coo(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                   jnp.asarray(x), n)
    _close(got, want)


# ------------------------------------------------------- spmm work plan

def _rmat_image(n, nnz, bm, seed=7, min_block_nnz=1):
    r, c, v = rmat_graph(n, nnz, seed=seed, symmetric=True)
    return pack_tiles(n, n, r, c, v, block_shape=(bm, bm),
                      min_block_nnz=min_block_nnz)


def _check_plan(ptr, plan, chunk):
    """Every property the kernel relies on, item by item."""
    ptr = np.asarray(ptr, np.int64)
    counts = np.diff(ptr)
    items = plan.items.numpy().astype(np.int64)
    row, lo, hi, slot = items.T
    assert plan.items.dtype == plan.splits.dtype == torch.int32
    assert plan.n_block_rows == counts.size and plan.n_blocks == ptr[-1]
    assert plan.chunk == chunk
    # every block exactly once, each item inside its own row
    cover = np.zeros(int(ptr[-1]), np.int64)
    for a, b in zip(lo, hi):
        cover[a:b] += 1
    assert np.all(cover == 1)
    assert np.all((ptr[row] <= lo) & (lo <= hi) & (hi <= ptr[row + 1]))
    assert np.all(hi - lo <= chunk)
    assert np.all(np.diff(hi - lo) <= 0)                  # longest first
    assert plan.heaviest == (int(hi[0] - lo[0]) if items.size else 0)
    splits = {int(r): (int(s0), int(n)) for r, s0, n in plan.splits.numpy()}
    used = []
    for r in range(counts.size):
        mine = np.flatnonzero(row == r)
        mine = mine[np.argsort(lo[mine], kind="stable")]
        # contiguous chunks in CSR order that span the row
        assert lo[mine[0]] == ptr[r] and hi[mine[-1]] == ptr[r + 1]
        assert np.array_equal(lo[mine[1:]], hi[mine[:-1]])
        if counts[r] <= chunk:                  # unsplit, empty rows too
            assert mine.size == 1 and slot[mine[0]] == -1
            assert r not in splits
        else:
            assert mine.size == -(-counts[r] // chunk)
            lengths = hi[mine] - lo[mine]
            assert lengths.max() - lengths.min() <= 1
            s0, n = splits[r]
            assert n == mine.size
            assert np.array_equal(slot[mine], s0 + np.arange(n))
            used.extend(slot[mine])
    assert sorted(used) == list(range(plan.n_partials))
    assert len(splits) == plan.splits.shape[0]


HAND_ROW_PTRS = {
    "empty-image": [0],
    "all-empty-rows": [0, 0, 0, 0],
    "one-heavy-row": [0, 0, 3000, 3000, 3007, 3008, 3008],
    "exact-multiples": [0, 14, 28, 35, 36],
    "unit-rows": [0, 1, 2, 3, 4, 5],
}


@pytest.mark.parametrize("name", sorted(HAND_ROW_PTRS))
@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_spmm_plan_hand_made_row_ptrs(name, chunk):
    ptr = np.asarray(HAND_ROW_PTRS[name], np.int32)
    plan = spmm_tile.plan(ptr, chunk=chunk)
    _check_plan(ptr, plan, chunk)
    if name == "one-heavy-row" and chunk == 7:
        assert plan.splits.numpy().tolist() == [[1, 0, 429]]
        assert plan.items[0, 0] == 1 and plan.n_partials == 429


@pytest.mark.parametrize("chunk", [None, 3, 7, 64])
def test_spmm_plan_rmat_packing(chunk):
    tm = _rmat_image(4096, 40000, 64)
    plan = spmm_tile.plan(tm.row_ptr, chunk=chunk)
    want_chunk = chunk or spmm_tile.default_chunk(tm.nblocks)
    _check_plan(tm.row_ptr, plan, want_chunk)
    # from a tensor: the same plan, on the tensor's device
    again = spmm_tile.plan(_t(tm.row_ptr), chunk=chunk)
    assert torch.equal(again.items, plan.items)
    assert torch.equal(again.splits, plan.splits)
    if chunk in (3, 7):
        assert plan.n_partials > 0 and plan.items.shape[0] > tm.n_block_rows


def test_spmm_plan_default_chunk():
    assert spmm_tile.default_chunk(784953) == spmm_tile.CHUNK_MAX == 512
    assert spmm_tile.default_chunk(100) == spmm_tile.CHUNK_MIN
    assert spmm_tile.default_chunk(40 * 8 * spmm_tile.N_SMS) == 40
    with pytest.raises(ValueError, match="chunk"):
        spmm_tile.plan(np.array([0, 5], np.int32), chunk=0)


def test_spmm_plan_holds_the_row_ptr_it_describes():
    ptr = _t(np.array([0, 3, 3, 10], np.int32))
    plan = spmm_tile.plan(ptr, chunk=2)
    assert plan.row_ptr is ptr
    assert plan.describes(ptr) and plan.describes(ptr[:])
    assert not plan.describes(ptr.clone())
    # the same block rows and blocks, the heavy row elsewhere
    assert not plan.describes(_t(np.array([0, 7, 7, 10], np.int32)))
    assert not plan.describes(ptr[:-1])
    # from numpy the plan uploads its own int32 copy, which it describes
    from_np = spmm_tile.plan(np.array([0, 3, 3, 10], np.int64), chunk=2)
    assert from_np.row_ptr.dtype == torch.int32
    assert torch.equal(from_np.row_ptr, ptr)
    assert from_np.describes(from_np.row_ptr) and not from_np.describes(ptr)
    assert spmm_tile.default_chunk(100 * 8 * 66, n_sms=66) == 100


def _spmm_by_plan(blocks, block_cols, plan, x):
    """The kernel's order of work in plain PyTorch: each item sums its
    blocks in CSR order into its row of Y or its partial slot, then each
    split row's partials are summed in chunk order."""
    _, bm, bn = blocks.shape
    k = x.shape[1]
    xb = x.reshape(-1, bn, k)
    y = torch.full((plan.n_block_rows, bm, k), float("nan"))
    partials = torch.full((plan.n_partials, bm, k), float("nan"))
    for row, lo, hi, slot in plan.items.tolist():
        acc = torch.zeros((bm, k))
        for j in range(lo, hi):
            acc = acc + blocks[j] @ xb[block_cols[j]]
        if slot < 0:
            y[row] = acc
        else:
            partials[slot] = acc
    for row, slot0, n in plan.splits.tolist():
        acc = partials[slot0]
        for c in range(1, n):
            acc = acc + partials[slot0 + c]
        y[row] = acc
    return y.reshape(-1, k)


@pytest.mark.parametrize("chunk", [None, 2, 5])
def test_spmm_plan_applied_in_order_matches_plain(chunk):
    g = np.random.default_rng(11)
    tm = _rmat_image(2048, 8000, 32, seed=3, min_block_nnz=4)
    counts = np.diff(tm.row_ptr)
    assert (counts == 0).any() and counts.max() > 5
    x = _t(g.standard_normal((tm.shape[1], 4)).astype(np.float32))
    blocks, cols, ptr = (_t(a) for a in (tm.blocks, tm.block_cols,
                                         tm.row_ptr))
    plan = spmm_tile.plan(tm.row_ptr, chunk=chunk)
    got = _spmm_by_plan(blocks, cols, plan, x)
    want = ops.spmm_blocks(blocks, cols, ptr, x, plan=plan)
    _close(got, want)
    _close(want, ops.spmm_blocks(blocks, cols, ptr, x, impl="ref"))


# ------------------------------------------------------- tsgemm / gram

@pytest.mark.parametrize("n,m,b", [
    (1024, 24, 4), (512, 8, 8), (768, 64, 2), (256, 4, 1),
    (1000, 4, 4), (333, 5, 3),            # ragged n
    (1025, 24, 24), (1001, 8, 8), (333, 2, 2),   # the solver family's
])
def test_tsgemm_plain_vs_reference(n, m, b, rng):
    a = rng.standard_normal((n, m)).astype(np.float32)
    small = rng.standard_normal((m, b)).astype(np.float32)
    c0 = rng.standard_normal((n, b)).astype(np.float32)
    got = ops.tsgemm(_t(a), _t(small), alpha=1.5, beta=0.5, c0=_t(c0))
    want = ref_tsgemm(jnp.asarray(a), jnp.asarray(small), alpha=1.5,
                      beta=0.5, c0=jnp.asarray(c0))
    _close(got, want)
    got0 = ops.tsgemm(_t(a), _t(small), alpha=-1.0)
    _close(got0, ref_tsgemm(jnp.asarray(a), jnp.asarray(small), alpha=-1.0))


@pytest.mark.parametrize("n,m,b", [
    (1024, 24, 4), (512, 16, 16), (640, 8, 2),
    (1000, 4, 4), (4097, 3, 5),           # ragged n
    (1025, 24, 24), (512, 8, 8), (333, 2, 2),    # the solver family's
])
def test_gram_plain_vs_reference(n, m, b, rng):
    a = rng.standard_normal((n, m)).astype(np.float32)
    bb = rng.standard_normal((n, b)).astype(np.float32)
    got = ops.gram(_t(a), _t(bb), alpha=2.0)
    want = ref_gram(jnp.asarray(a), jnp.asarray(bb), alpha=2.0)
    # a Gram entry sums n products, which one library adds in sequence
    # and the other in blocks: hold the difference to 1e-6 of the sum of
    # the products' magnitudes, the scale of f32 summation error
    absdot = 2.0 * np.abs(a).T.astype(np.float64) @ np.abs(bb)
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(diff <= RTOL * absdot), float(np.max(diff / absdot))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2 ** 20, 3 * 2 ** 21 + 7])
def test_gram_row_partition_covers_n(n):
    parts, rows = gram_kernel.row_partition(n)
    assert 1 <= parts <= gram_kernel.MAX_PARTS
    assert (parts - 1) * rows < n <= parts * rows
    assert gram_kernel.row_partition(n) == (parts, rows)


@pytest.mark.parametrize("kernel,m,b,aligned,want", [
    ("gram", 4, 4, True, "vec4x4"),       # Krylov–Schur
    ("gram", 2, 2, True, "tile2x2"),      # the SVD
    ("gram", 8, 8, True, "tile8x8"),      # LOBPCG
    ("gram", 16, 16, True, "tile16x16"),
    ("gram", 24, 24, True, "tile24x24"),
    ("gram", 24, 24, False, "generic"),   # a pointer off 16 bytes
    ("gram", 4, 4, False, "generic"),
    ("gram", 2, 2, False, "generic"),
    ("gram", 24, 8, True, "generic"),     # widths not compiled
    ("gram", 8, 24, True, "generic"),
    ("gram", 4, 8, True, "generic"),
    ("gram", 3, 5, True, "generic"),
    ("gram", 32, 32, True, "generic"),
    ("tsgemm", 4, 4, True, "vec4x4"),
    ("tsgemm", 4, 8, True, "vec4x8"),
    ("tsgemm", 8, 8, True, "vec8x8"),
    ("tsgemm", 2, 2, True, "pair2x2"),
    ("tsgemm", 8, 8, False, "generic"),
    ("tsgemm", 2, 2, False, "generic"),
    ("tsgemm", 4, 4, False, "generic"),
    ("tsgemm", 24, 8, True, "generic"),
    ("tsgemm", 8, 4, True, "generic"),
    ("tsgemm", 16, 16, True, "generic"),
    ("tsgemm", 5, 3, True, "generic"),
])
def test_kernel_variant_by_shape_and_alignment(kernel, m, b, aligned, want):
    mod = gram_kernel if kernel == "gram" else tsgemm_kernel
    assert mod.variant(m, b, aligned) == want
    assert want in mod.VARIANTS


@pytest.mark.parametrize("mod,src", [(gram_kernel, "gram.cu"),
                                     (tsgemm_kernel, "tsgemm.cu")])
def test_kernel_variant_ids_match_the_cuda_source(mod, src):
    """The ids the wrapper passes are the ids the C entry point switches
    on (`kVec4x4 = 1` in the source is "vec4x4": 1 in VARIANTS)."""
    import re
    from repro_torch.kernels import _build
    text = (_build.CSRC / src).read_text()
    decl = re.search(r"constexpr int (kGeneric = 0[^;]*);", text).group(1)
    ids = {name.lower(): int(v)
           for name, v in re.findall(r"k(\w+) = (\d+)", decl)}
    assert ids == mod.VARIANTS
    for name in ids:
        if name != "generic":
            assert f"case k{name[0].upper()}{name[1:]}:" in text


def test_build_key_covers_the_shared_headers(tmp_path):
    """The library's name hashes the sources, the headers they include
    (`csrc/*.cuh`) and the flags: an edit to a header gives a new name,
    so no stale build is loaded. On a copy of `csrc` (no `nvcc` here)."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["cudacore.cuh", "hopper.cuh"]
    flags = _build.NVCC_FLAGS
    name = _build.library_path(flags, csrc)
    assert _build.library_path(flags, csrc) == name
    assert name == _build.library_path(flags)      # the copy is the tree
    seen = [name]
    for header in headers:                         # each edit a new name
        header.write_text(header.read_text() + "\n// edited\n")
        seen.append(_build.library_path(flags, csrc))
        assert seen[-1] not in seen[:-1]
    (csrc / "flashattn_bwd.cu").write_text(
        (csrc / "flashattn_bwd.cu").read_text() + "\n// edited\n")
    assert _build.library_path(flags, csrc) not in seen
    assert _build.library_path([*flags, "-DX"], csrc) != \
        _build.library_path(flags, csrc)


def test_alignment_of_views_picks_the_generic_kernel():
    """A view that starts 4 or 8 bytes into its buffer is off a 16-byte
    boundary, so the wrappers' `aligned16` sends it to "generic"; a whole
    tensor and a view 16 bytes in are aligned."""
    from repro_torch.kernels import _build
    buf = torch.zeros(4 * 1000 + 8)
    whole = buf[:8 * 500].view(500, 8)
    assert _build.aligned16(whole)
    for off, ok in ((1, False), (2, False), (4, True)):
        view = buf[off:off + 8 * 500].view(500, 8)
        assert _build.aligned16(view) is ok
        assert _build.aligned16(whole, view) is ok
        want = "tile8x8" if ok else "generic"
        assert gram_kernel.variant(8, 8, _build.aligned16(whole, view)) \
            == want


def test_cpu_tensors_take_plain_version_and_never_launch(rng):
    before = (spmm_tile.LAUNCHES, gram_kernel.LAUNCHES,
              tsgemm_kernel.LAUNCHES)
    a = _t(rng.standard_normal((64, 4)).astype(np.float32))
    for impl in ("auto", "ref"):
        ops.gram(a, a, impl=impl)
        ops.tsgemm(a, a[:4], impl=impl)
    tm = pack_tiles(64, 64, np.array([0], np.int32), np.array([1], np.int32),
                    np.ones(1, np.float32), block_shape=(16, 16))
    ops.spmm(tm, a)
    assert (spmm_tile.LAUNCHES, gram_kernel.LAUNCHES,
            tsgemm_kernel.LAUNCHES) == before
    # a kernel wrapper given CPU tensors raises instead of computing
    with pytest.raises(ValueError, match="CUDA"):
        gram_kernel.gram(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        tsgemm_kernel.tsgemm(a, a[:4])
    with pytest.raises(ValueError, match="CUDA"):
        spmm_tile.spmm_blocksparse(_t(tm.blocks), _t(tm.block_cols),
                                   _t(tm.row_ptr), a)
    with pytest.raises(ValueError, match="impl"):
        ops.gram(a, a, impl="emulate")


# --------------------------------------------------------------- attention

def _qkv(b, h, hkv, sq, sk, d, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, h, sq, d)).astype(np.float32),
            g.standard_normal((b, hkv, sk, d)).astype(np.float32),
            g.standard_normal((b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 32, True), (256, 256, 16, True), (64, 128, 32, False),
    (128, 128, 64, True), (96, 96, 16, True)])
def test_attention_plain_vs_reference(sq, sk, d, causal):
    """The shapes of tests/test_flashattn.py::test_flash_vs_ref, one head."""
    q, k, v = (a[0, 0] for a in _qkv(1, 1, 1, sq, sk, d, seed=sq + d))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    want = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_grouped_heads_vs_reference(causal):
    """GQA: 4 query heads on 2 KV heads; head h reads KV head h // 2."""
    q, k, v = _qkv(2, 4, 2, 40, 40, 16, seed=7)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    for b in range(2):
        for h in range(4):
            want = ref_attention(jnp.asarray(q[b, h]),
                                 jnp.asarray(k[b, h // 2]),
                                 jnp.asarray(v[b, h // 2]), causal=causal)
            np.testing.assert_allclose(got[b, h], np.asarray(want),
                                       rtol=2e-5, atol=2e-5)


def test_attention_plain_q_offset_and_scale_vs_reference():
    """A q block that starts at position 32 of 96 keys, and a given scale."""
    from repro_torch.kernels.flashattn_ref import attention_ref
    q, k, v = (a[0, 0] for a in _qkv(1, 1, 1, 32, 96, 32, seed=9))
    for kw in (dict(q_offset=32), dict(q_offset=64, sm_scale=0.1)):
        got = attention_ref(_t(q), _t(k), _t(v), causal=True, **kw)
        want = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_flash_attention_cpu_tensors_never_launch():
    q, k, v = (_t(a) for a in _qkv(1, 4, 2, 16, 16, 16, seed=1))
    before = flash_kernel.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        out = ops.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
        assert out.dtype == dtype and out.shape == q.shape
    assert flash_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q, k, v)
