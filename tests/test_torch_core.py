"""The port's core layer against the JAX package on the same blocks.

TieredStore, MultiVector, SubspacePass, bcgs2 and compress run in both
packages on identical numpy inputs (the port's store loaded through
`convert.store_from_arrays` or `append_block`). The I/O counters must be
EQUAL: they count bytes moved, not time. Values agree to rtol 1e-5 with
an absolute floor of 1e-5 of the output's largest magnitude: each entry
is a sum of up to n f32 products taken in another order, and CGS2 and
CholQR² carry that rounding through one Cholesky factor.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GraphOperator as RefGraphOperator
from repro.core import MultiVector as RefMultiVector
from repro.core import TieredStore as RefTieredStore
from repro.core import bcgs2 as ref_bcgs2
from repro.core import cholqr as ref_cholqr
from repro.core.residuals import sort_ritz as ref_sort_ritz
from repro.graphs import pack_tiles as ref_pack_tiles
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.graphs.laplacian import normalized_adjacency as ref_normalized
from repro.graphs.synth import rmat_spectral as ref_rmat_spectral
from repro_torch.convert import store_from_arrays, tiled_from_arrays
from repro_torch.core import (DEVICE, HOST, DenseOperator, GraphOperator,
                              MultiVector, TieredStore, bcgs2, cholqr,
                              ortho_error)
from repro_torch.core.residuals import sort_ritz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(torch.as_tensor(got), np.float64)
    want = np.asarray(want, np.float64)
    atol = rtol * max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _blocks(n, b, nb, seed, orthonormal=False):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, nb * b))
    if orthonormal:
        v = np.linalg.qr(v)[0]
    return [np.ascontiguousarray(v[:, i * b:(i + 1) * b], np.float32)
            for i in range(nb)]


def _demoted_pair(n=512, b=4, nb=8, seed=0, orthonormal=False):
    """The same nb-block subspace in both packages with EVERY block on the
    slow tier (pins released), as benchmarks/bench_subspace_io.py builds
    it — host_bytes_read then counts each streamed pass exactly."""
    ref_store = RefTieredStore()
    ref = RefMultiVector(ref_store, n, group_size=2, impl="ref")
    store = TieredStore(device="cpu")
    mv = MultiVector(store, n, group_size=2)
    for blk in _blocks(n, b, nb, seed, orthonormal):
        ref.append_block(jnp.asarray(blk))
        mv.append_block(blk)
    for s, m in ((ref_store, ref), (store, mv)):
        for i in range(nb):
            s.unpin(m._block_name(i))
            s.demote(m._block_name(i))
    assert store.stats.as_dict() == ref_store.stats.as_dict()
    return ref_store, ref, store, mv


# ------------------------------------------------------------ TieredStore

def test_tiered_store_sequence_matches_reference():
    arrays = {name: a for name, a in zip(
        ("a", "b", "c", "d"), _blocks(100, 4, 4, seed=1))}
    budget = 3 * 100 * 4 * 4          # room for three blocks on device
    ref = RefTieredStore(budget)
    for name, a in arrays.items():
        ref.put(name, jnp.asarray(a))
    store = store_from_arrays(arrays,
                              store=TieredStore(budget, device="cpu"))

    def same():
        assert store.stats.as_dict() == ref.stats.as_dict()
        assert {n: store.tier_of(n) for n in store.names()} == \
            {n: ref.tier_of(n) for n in ref.names()}
        assert store.device_bytes() == ref.device_bytes()
        assert store.host_bytes() == ref.host_bytes()

    same()
    assert ref.tier_of("a") == HOST   # the fourth put evicted the oldest
    steps = [
        lambda s: s.get("a"), lambda s: s.pin("a"), lambda s: s.get("b"),
        lambda s: s.demote("c"), lambda s: s.get("c"), lambda s: s.get("c"),
        lambda s: s.promote("c"), lambda s: s.host_pin("b"),
        lambda s: s.demote("b"), lambda s: s.host_pin("b"),
        lambda s: s.unpin("a"), lambda s: s.delete("d"),
        lambda s: s.account_read(12345),
        lambda s: s.end_pass(s.begin_pass()) if s.get("b") is not None
        else None,
        lambda s: s.prefetch(["b", "c", "zz"]),
        lambda s: list(s.stream(["a", "b", "c"])),
    ]
    for step in steps:
        step(ref)
        step(store)
        same()
    for name in store.names():
        np.testing.assert_array_equal(store.get(name).numpy(),
                                      np.asarray(ref.get(name)))
    same()
    # overwriting an entry under budget pressure
    ref.put("b", jnp.asarray(arrays["a"]))
    store.put("b", arrays["a"])
    same()
    assert store.reset_stats().as_dict() == ref.reset_stats().as_dict()
    same()


def test_store_from_arrays_host_tier_counts_writes():
    arrays = dict(zip(("x", "y"), _blocks(50, 2, 2, seed=2)))
    ref = RefTieredStore()
    for name, a in arrays.items():
        ref.put(name, jnp.asarray(a), tier="host")
    store = store_from_arrays(arrays, device="cpu", tier=HOST)
    assert store.stats.as_dict() == ref.stats.as_dict()
    assert store.stats.host_writes == 2
    assert store.tier_of("x") == HOST
    assert store_from_arrays(arrays, device="cpu").tier_of("y") == DEVICE


# --------------------------------------------- MultiVector / SubspacePass

def test_subspace_pass_consumers_match_reference():
    ref_store, ref, store, mv = _demoted_pair(n=300, b=3, nb=5, seed=3)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((300, 3)).astype(np.float32)
    small = rng.standard_normal((15, 6)).astype(np.float32)
    ops = [
        (lambda m: m.mv_trans_mv(jnp.asarray(w), alpha=0.5),
         lambda m: m.mv_trans_mv(torch.from_numpy(w), alpha=0.5)),
        (lambda m: m.mv_times_mat(jnp.asarray(small)),
         lambda m: m.mv_times_mat(torch.from_numpy(small))),
        (lambda m: m.project_out(jnp.asarray(w)),
         lambda m: m.project_out(torch.from_numpy(w))),
        (lambda m: m.mv_norm(), lambda m: m.mv_norm()),
        (lambda m: m.mv_dot(m), lambda m: m.mv_dot(m)),
        (lambda m: m.to_dense(), lambda m: m.to_dense()),
    ]
    for ref_op, op in ops:
        want, got = ref_op(ref), op(mv)
        if isinstance(want, tuple):
            for g, wt in zip(got, want):
                _close(g, wt)
        else:
            _close(got, want)
        assert store.stats.as_dict() == ref_store.stats.as_dict()
    assert store.stats.passes == 6
    assert mv.ncols == ref.ncols == 15
    assert mv.block_names() == [n.replace(ref.name, mv.name)
                                for n in ref.block_names()]


@pytest.mark.parametrize("fused", [True, False])
def test_bcgs2_matches_reference(fused):
    ref_store, ref, store, mv = _demoted_pair(n=512, b=4, nb=6, seed=5,
                                              orthonormal=True)
    w = np.random.default_rng(6).standard_normal((512, 4)).astype(np.float32)
    ref_store.reset_stats()
    store.reset_stats()
    rq, rh, rr = ref_bcgs2(ref, jnp.asarray(w), impl="ref", fused=fused)
    q, h, r = bcgs2(mv, torch.from_numpy(w), fused=fused)
    for got, want in ((q, rq), (h, rh), (r, rr)):
        _close(got, want)
    assert store.stats.as_dict() == ref_store.stats.as_dict()
    assert ortho_error(q) < 1e-5
    v = mv.to_dense()
    assert float(torch.max(torch.abs(v.T @ q))) < 1e-5
    # the Krylov-step invariant W = V H + Q R
    _close(v @ h + q @ r, w, rtol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_compress_matches_reference(fused):
    ref_store, ref, store, mv = _demoted_pair(n=400, b=4, nb=8, seed=7)
    q = np.random.default_rng(8).standard_normal((32, 16)).astype(np.float32)
    ref_out = ref.compress(jnp.asarray(q), [4] * 4, fused=fused)
    out = mv.compress(torch.from_numpy(q), [4] * 4, fused=fused)
    assert store.stats.as_dict() == ref_store.stats.as_dict()
    _close(out.to_dense(), ref_out.to_dense())
    assert store.stats.as_dict() == ref_store.stats.as_dict()


def test_compress_chunks_past_accumulator_budget():
    ref_store, ref, store, mv = _demoted_pair(n=256, b=4, nb=4, seed=9)
    q = np.random.default_rng(10).standard_normal((16, 12)).astype(np.float32)
    cap = 256 * 4 * 8                   # two output blocks per pass
    ref.compress(jnp.asarray(q), [4] * 3, pass_acc_bytes=cap)
    store.reset_stats()
    ref_store.reset_stats()
    ref.compress(jnp.asarray(q), [4] * 3, pass_acc_bytes=cap)
    mv.compress(torch.from_numpy(q), [4] * 3, pass_acc_bytes=cap)
    assert store.stats.passes == 2
    assert store.stats.as_dict() == ref_store.stats.as_dict()


def _archived():
    with open(os.path.join(REPO, "results", "BENCH_subspace_io.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case,fused", [
    ("expansion", True), ("expansion", False),
    ("compress", True), ("compress", False)])
def test_archived_subspace_io_figures(case, fused):
    """results/BENCH_subspace_io.json at n=4000, b=4, 8 blocks: fused
    expansion 2 passes / 1,024,000 B, unfused 4 / 2,048,000 B; compress
    onto k_keep=16: fused 1 pass / 512,000 B, unfused 4 / 2,048,000 B."""
    arch = _archived()[case]
    tag = "fused" if fused else "unfused"
    n, b, nb = 4000, 4, arch["nblocks"]
    ref_store, ref, store, mv = _demoted_pair(n=n, b=b, nb=nb, seed=0)
    ref_store.reset_stats()
    store.reset_stats()
    if case == "expansion":
        w = np.random.default_rng(9).standard_normal((n, b)).astype(
            np.float32)
        bcgs2(mv, torch.from_numpy(w), fused=fused)
        ref_bcgs2(ref, jnp.asarray(w), impl="ref", fused=fused)
    else:
        k_keep = arch["k_keep"]
        q = np.random.default_rng(10).standard_normal(
            (nb * b, k_keep)).astype(np.float32)
        mv.compress(torch.from_numpy(q), [b] * (k_keep // b), fused=fused)
        ref.compress(jnp.asarray(q), [b] * (k_keep // b), fused=fused)
    assert store.stats.host_bytes_read == arch[tag]["host_bytes_read"]
    assert store.stats.passes == arch[tag]["passes"]
    assert store.stats.as_dict() == ref_store.stats.as_dict()


def test_cholqr_matches_reference():
    x = np.random.default_rng(11).standard_normal((700, 5)).astype(np.float32)
    rq, rr = ref_cholqr(jnp.asarray(x), impl="ref")
    q, r = cholqr(torch.from_numpy(x))
    _close(q, rq)
    _close(r, rr)
    assert ortho_error(q) < 1e-6
    # an ill-conditioned block (κ ≈ 1e3, inside CholQR²'s f32 range)
    # amplifies the order of summation too far for a parity check: hold
    # the port to CholQR²'s invariants instead
    x[:, 4] = x[:, 3] + 1e-3 * x[:, 4]
    q, r = cholqr(torch.from_numpy(x))
    assert ortho_error(q) < 1e-4
    _close(q @ r, x, rtol=1e-4)


# -------------------------------------------------------------- operators

def test_graph_operator_matches_reference():
    n = 900
    r, c, v = ref_rmat_spectral(n, 7000, seed=12)
    ref_tm = ref_pack_tiles(n, n, r, c, v, block_shape=(64, 64),
                            min_block_nnz=4)
    tm = tiled_from_arrays(dataclasses.asdict(ref_tm))
    ref_store, store = RefTieredStore(), TieredStore(device="cpu")
    ref_op = RefGraphOperator(ref_tm, store=ref_store, impl="ref")
    op = GraphOperator(tm, store=store)
    assert op.device.type == "cpu" and op.n == ref_op.n
    x = np.random.default_rng(13).standard_normal((op.n, 4)).astype(
        np.float32)
    for _ in range(2):
        _close(op.matmat(torch.from_numpy(x)),
               ref_op.matmat(jnp.asarray(x)), rtol=1e-6)
    assert store.stats.as_dict() == ref_store.stats.as_dict()
    assert store.stats.host_bytes_read == 2 * ref_tm.nbytes_image()
    # the streamed image lives in a store (tests/test_torch_safs.py)
    with pytest.raises(ValueError, match="requires a TieredStore"):
        GraphOperator(tm, stream_image=True, device="cpu")


def _dense_abs(tm) -> np.ndarray:
    """|A| of an image in float64 (bf16 blocks widened exactly)."""
    bm, bn = tm.block_shape
    out = np.zeros(tm.shape, np.float64)
    blocks = np.abs(tm.blocks.astype(np.float64))
    for i in range(tm.n_block_rows):
        for j in range(tm.row_ptr[i], tm.row_ptr[i + 1]):
            c = tm.block_cols[j] * bn
            out[i * bm:(i + 1) * bm, c:c + bn] += blocks[j]
    np.add.at(out, (tm.coo_rows, tm.coo_cols), np.abs(tm.coo_vals))
    return out


def test_graph_operator_bf16_image_matches_reference():
    """A bf16 image (numpy's ml_dtypes.bfloat16 blocks, as the reference
    takes them) of a packed normalized-adjacency R-MAT graph: the port
    uploads the raw 16-bit words, and matmat stays float32 in and out.
    Each product of a bf16 entry and a float32 x is exact in float32, so
    the two packages differ only in the order of the sums: within 1e-6 of
    Σ|terms| per output."""
    import ml_dtypes
    n = 1000
    r, c, v = ref_rmat_graph(n, 8000, seed=31, symmetric=True)
    r, c, v = ref_normalized(n, r, c, v)
    ref_f32 = ref_pack_tiles(n, n, r, c, v, block_shape=(64, 64),
                             min_block_nnz=4)
    ref_tm = dataclasses.replace(
        ref_f32, blocks=ref_f32.blocks.astype(ml_dtypes.bfloat16))
    f32_tm = tiled_from_arrays(dataclasses.asdict(ref_f32))
    tm = dataclasses.replace(f32_tm, blocks=ref_tm.blocks)
    assert not np.array_equal(ref_tm.blocks.astype(np.float32),
                              ref_f32.blocks)     # the cast rounds
    assert tm.blocks.dtype.name == "bfloat16" and tm.nblocks > 10
    assert tm.coo_vals.size > 0
    ref_store, store = RefTieredStore(), TieredStore(device="cpu")
    ref_op = RefGraphOperator(ref_tm, store=ref_store, impl="ref")
    op = GraphOperator(tm, store=store)
    assert op._blocks.dtype == torch.bfloat16
    assert np.array_equal(op._blocks.view(torch.int16).numpy(),
                          ref_tm.blocks.view(np.int16))
    x = np.random.default_rng(32).standard_normal((op.n, 4)).astype(
        np.float32)
    scale = _dense_abs(ref_tm) @ np.abs(x).astype(np.float64)
    for _ in range(2):
        got = op.matmat(torch.from_numpy(x))
        want = np.asarray(ref_op.matmat(jnp.asarray(x)))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        diff = np.abs(got.numpy().astype(np.float64) - want)
        assert np.all(diff <= 1e-6 * scale), float(np.max(diff))
    assert store.stats.as_dict() == ref_store.stats.as_dict()
    assert store.stats.host_bytes_read == 2 * ref_tm.nbytes_image()
    assert ref_tm.nbytes_image() < f32_tm.nbytes_image()
    # the float32 operator cast on its device (round to nearest even, as
    # ml_dtypes casts) is the bf16 image's operator
    cast = GraphOperator(f32_tm, store=TieredStore(device="cpu")).astype(
        torch.bfloat16)
    assert torch.equal(cast._blocks.view(torch.int16),
                       op._blocks.view(torch.int16))
    assert cast._image_bytes == ref_tm.nbytes_image()
    assert torch.equal(cast.matmat(torch.from_numpy(x)),
                       op.matmat(torch.from_numpy(x)))


def test_dense_operator_and_sort_ritz():
    a = np.random.default_rng(14).standard_normal((6, 6)).astype(np.float32)
    op = DenseOperator(a, device="cpu")
    x = np.eye(6, 2, dtype=np.float32)
    np.testing.assert_allclose(op.matmat(torch.from_numpy(x)).numpy(),
                               a @ x, rtol=1e-6)
    theta = np.array([0.5, -2.0, 1.5, -0.1, 2.0])
    for which in ("LM", "LA", "SA"):
        assert np.array_equal(sort_ritz(theta, which),
                              ref_sort_ritz(jnp.asarray(theta), which))
    with pytest.raises(ValueError):
        sort_ritz(theta, "XX")
