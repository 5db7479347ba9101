"""The port's sharded layer on one process, held to the reference on the
same numpy inputs: the layout maps, the panel packing, the 6-byte/edge
stream (bf16 values compared as their 16-bit words), its decoding and
the block re-tiling bit for bit; the block-sparse bridge against the
scatter product (1e-6: both sum float32 products, in another order); the
int8/top-k point APIs; and a one-rank `DistOperator` under the port's
`eigsh` against the reference's `test_dist_operator_single_device_parity`
case (eigenvalues rtol 1e-5, `IOStats` equal to the byte)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.dist import layout as rlayout
from repro.dist import dspmm as rdspmm
from repro.dist import compress as rcompress
from repro.graphs import rmat_graph as r_rmat_graph
from repro_torch.dist import comm, compress, dspmm, layout
from repro_torch.dist.dspmm import (pack_compressed_panels, pack_edge_panels,
                                    panel_spmm_blocksparse)

GRIDS = [(1, 1), (2, 1), (1, 3), (4, 2), (8, 4)]


def _panels(n, nnz, seed, r_groups, m_groups):
    r, c, v = r_rmat_graph(n, nnz, seed=seed, symmetric=True)
    n_pad = layout.padded_n(n, r_groups, m_groups)
    perm = layout.vertex_permutation(n_pad, r_groups, m_groups)
    return n_pad, perm, (r, c, v)


@pytest.mark.parametrize("r_groups,m_groups", GRIDS)
@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_layout_maps_equal_reference(n, r_groups, m_groups):
    n_pad = layout.padded_n(n, r_groups, m_groups)
    assert n_pad == rlayout.padded_n(n, r_groups, m_groups)
    assert layout.SHARD_MULTIPLE == rlayout.SHARD_MULTIPLE
    assert (layout.shard_size(n_pad, r_groups, m_groups)
            == rlayout.shard_size(n_pad, r_groups, m_groups))
    np.testing.assert_array_equal(
        layout.vertex_permutation(n_pad, r_groups, m_groups),
        rlayout.vertex_permutation(n_pad, r_groups, m_groups))
    pos = np.arange(n_pad)
    for name, args in (("row_group_of", (n_pad, r_groups)),
                       ("col_group_of", (n_pad, r_groups, m_groups)),
                       ("local_row", (n_pad, r_groups)),
                       ("local_col", (n_pad, r_groups, m_groups))):
        np.testing.assert_array_equal(getattr(layout, name)(pos, *args),
                                      getattr(rlayout, name)(pos, *args))
    c_loc = layout.local_col(pos, n_pad, r_groups, m_groups)
    m = layout.col_group_of(pos, n_pad, r_groups, m_groups)
    for mm in range(m_groups):
        sel = m == mm
        np.testing.assert_array_equal(
            layout.unlocal_col(c_loc[sel], mm, n_pad, r_groups, m_groups),
            rlayout.unlocal_col(c_loc[sel], mm, n_pad, r_groups, m_groups))


@pytest.mark.parametrize("r_groups,m_groups", [(2, 2), (4, 2), (3, 1),
                                               (1, 1)])
def test_pack_edge_panels_bit_equal(r_groups, m_groups):
    n_pad, perm, (r, c, v) = _panels(257, 1500, 3, r_groups, m_groups)
    got = pack_edge_panels(n_pad, perm[r], perm[c], v, r_groups=r_groups,
                           m_groups=m_groups)
    want = rdspmm.pack_edge_panels(n_pad, perm[r], perm[c], v,
                                   r_groups=r_groups, m_groups=m_groups)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("r_groups,m_groups", [(2, 2), (4, 2), (3, 1),
                                               (1, 1)])
def test_pack_local_panel_is_the_grids_panel(r_groups, m_groups):
    """Each rank's own panel, packed alone, is the reference grid's panel
    [g, m] bit for bit, with the grid's e_loc."""
    n_pad, perm, (r, c, v) = _panels(257, 1500, 3, r_groups, m_groups)
    want = rdspmm.pack_edge_panels(n_pad, perm[r], perm[c], v,
                                   r_groups=r_groups, m_groups=m_groups)
    for g in range(r_groups):
        for m in range(m_groups):
            got = dspmm.pack_local_panel(n_pad, perm[r], perm[c], v,
                                         r_groups=r_groups,
                                         m_groups=m_groups, g=g, m=m)
            assert got[3] == want[3]
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b[g, m])


def _compressed_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.uint32 and got[1].dtype == np.int32
    assert got[2].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[2].view(torch.int16).numpy()
                                  .view(np.uint16),
                                  np.asarray(want[2]).view(np.uint16))


@pytest.mark.parametrize("chunk", [64, 4096])
def test_pack_compressed_panels_bit_equal(chunk):
    n_pad, perm, (r, c, v) = _panels(200, 1200, 9, 2, 2)
    pc, pr, pv, _ = pack_edge_panels(n_pad, perm[r], perm[c], v,
                                     r_groups=2, m_groups=2)
    # weights that bf16 rounds (ties included), as a normalized graph has
    pv = (pv * np.float32(1.0 / 3.0)).astype(np.float32)
    _compressed_equal(pack_compressed_panels(pc, pr, pv, chunk=chunk),
                      rdspmm.pack_compressed_panels(pc, pr, pv, chunk=chunk))


def test_pack_compressed_subtile_rebasing_bit_equal():
    """The reference's 16-bit boundary cases (tests/test_dist_layout.py):
    a row fanning out across a 200k-wide panel re-bases at sub-tile
    granularity; a span of exactly 0xFFFF does not; one past it halves."""
    chunk = 64
    e = 2 * chunk
    cases = []
    pc = np.zeros((1, 1, e), np.int32)
    pc[0, 0] = np.linspace(0, 200_000, e).astype(np.int32)
    cases.append((pc, np.zeros_like(pc), np.ones((1, 1, e), np.float32)))
    pc2 = np.zeros((1, 1, chunk), np.int32)
    pc2[0, 0, -1] = 0xFFFF
    cases.append((pc2, np.zeros_like(pc2), np.ones((1, 1, chunk),
                                                   np.float32)))
    pc3 = np.zeros((1, 1, chunk), np.int32)
    pc3[0, 0, chunk // 2:] = 0x10000
    cases.append((pc3, np.zeros_like(pc3), np.ones((1, 1, chunk),
                                                   np.float32)))
    subs = []
    for pc, pr, pv in cases:
        got = pack_compressed_panels(pc, pr, pv, chunk=chunk)
        _compressed_equal(got, rdspmm.pack_compressed_panels(
            pc, pr, pv, chunk=chunk))
        subs.append(got[0].shape[-1] // (got[1].shape[-1] // 2))
        rr, cc = dspmm._unpack_edges(
            torch.from_numpy(got[0][0, 0].view(np.int32)),
            torch.from_numpy(got[1][0, 0]))
        np.testing.assert_array_equal(rr.numpy(), pr[0, 0])
        np.testing.assert_array_equal(cc.numpy(), pc[0, 0])
    assert subs[0] < chunk and subs[1] == chunk and subs[2] == chunk // 2


def test_unpack_edges_bit_equal():
    chunk = 32
    e = 3 * chunk
    pr = np.random.default_rng(0).integers(0, 50, (1, 1, e)).astype(np.int32)
    pc = np.sort(np.random.default_rng(1)
                 .integers(0, 200_000, (1, 1, e)).astype(np.int32))
    pv = np.ones((1, 1, e), np.float32)
    packed, bases, _ = pack_compressed_panels(pc, pr, pv, chunk=chunk)
    want = [np.asarray(a) for a in
            jax.jit(rdspmm._unpack_edges)(packed[0, 0], bases[0, 0])]
    for words in (packed[0, 0].view(np.int32), packed[0, 0].astype(np.int64)):
        got = dspmm._unpack_edges(torch.from_numpy(words),
                                  torch.from_numpy(bases[0, 0]))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("bm,bn", [(8, 8), (16, 8)])
def test_panel_to_blocks_bit_equal_and_bridge(bm, bn):
    """panel_to_blocks equals the reference's; the bridge (the reference's
    own fails on this jax, ROADMAP queue 3) agrees with the scatter
    product of the dense panel within 1e-6 of its largest magnitude."""
    n, r_groups, m_groups = 64, 2, 2
    n_pad, perm, (r, c, v) = _panels(n, 500, 1, r_groups, m_groups)
    pc, pr, pv, _ = pack_edge_panels(n_pad, perm[r], perm[c], v,
                                     r_groups=r_groups, m_groups=m_groups)
    dense = np.zeros((n_pad, n_pad), np.float32)
    dense[perm[r], perm[c]] = v
    x = np.random.default_rng(0).standard_normal((n_pad, 4)).astype(
        np.float32)
    n_rows, n_cols = n_pad // r_groups, n_pad // m_groups
    for g in range(r_groups):
        for m in range(m_groups):
            got = dspmm.panel_to_blocks(pr[g, m], pc[g, m], pv[g, m], n_rows,
                                        n_cols, bm=bm, bn=bn)
            want = rdspmm.panel_to_blocks(pr[g, m], pc[g, m], pv[g, m],
                                          n_rows, n_cols, bm=bm, bn=bn)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            cols = layout.unlocal_col(np.arange(n_cols), m, n_pad, r_groups,
                                      m_groups)
            y = panel_spmm_blocksparse(pr[g, m], pc[g, m], pv[g, m],
                                       torch.from_numpy(x[cols]), n_rows,
                                       bm=bm, bn=bn)
            prod = (dense[g * n_rows:(g + 1) * n_rows][:, cols].astype(
                np.float64) @ x[cols])
            np.testing.assert_allclose(y.numpy(), prod, rtol=0,
                                       atol=1e-6 * np.abs(prod).max())


def test_point_compression_equals_reference():
    x = np.random.default_rng(42).standard_normal((256,)).astype(np.float32)
    q, s = compress.int8_quantize(torch.from_numpy(x))
    rq, rs = rcompress.int8_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    back = compress.int8_dequantize(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(rcompress.int8_dequantize(rq,
                                                                       rs)))
    assert np.abs(back.numpy() - x).max() <= float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("seed", [0, 3])
def test_topk_error_feedback_equals_reference(seed):
    g = np.random.default_rng(seed).standard_normal((64,)).astype(np.float32)
    st, rst = compress.topk_init(torch.from_numpy(g)), rcompress.topk_init(
        jnp.asarray(g))
    acc = np.zeros(64, np.float32)
    for _ in range(24):
        vals, idx, st = compress.topk_compress(torch.from_numpy(g), st, k=8)
        rvals, ridx, rst = rcompress.topk_compress(jnp.asarray(g), rst, k=8)
        np.testing.assert_array_equal(np.sort(idx.numpy()),
                                      np.sort(np.asarray(ridx)))
        np.testing.assert_array_equal(st.error.numpy(), np.asarray(rst.error))
        acc += compress.topk_decompress(vals, idx, (64,)).numpy()
    np.testing.assert_allclose(acc / 24, g, rtol=0.35, atol=0.35)


def test_placement_specs_pick_this_ranks_piece():
    mesh = comm.Mesh((1, 1, 1), device="cpu")
    assert dspmm.edge_spec(mesh) == (("pod", "data"), "model", None)
    assert dspmm.vector_spec(mesh) == (("pod", "data", "model"), None)
    a = np.arange(12).reshape(1, 1, 12)
    np.testing.assert_array_equal(
        dspmm.local_shard(a, dspmm.edge_spec(mesh), mesh), a[0, 0])
    x = np.arange(8)
    np.testing.assert_array_equal(
        dspmm.local_shard(x, dspmm.vector_spec(mesh), mesh), x)
    with pytest.raises(RuntimeError, match="needs a torch.distributed"):
        comm.Mesh((2, 1, 1), device="cpu")


def test_no_card_no_quiet_fallback(monkeypatch):
    """Without device="cpu" the sharded layer needs the card, and raises
    where there is none; nccl needs a card per rank."""
    from repro_torch.dist import DistOperator, spawn
    from repro_torch.dist.dist_operator import pod_compressed_deviation
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r, c, v = r_rmat_graph(64, 300, seed=1, symmetric=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        DistOperator(64, r, c, v)
    with pytest.raises(RuntimeError, match="CUDA device"):
        spawn(pod_compressed_deviation, (1, 1, 2), backend="gloo")
    with pytest.raises(RuntimeError, match="CUDA device"):
        comm.Mesh((1, 1, 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        comm.check_backend("nccl", torch.device("cuda", 0), 2)
    with pytest.raises(ValueError, match="nccl moves CUDA tensors"):
        comm.check_backend("nccl", torch.device("cpu"), 1)
    with pytest.raises(ValueError, match="backend must be"):
        spawn(pod_compressed_deviation, (1, 1, 1), backend="mpi",
              device="cpu")


def test_one_rank_dist_operator_matches_reference():
    """The reference's test_dist_operator_single_device_parity case: n =
    500, rmat_spectral(500, 5000, seed=7), nev 4, b 2, tol 1e-7, the
    reference's own start draw as x0. The port's eigsh takes the fused
    branch; eigenvalues within rtol 1e-5 and IOStats equal to the byte;
    the eigenvectors (position space) satisfy the natural-space eigen
    equation once mapped back through pad_to_nat."""
    from repro.core import eigsh as r_eigsh
    from repro.dist import DistOperator as RDist
    from repro.graphs import rmat_spectral
    from repro.graphs.synth import to_dense
    from repro_torch.core import eigsh
    from repro_torch.dist import DistOperator
    n = 500
    r, c, v = rmat_spectral(n, 5000, seed=7)
    rdop = RDist(n, r, c, v)
    ref = r_eigsh(rdop, 4, block_size=2, tol=1e-7, max_restarts=100,
                  impl="ref")
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (rdop.n, 2),
                                      jnp.float32))
    dop = DistOperator(n, r, c, v, device="cpu")
    res = eigsh(dop, 4, block_size=2, tol=1e-7, max_restarts=100, x0=x0)
    assert dop.n_fused_steps > 0 and res.converged
    assert dop.n == rdop.n
    np.testing.assert_array_equal(dop.perm, rdop.perm)
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=1e-5)
    assert res.n_restarts == ref.n_restarts
    assert res.io_stats == ref.io_stats
    x = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_array_equal(dop.pad_to_nat(dop.nat_to_pad(x)), x)
    a = to_dense(n, r, c, v)
    vec = dop.pad_to_nat(res.eigenvectors).numpy()
    resid = np.linalg.norm(a @ vec - vec * res.eigenvalues[None, :], axis=0)
    assert resid.max() < 1e-3, resid
    # one step's collectives, per rank, equal the analytic count
    assert dict(dop.mesh.bytes)["all_gather"] == dop.analytic_bytes[
        "all_gather"]
    for kind in ("reduce_scatter", "all_reduce"):
        assert dop.mesh.bytes[kind] == dop.analytic_bytes[kind]


def test_traced_dist_solve_spans_carry_collective_bytes(tmp_path):
    """A traced solve over a one-rank DistOperator: every fused expansion
    is an `operator.fused_expand` span whose collective_bytes are that
    step's share of the design's count (one SpMM of n_pad·b·4 bytes
    gathered and reduced, CGS2 and CholQR2 sums of (2·nb_v·b² + 2·b²)·4),
    a matmat an `operator.matmat` span; the trace passes
    both packages' `validate`."""
    from repro.obs import report as ref_report
    from repro_torch.core import solve, true_residuals
    from repro_torch.dist import DistOperator
    from repro_torch.graphs import rmat_spectral
    from repro_torch.obs import Tracer, report, tracing
    r, c, v = rmat_spectral(300, 2500, seed=3)
    dop = DistOperator(300, r, c, v, device="cpu")
    path = tmp_path / "t.jsonl"
    res = solve(dop, 4, block_size=2, tol=1e-6, max_iters=50, trace=path)
    records = report.load(str(path))
    assert report.validate(records) == [] and ref_report.validate(records) == []
    steps = [s for s in report.spans(records)
             if s["name"] == "operator.fused_expand"]
    assert len(steps) == dop.n_fused_steps > 0
    for sp in steps:
        a = sp["args"]
        spmm = 2 * dop.n * a["k"] * 4
        sums = (2 * a["nb_v"] * a["k"] ** 2 + 2 * a["k"] ** 2) * 4
        assert a["collective_bytes"] == spmm + sums, a
    tracer = Tracer()
    with tracing(tracer):
        true_residuals(dop, res.eigenvectors, res.eigenvalues)
    mm = [s for s in report.spans(tracer.records())
          if s["name"] == "operator.matmat"
          and s["args"]["op"] == "DistOperator"]
    assert [s["args"]["collective_bytes"] for s in mm] == [2 * dop.n * 4 * 4]


def test_variant_shares_the_panel_and_matches_a_fresh_operator():
    """`DistOperator.variant` reuses the packed panel image and gives the
    compressed stream and fused steps a freshly built operator gives."""
    from repro_torch.core import eigsh
    from repro_torch.dist import DistOperator
    from repro_torch.graphs import rmat_spectral
    r, c, v = rmat_spectral(300, 2500, seed=3)
    dop = DistOperator(300, r, c, v, device="cpu")
    x0 = np.random.default_rng(1).standard_normal((dop.n, 2)).astype(
        np.float32)
    eigsh(dop, 4, block_size=2, tol=1e-6, max_restarts=50, x0=x0)
    for opts in (dict(compressed=True), dict(pod_compressed=True)):
        var = dop.variant(**opts)
        fresh = DistOperator(300, r, c, v, device="cpu", **opts)
        assert var.panel is dop.panel
        assert var.n_fused_steps == 0 and var.last_hr is None
        if opts.get("compressed"):
            for a in ("packed", "bases", "vals"):
                assert torch.equal(getattr(var.cpanel, a),
                                   getattr(fresh.cpanel, a))
        res_v = eigsh(var, 4, block_size=2, tol=1e-6, max_restarts=50,
                      x0=x0)
        res_f = eigsh(fresh, 4, block_size=2, tol=1e-6, max_restarts=50,
                      x0=x0)
        np.testing.assert_array_equal(res_v.eigenvalues, res_f.eigenvalues)
        assert var.n_fused_steps == fresh.n_fused_steps > 0
        assert var.analytic_bytes == fresh.analytic_bytes
    assert dop.cpanel is None and not dop.pod_compressed
