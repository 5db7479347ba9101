"""The generator is a function of the seed alone."""
import numpy as np
import torch

from eigbench.gen import kronecker

SPEC = {"generator": "kronecker", "initiator": [0.57, 0.19, 0.19],
        "symmetric": True, "values": "normalized", "scale": 10,
        "edge_factor": 8}
BIG = 2 ** 31 + 12345          # the driver's seeds pass 32 signed bits


def test_same_seed_same_graph_other_seed_other_graph():
    a = kronecker.make_graph(SPEC, BIG, "cpu")
    b = kronecker.make_graph(SPEC, BIG, "cpu")
    c = kronecker.make_graph(SPEC, BIG + 1, "cpu")
    for x, y in ((a.rows, b.rows), (a.cols, b.cols), (a.vals, b.vals)):
        assert np.array_equal(x, y)
    assert a.nnz != c.nnz or not np.array_equal(a.cols, c.cols)
    assert a.rows.dtype == np.int32 and a.vals.dtype == np.float32


def test_symmetric_normalized_graph():
    g = kronecker.make_graph(SPEC, 5, "cpu")
    assert np.all(g.rows != g.cols)
    key = g.rows.astype(np.int64) * g.n + g.cols
    assert np.all(np.diff(key) > 0)               # sorted, no duplicates
    tkey = g.cols.astype(np.int64) * g.n + g.rows
    assert np.array_equal(np.sort(tkey), key)
    deg = np.bincount(g.rows, minlength=g.n).astype(np.float64)
    want = 1.0 / np.sqrt(deg[g.rows] * deg[g.cols])
    np.testing.assert_allclose(g.vals, want, rtol=1e-7)
    # the first edge_factor·n non-loop draws, before symmetry and merging
    assert g.nnz <= 2 * SPEC["edge_factor"] * g.n


def test_largest_component_only():
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    sparse = SPEC | {"edge_factor": 2}        # several small components
    full = kronecker.make_graph(sparse, 6, "cpu")
    lcc = kronecker.make_graph(sparse | {"component": "largest"}, 6, "cpu")
    a = sp.csr_matrix((np.ones(full.nnz), (full.rows, full.cols)),
                      shape=(full.n, full.n))
    _, label = connected_components(a, directed=False)
    sizes = np.bincount(label)
    big = np.flatnonzero(label == np.argmax(sizes))
    assert sizes.max() < full.n and (sizes > 1).sum() > 1
    assert np.array_equal(np.unique(lcc.rows), big)
    inside = np.isin(full.rows, big)
    assert np.array_equal(lcc.rows, full.rows[inside])
    assert np.array_equal(lcc.cols, full.cols[inside])
    deg = np.bincount(lcc.rows, minlength=lcc.n).astype(np.float64)
    np.testing.assert_allclose(
        lcc.vals, 1.0 / np.sqrt(deg[lcc.rows] * deg[lcc.cols]), rtol=1e-7)


def test_directed_graph_of_ones():
    g = kronecker.make_graph(SPEC | {"symmetric": False, "values": "ones"},
                             3, "cpu")
    assert np.all(g.vals == 1.0)
    key = g.rows.astype(np.int64) * g.n + g.cols
    assert np.all(np.diff(key) > 0)


def test_start_blocks_follow_seed_and_stream():
    x = kronecker.start_block(256, 4, BIG, kronecker.solve_stream(0), "cpu")
    y = kronecker.start_block(256, 4, BIG, kronecker.solve_stream(0), "cpu")
    z = kronecker.start_block(256, 4, BIG, kronecker.solve_stream(1), "cpu")
    w = kronecker.start_block(256, 4, BIG, kronecker.WARMUP_STREAM, "cpu")
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert not torch.equal(x, w) and x.dtype == torch.float32
    order = kronecker.pool_order(BIG, 16)
    assert sorted(order) == list(range(16))
    assert order == kronecker.pool_order(BIG, 16) != kronecker.pool_order(
        BIG + 1, 16)
    pool = [kronecker.window_block(256, 4, BIG, i, 16, "cpu")
            for i in range(17)]
    other = [kronecker.window_block(256, 4, 7, i, 16, "cpu")
             for i in range(16)]
    assert torch.equal(pool[0], pool[16])
    assert torch.equal(torch.stack(sorted(pool[:16], key=lambda t: t.sum())),
                       torch.stack(sorted(other, key=lambda t: t.sum())))
    seeds = {kronecker.derive_seed(s, k) for s in (0, 1, BIG, 2 ** 70)
             for k in range(4)}
    assert len(seeds) == 16 and all(0 <= s < 2 ** 63 for s in seeds)
