"""repro_torch.graphs.partition against `tests/test_partition.py`: the
same properties, and outputs equal to `repro.graphs.partition` on the
same inputs."""
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.graphs import partition as ref
from repro_torch.graphs import balance_tile_rows, imbalance, tile_row_costs


@given(st.lists(st.floats(0.1, 100.0), min_size=8, max_size=200),
       st.integers(2, 16))
@settings(max_examples=40, deadline=None)
def test_contiguous_partition_valid_and_equal(costs, n_shards):
    costs = np.array(costs)
    a = balance_tile_rows(costs, n_shards)
    np.testing.assert_array_equal(a, ref.balance_tile_rows(costs, n_shards))
    assert a.dtype == np.int32
    assert (np.diff(a) >= 0).all()
    assert a.min() == 0 and a.max() <= n_shards - 1
    loads = np.zeros(n_shards)
    np.add.at(loads, a, costs)
    lb = max(costs.sum() / n_shards, costs.max())
    assert loads.max() <= 2.0 * lb + 1e-6


@given(st.lists(st.floats(0.1, 100.0), min_size=8, max_size=200),
       st.integers(2, 16))
@settings(max_examples=40, deadline=None)
def test_lpt_beats_or_ties_naive_and_equal(costs, n_shards):
    costs = np.array(costs)
    a = balance_tile_rows(costs, n_shards, contiguous=False)
    np.testing.assert_array_equal(
        a, ref.balance_tile_rows(costs, n_shards, contiguous=False))
    naive = np.arange(len(costs)) % n_shards
    assert imbalance(costs, a, n_shards) <= \
        imbalance(costs, naive, n_shards) + 0.5
    assert imbalance(costs, a, n_shards) == ref.imbalance(costs, a,
                                                          n_shards)


def test_powerlaw_balance():
    """Power-law tile rows (the paper's skew case): LPT is near the
    lower bound max(mean, largest single row)."""
    rng = np.random.default_rng(0)
    costs = rng.zipf(1.5, size=512).astype(np.float64)
    a = balance_tile_rows(costs, 48, contiguous=False)
    np.testing.assert_array_equal(
        a, ref.balance_tile_rows(costs, 48, contiguous=False))
    mean_load = costs.sum() / 48
    lb = max(1.0, costs.max() / mean_load)
    assert imbalance(costs, a, 48) <= 1.05 * lb + 0.1


def test_tile_row_costs_from_ptr_and_nnz():
    row_ptr = np.array([0, 2, 2, 5])
    np.testing.assert_array_equal(tile_row_costs(row_ptr), [2, 0, 3])
    nnz = np.array([3, 1, 4, 1, 5])
    np.testing.assert_array_equal(tile_row_costs(row_ptr, nnz),
                                  ref.tile_row_costs(row_ptr, nnz))
    np.testing.assert_array_equal(tile_row_costs(row_ptr, nnz), [4, 0, 10])
    assert balance_tile_rows(np.zeros(0), 4).shape == (0,)
    assert (balance_tile_rows(np.ones(5), 1) == 0).all()
