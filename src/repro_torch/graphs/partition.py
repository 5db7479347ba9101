"""Tile-row partitioning with load balancing (a copy of
`repro.graphs.partition`, numpy only).

The paper balances power-law skew with runtime work stealing (§3.3.3). TPUs
are SPMD, so we move the balancing to pack time: tile rows are assigned to
shards by LPT (longest-processing-time) bin packing on nnz cost, then an
optional contiguous re-chunking keeps each shard a contiguous row range
(required for row-interval sharded TAS vectors).
"""
from __future__ import annotations

import numpy as np


def tile_row_costs(row_ptr: np.ndarray, blocks_nnz: np.ndarray | None = None,
                   block_cost: float = 1.0) -> np.ndarray:
    """Cost per tile row = number of blocks (or true nnz when provided)."""
    nb = np.diff(row_ptr).astype(np.float64)
    if blocks_nnz is None:
        return nb * block_cost
    costs = np.zeros(row_ptr.shape[0] - 1, dtype=np.float64)
    for br in range(costs.shape[0]):
        costs[br] = blocks_nnz[row_ptr[br]:row_ptr[br + 1]].sum()
    return costs


def balance_tile_rows(costs: np.ndarray, n_shards: int,
                      *, contiguous: bool = True) -> np.ndarray:
    """Assign tile rows to shards.

    contiguous=True (default): optimal contiguous partition via the
      classic binary-search-on-bottleneck algorithm — each shard gets a
      contiguous run of tile rows (needed for row-interval sharding).
    contiguous=False: LPT bin packing (lower imbalance, non-contiguous;
      usable by the standalone SpMM where output rows are permuted).

    Returns assignment (n_tile_rows,) int32 of shard ids.
    """
    n = costs.shape[0]
    if n_shards <= 1 or n == 0:
        return np.zeros(n, dtype=np.int32)
    if not contiguous:
        order = np.argsort(-costs)
        load = np.zeros(n_shards)
        assign = np.zeros(n, dtype=np.int32)
        for i in order:
            s = int(np.argmin(load))
            assign[i] = s
            load[s] += costs[i]
        return assign

    # binary search the bottleneck for contiguous partition
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    lo, hi = float(costs.max(initial=0.0)), float(prefix[-1])

    def n_parts_needed(cap: float) -> int:
        parts, start = 0, 0
        while start < n:
            end = int(np.searchsorted(prefix, prefix[start] + cap, side="right")) - 1
            end = max(end, start + 1)
            parts += 1
            start = end
        return parts

    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if n_parts_needed(mid) <= n_shards:
            hi = mid
        else:
            lo = mid
    cap = hi
    assign = np.zeros(n, dtype=np.int32)
    start, shard = 0, 0
    while start < n:
        end = int(np.searchsorted(prefix, prefix[start] + cap, side="right")) - 1
        end = max(end, start + 1)
        # reserve ≥1 row for each remaining shard (when rows suffice)
        reserve = min(n_shards - shard - 1, n - start - 1)
        end = min(end, n - reserve)
        end = max(end, start + 1)
        assign[start:end] = min(shard, n_shards - 1)
        start, shard = end, shard + 1
    return assign


def imbalance(costs: np.ndarray, assign: np.ndarray, n_shards: int) -> float:
    """max_load / mean_load — 1.0 is perfect."""
    loads = np.zeros(n_shards)
    np.add.at(loads, assign, costs)
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0
