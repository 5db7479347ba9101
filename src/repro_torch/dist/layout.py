"""Vertex layout for the sharded SpMM (paper §3.2–3.3, device-level analogue).

A copy of `repro.dist.layout` (pure numpy), so that the port imports no
module of the reference; the two are held bit-equal by
tests/test_torch_dist_layout.py.

The paper partitions the graph into a 2D grid of edge *panels*: row panels
bound the working-set of the output ("TAS" rows held in fast memory), column
panels bound the rows of the dense subspace that one panel gathers from.
Here the grid is a (pod, data, model) mesh of ranks (`dist.comm.Mesh`):

  * the non-"model" axes (pod × data, or just data) form R row groups,
  * the "model" axis forms M column groups,
  * the n_pad vertex positions are split into R·M equal contiguous shards,
    shard index = g·M + m for the device with row coordinate g and model
    coordinate m (the rank order of `comm.Mesh`, which is jax's
    P(("pod","data","model")) layout order in the reference).

Row group g therefore owns the contiguous position range
[g·n_pad/R, (g+1)·n_pad/R); column group m owns the M-strided shard set
{g·M + m : g}. `vertex_permutation` assigns natural vertex ids to positions
round-robin over the shards so that the hub vertices of a power-law graph
(concentrated at low ids after R-MAT generation) spread evenly over devices
— the paper's load-balancing motivation for randomized vertex placement.
"""
from __future__ import annotations

import numpy as np

# Each per-device shard is padded to a multiple of this many vertex rows so
# panel tiles stay aligned for the kernels layer.
SHARD_MULTIPLE = 8


def n_shards(r_groups: int, m_groups: int) -> int:
    return r_groups * m_groups


def padded_n(n: int, r_groups: int, m_groups: int,
             *, multiple: int = SHARD_MULTIPLE) -> int:
    """Smallest n_pad >= n divisible by r_groups·m_groups·multiple.

    Divisibility by R·M gives equal per-device shards; the extra `multiple`
    keeps every shard length a multiple of the tile row unit.
    """
    base = r_groups * m_groups * multiple
    return -(-n // base) * base


def shard_size(n_pad: int, r_groups: int, m_groups: int) -> int:
    """Per-device vertex rows s = n_pad / (R·M)."""
    s, rem = divmod(n_pad, r_groups * m_groups)
    assert rem == 0, (n_pad, r_groups, m_groups)
    return s


def vertex_permutation(n_pad: int, r_groups: int,
                       m_groups: int) -> np.ndarray:
    """Bijective map natural-vertex-id -> mesh position, length n_pad.

    Vertex i goes to shard i mod (R·M) at offset i // (R·M): round-robin
    over devices, so consecutive (and in R-MAT graphs, high-degree) vertices
    land on different devices. Padding ids n..n_pad-1 fill the remaining
    positions under the same rule, keeping the map a permutation.
    """
    nd = n_shards(r_groups, m_groups)
    s = shard_size(n_pad, r_groups, m_groups)
    i = np.arange(n_pad, dtype=np.int64)
    return (i % nd) * s + i // nd


def row_group_of(pos: np.ndarray, n_pad: int, r_groups: int) -> np.ndarray:
    """Row group (0..R-1) owning each position: contiguous n_pad/R blocks."""
    return pos // (n_pad // r_groups)


def col_group_of(pos: np.ndarray, n_pad: int, r_groups: int,
                 m_groups: int) -> np.ndarray:
    """Column group (0..M-1): the shard index mod M."""
    s = shard_size(n_pad, r_groups, m_groups)
    return (pos // s) % m_groups


def local_row(pos: np.ndarray, n_pad: int, r_groups: int) -> np.ndarray:
    """Offset of a position inside its row group's contiguous block."""
    return pos % (n_pad // r_groups)


def local_col(pos: np.ndarray, n_pad: int, r_groups: int,
              m_groups: int) -> np.ndarray:
    """Index of a position inside its column group's gathered buffer.

    A column group's positions are the M-strided shards {g·M + m : g}. The
    SpMM all-gathers them over the row axes in row-group order, so position
    q in shard g·M + m lands at g·s + (q mod s) of the (n_pad/M)-row buffer.
    """
    s = shard_size(n_pad, r_groups, m_groups)
    return (pos // s // m_groups) * s + pos % s


def unlocal_col(c_loc: np.ndarray, m: int, n_pad: int, r_groups: int,
                m_groups: int) -> np.ndarray:
    """Inverse of `local_col` for column group m (testing/debug helper)."""
    s = shard_size(n_pad, r_groups, m_groups)
    return (c_loc // s * m_groups + m) * s + c_loc % s
