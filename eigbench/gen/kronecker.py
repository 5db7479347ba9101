"""Graph500 Kronecker (R-MAT) graphs drawn on the device from a seed.

The same arithmetic as the port's `graphs.synth.rmat_graph`, written
here in torch so that the draw runs on the card: each of
`edge_draws · oversample + 16` candidate edges picks one quadrant of the
initiator (A, B, C, D) at each of `scale` levels (row bit: C or D; column
bit: B or D), self loops are rejected and the first `edge_draws` kept.
A symmetric graph adds every edge's reverse; duplicates are merged (all
entries are 1). Vertices are not relabelled, as `rmat_graph` does not,
so the hubs sit at low indices and the image keeps its dense blocks.

`component: "largest"` keeps the edges of the largest connected
component only (found on the device by label propagation), as spectral
clustering does: the vertices of the small components stay in place as
empty rows. Each small component would put a copy of the eigenvalue 1
(and −1 where it is bipartite) into the normalized adjacency, so that
the wanted end of the spectrum would be those copies.

`normalized` gives D^-1/2 A D^-1/2, with degrees summed in float64 and
the values rounded once to float32 (`graphs.laplacian`'s arithmetic).

Everything returned is on the host as numpy (int32 rows and columns,
float32 values), sorted by row then column: the program and the plain
reference are both handed these arrays.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

_MASK63 = (1 << 63) - 1
# draw streams of one seed: the graph, the warm-up solve's start block,
# the order of the start-block pool, then one for each start block
# (`solve_stream`)
GRAPH_STREAM, WARMUP_STREAM, ORDER_STREAM = 0, 1, -1
# the seed of the start-block pool: every run solves from the same pool,
# in the order its own seed draws, so that every seed asks the same work
POOL_SEED = 0


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for draw `stream` of run `seed`: a hash of both whole
    numbers, so that any seed, however large, gives its own draws."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(stream)}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & _MASK63


@dataclasses.dataclass
class Graph:
    """COO entries of an n × n matrix on the host."""
    n: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])


def kronecker_edges(scale: int, edge_draws: int, seed: int, device, *,
                    a: float, b: float, c: float,
                    oversample: float = 1.5) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The first `edge_draws` non-loop edges of a Kronecker draw, as int64
    row and column tensors on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = int(edge_draws * oversample) + 16
    rows = torch.zeros(m, dtype=torch.int64, device=device)
    cols = torch.zeros(m, dtype=torch.int64, device=device)
    pa, pb, pc = a, a + b, a + b + c
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        quad_b = (r >= pa) & (r < pb)
        quad_c = (r >= pb) & (r < pc)
        quad_d = r >= pc
        rows = rows * 2 + (quad_c | quad_d)
        cols = cols * 2 + (quad_b | quad_d)
    keep = rows != cols
    rows, cols = rows[keep][:edge_draws], cols[keep][:edge_draws]
    if rows.shape[0] < edge_draws:
        raise ValueError(f"only {rows.shape[0]} non-loop edges of "
                         f"{edge_draws} drawn")
    return rows, cols


def _dedup(rows: torch.Tensor, cols: torch.Tensor, n: int):
    key = torch.unique(rows * n + cols)          # sorted: row, then column
    return key // n, key % n


def largest_component(rows: torch.Tensor, cols: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """A boolean (n,) mask of the vertices in the largest connected
    component of the symmetric graph (rows, cols), the first of the
    largest by its smallest vertex; an isolated vertex is a component."""
    label = torch.arange(n, device=rows.device)
    while True:
        new = label.scatter_reduce(0, rows, label[cols], reduce="amin")
        new = new[new]
        if torch.equal(new, label):
            break
        label = new
    return label == torch.argmax(torch.bincount(label, minlength=n))


def make_graph(spec: dict, seed: int, device) -> Graph:
    """The graph that the configuration's `graph` section describes, drawn
    from `seed` on `device`."""
    scale = int(spec["scale"])
    n = 1 << scale
    draws = int(spec["edge_factor"]) * n
    a, b, c = (float(x) for x in spec["initiator"])
    rows, cols = kronecker_edges(scale, draws,
                                 derive_seed(seed, GRAPH_STREAM), device,
                                 a=a, b=b, c=c)
    if spec["symmetric"]:
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
    rows, cols = _dedup(rows, cols, n)
    component = spec.get("component", "all")
    if component == "largest":
        if not spec["symmetric"]:
            raise ValueError("component 'largest' needs a symmetric graph")
        keep = largest_component(rows, cols, n)[rows]
        rows, cols = rows[keep], cols[keep]
    elif component != "all":
        raise ValueError(f"unknown graph component {component!r}")
    vals = torch.ones(rows.shape[0], dtype=torch.float64, device=device)
    if spec["values"] == "normalized":
        deg = torch.zeros(n, dtype=torch.float64, device=device)
        deg.index_add_(0, rows, vals)
        dinv = torch.where(deg > 0, deg.clamp(min=1e-300).rsqrt(),
                           torch.zeros_like(deg))
        vals = vals * dinv[rows] * dinv[cols]
    elif spec["values"] != "ones":
        raise ValueError(f"unknown graph values {spec['values']!r}")
    out = Graph(n, rows.to(torch.int32).cpu().numpy(),
                cols.to(torch.int32).cpu().numpy(),
                vals.to(torch.float32).cpu().numpy())
    del rows, cols, vals
    return out


def solve_stream(index: int) -> int:
    """The draw stream of the window's solve `index` (0, 1, ...)."""
    return 2 + index


def pool_order(seed: int, pool: int) -> list:
    """The order in which run `seed` takes the `pool` start blocks."""
    gen = torch.Generator().manual_seed(derive_seed(seed, ORDER_STREAM))
    return torch.randperm(pool, generator=gen).tolist()


def window_block(n: int, b: int, seed: int, index: int, pool: int, device
                 ) -> torch.Tensor:
    """The start block of run `seed`'s solve `index`: block
    `pool_order(seed, pool)[index % pool]` of the pool."""
    k = pool_order(seed, pool)[index % pool]
    return start_block(n, b, POOL_SEED, solve_stream(k), device)


def start_block(n: int, b: int, seed: int, stream: int, device
                ) -> torch.Tensor:
    """The (n, b) float32 standard normal start block of draw `stream`."""
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, stream))
    return torch.randn((n, b), generator=gen, dtype=torch.float32,
                       device=device)
