"""The paper's own configs: graph eigenproblems (Table 2 + parameters §4.3).

Each GraphConfig is one dry-run cell for the eigensolver `eigen_step`
(distributed SpMM + CGS2 + CholQR fused, see dist/dspmm.py).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    name: str
    n_vertices: int
    n_edges: int
    block_size: int      # b — paper §4.3 choices
    num_blocks: int      # NB; subspace m = b · NB
    nev: int
    directed: bool = False

    @property
    def subspace(self) -> int:
        return self.block_size * self.num_blocks


GRAPHS = {
    # Table 2 datasets with the paper's §4.3 parameter choices
    "twitter": GraphConfig("twitter", 42_000_000, 1_500_000_000,
                           block_size=4, num_blocks=8, nev=8),
    "friendster": GraphConfig("friendster", 65_000_000, 1_700_000_000,
                              block_size=4, num_blocks=8, nev=8),
    "knn": GraphConfig("knn", 62_000_000, 12_000_000_000,
                       block_size=4, num_blocks=32, nev=8),
    # the billion-node result (Table 3): b=2, NB=2·ev, SVD on directed graph
    "page": GraphConfig("page", 3_400_000_000, 129_000_000_000,
                        block_size=2, num_blocks=16, nev=8, directed=True),
}
