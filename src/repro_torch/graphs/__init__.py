"""Graph substrate (numpy): synthetic generators, normalization, tile
packing, partitioning."""
from repro_torch.graphs.synth import (clustered_web_graph, erdos_renyi,
                                      knn_band_graph, rmat_graph,
                                      rmat_spectral, to_dense)
from repro_torch.graphs.tiles import (TiledMatrix, pack_tiles,
                                      scsr_decode_tile, scsr_encode_tile)
from repro_torch.graphs.partition import (balance_tile_rows, imbalance,
                                          tile_row_costs)
from repro_torch.graphs.laplacian import normalized_adjacency, laplacian, degrees

__all__ = [
    "rmat_graph", "rmat_spectral", "knn_band_graph", "clustered_web_graph",
    "erdos_renyi", "to_dense", "TiledMatrix", "pack_tiles",
    "scsr_encode_tile", "scsr_decode_tile",
    "balance_tile_rows", "imbalance", "tile_row_costs",
    "normalized_adjacency", "laplacian", "degrees",
]
