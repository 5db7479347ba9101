"""Graph substrate (numpy): R-MAT generator, normalization, tile packing."""
from repro_torch.graphs.synth import rmat_graph, rmat_spectral, to_dense
from repro_torch.graphs.tiles import (TiledMatrix, pack_tiles,
                                      scsr_decode_tile, scsr_encode_tile)
from repro_torch.graphs.laplacian import normalized_adjacency, laplacian, degrees

__all__ = [
    "rmat_graph", "rmat_spectral", "to_dense", "TiledMatrix", "pack_tiles",
    "scsr_encode_tile", "scsr_decode_tile",
    "normalized_adjacency", "laplacian", "degrees",
]
