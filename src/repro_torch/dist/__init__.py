"""Distributed sharded-SpMM eigensolver layer (paper §3: SEM-SpMM) on
`torch.distributed`. Port of `repro.dist`.

layout        — vertex -> (pod, data, model) mesh placement, padding, panels
comm          — the rank mesh, its sub-groups and counted collectives, spawn
dspmm         — packed edge panels, sharded SpMM, fused eigen expansion step
dist_operator — DistOperator: the core restart loop's fused-expand adapter
compress      — int8-scaled cross-pod reductions
"""
from repro_torch.dist.layout import padded_n, vertex_permutation
from repro_torch.dist.comm import Mesh, spawn
from repro_torch.dist.dspmm import (CHUNK, build_dspmm, build_eigen_step,
                                    build_eigen_step_compressed, edge_spec,
                                    pack_compressed_panels, pack_edge_panels,
                                    vector_spec)
from repro_torch.dist.dist_operator import (DistOperator, default_mesh,
                                            e2e_mesh,
                                            pod_compressed_deviation)
from repro_torch.dist.compress import compressed_psum_pod

__all__ = [
    "padded_n", "vertex_permutation",
    "CHUNK", "build_dspmm", "build_eigen_step",
    "build_eigen_step_compressed", "edge_spec", "pack_compressed_panels",
    "pack_edge_panels", "vector_spec",
    "DistOperator", "default_mesh", "e2e_mesh", "pod_compressed_deviation",
    "compressed_psum_pod",
    "Mesh", "spawn",
]
