"""Production mesh shapes (port of `repro.launch.mesh`).

The reference builds JAX device meshes; the sharding spec engine
(`models.sharding`, `optim.adamw.shard_opt_spec`) reads only a mesh's
axis names and their sizes, so here a mesh is that description,
`MeshShape`, with no devices behind it. `dist.comm.Mesh` is the device
analogue (a (pod, data, model) grid over a `torch.distributed` world);
`rank_grid` gives the grid a `MeshShape` maps to.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and their sizes: `shape` maps each name in
    `axis_names` to its size, as a JAX mesh's `shape` does."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes) < 1:
            raise ValueError(f"mesh {self.sizes} over {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips per pod; multi_pod stacks 2 pods = 512 chips."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_debug_mesh(n_devices: int, *, multi_pod: bool = False) -> MeshShape:
    """The reference's small mesh over n devices: (2, 1, n/2) over
    (pod, data, model) for multi_pod, else (d, n/d) over (data, model)
    with d the largest divisor of n not above √n."""
    n = int(n_devices)
    if multi_pod:
        if n % 2:
            raise ValueError(f"a two-pod mesh needs an even count, got {n}")
        return MeshShape(("pod", "data", "model"), (2, 1, n // 2))
    d = math.isqrt(n)
    while n % d:
        d -= 1
    return MeshShape(("data", "model"), (d, n // d))


def rank_grid(mesh: MeshShape) -> Tuple[int, int, int]:
    """A mesh's (pod, data, model) sizes, a missing axis of size 1: the
    shape of the `dist.comm.Mesh` that runs it on ranks."""
    return tuple(mesh.shape.get(a, 1) for a in ("pod", "data", "model"))


def data_axes(mesh) -> tuple:
    """Axes that shard the batch / vector rows (everything but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)
