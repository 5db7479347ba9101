"""Carry state across from the JAX package as plain numpy arrays.

`tiled_from_arrays` builds the port's `TiledMatrix` from the fields of a
reference `TiledMatrix` (e.g. `dataclasses.asdict(tm)`),
`store_from_arrays` loads named numpy blocks into a port `TieredStore`,
and `params_from_arrays` turns a reference model's parameters (or a
training state `(params, AdamWState)`) into the port's tensors. With them a test hands both packages the same matrix
image, subspace blocks and weights without this package importing the
reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.tiered import DEVICE, TieredStore
from repro_torch.device import resolve_device
from repro_torch.graphs.tiles import TiledMatrix
from repro_torch.optim.adamw import AdamWState

_ARRAY_FIELDS = {"blocks": np.float32, "block_cols": np.int32,
                 "row_ptr": np.int32, "coo_rows": np.int32,
                 "coo_cols": np.int32, "coo_vals": np.float32}


def tiled_from_arrays(fields: Mapping[str, object]) -> TiledMatrix:
    """A port TiledMatrix from a reference TiledMatrix's fields: `shape`,
    `block_shape` and the numpy arrays, which keep their bytes."""
    arrays = {}
    for name, dtype in _ARRAY_FIELDS.items():
        a = np.asarray(fields[name])
        if a.dtype != dtype:
            raise TypeError(f"{name} is {a.dtype}, expected {np.dtype(dtype)}")
        arrays[name] = np.ascontiguousarray(a)
    return TiledMatrix(shape=tuple(int(s) for s in fields["shape"]),
                       block_shape=tuple(int(s)
                                         for s in fields["block_shape"]),
                       **arrays)


def store_from_arrays(arrays: Mapping[str, np.ndarray], *,
                      store: TieredStore | None = None, device=None,
                      tier: str = DEVICE) -> TieredStore:
    """Put each named array into `store` (a new TieredStore on `device`
    when None) in the given tier, in mapping order; returns the store.
    Host-tier puts are counted as slow-tier writes, as in the reference."""
    store = store if store is not None else TieredStore(device=device)
    for name, a in arrays.items():
        store.put(name, np.ascontiguousarray(a), tier=tier)
    return store


def _tensor(a, device: torch.device) -> torch.Tensor:
    """One leaf, keeping its dtype and bytes. numpy has no bf16: a JAX bf16
    array comes out of `np.asarray` as `ml_dtypes.bfloat16`, which
    `torch.from_numpy` refuses, so its bits go through int16."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:      # JAX hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_arrays(tree, *, device=None):
    """The port's tree from a reference tree whose leaves are arrays
    (numpy, or anything `np.asarray` takes): the same nesting of dicts,
    lists and tuples, each leaf a tensor on `device` (the card when None)
    of the leaf's dtype, bit for bit. A NamedTuple stays one: the
    reference's `AdamWState(step, m, v)` becomes the port's
    `optim.adamw.AdamWState` (recognised by its name and fields, with no
    import of the reference), any other its own type."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(type(node), "_fields"):
            kind = type(node)
            if (kind.__name__ == "AdamWState"
                    and tuple(kind._fields) == AdamWState._fields):
                kind = AdamWState
            return kind(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _tensor(node, dev)

    return walk(tree)
