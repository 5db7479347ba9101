"""Carry state across from the JAX package as plain numpy arrays.

`tiled_from_arrays` builds the port's `TiledMatrix` from the fields of a
reference `TiledMatrix` (e.g. `dataclasses.asdict(tm)`), and
`store_from_arrays` loads named numpy blocks into a port `TieredStore`.
With them a test hands both packages the same matrix image and the same
subspace blocks without this package importing the reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core.tiered import DEVICE, TieredStore
from repro_torch.graphs.tiles import TiledMatrix

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
