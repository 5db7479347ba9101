"""Collective wire bytes per device from the collectives a program issued
(the port's counterpart of `repro.utils.hlo_analysis`).

The reference reads its collectives out of compiled HLO text. The port
has no compiler: its sharded programs call `dist.comm`'s collectives,
and a mesh (`comm.Mesh` on ranks, `comm.DryMesh` in a trace) counts each
call by kind and axis set, with the bytes of its whole tensor as one
rank sees it: an all-gather's output, a reduce-scatter's input, an
all-reduce's tensor. This module prices those counts with the same
ring-algorithm table as the reference, g being the group's size:

  all-gather         out·(g−1)/g
  reduce-scatter     in·(g−1)/g  (= out·(g−1))
  all-reduce         2·t·(g−1)/g (reduce-scatter + all-gather)
  all-to-all         in·(g−1)/g
  collective-permute out         (one hop)

A collective over a group of one rank moves nothing and is not counted,
as the reference skips it. The controller's scatter, gather and
broadcast have no entry in the table: they stay in the unpriced bytes.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Tuple

# the port's kind (`comm.Mesh.bytes`) → the reference's HLO op
HLO_KIND = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_reduce": "all-reduce", "all_to_all": "all-to-all",
            "permute": "collective-permute"}


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Per-device wire bytes of a collective of `kind` (the reference's
    op name) whose counted tensor holds `nbytes`, over a group of g."""
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"no ring cost for {kind!r}")


def mesh_calls(mesh) -> list:
    """A mesh's counted collectives, one entry per (kind, axis set):
    (kind, axis, group ranks, number of calls, counted bytes)."""
    return [(kind, axis, list(mesh.group_ranks(axis)), n, nbytes)
            for (kind, axis), (n, nbytes) in sorted(mesh.calls.items())]


def collective_cost(calls: Iterable[Tuple[str, int, int, int]]
                    ) -> Dict[str, float]:
    """Per-device wire bytes by the reference's op kind, its
    `count_<kind>` and "total" (the reference's `collective_bytes` dict),
    from calls given as (port kind, group size, number of calls, counted
    bytes); plus "bytes": the counted bytes by port kind, priced or not,
    to be set beside `comm.Mesh.bytes`."""
    out: Dict[str, float] = defaultdict(float)
    counted: Dict[str, int] = defaultdict(int)
    for kind, g, n, nbytes in calls:
        counted[kind] += nbytes
        hlo = HLO_KIND.get(kind)
        if hlo is None or (g <= 1 and hlo != "collective-permute"):
            continue
        out[hlo] += wire_bytes(hlo, nbytes, g)
        out["count_" + hlo] += n
    out["total"] = sum(v for k, v in out.items()
                       if not k.startswith("count_") and k != "total")
    return {**out, "bytes": dict(counted)}
