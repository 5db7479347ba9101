"""Logical-axis sharding rule engine with divisibility fallback (port of
`repro.models.sharding`).

Maps parameter, batch and cache dimensions onto the production mesh
(('pod',) 'data', 'model'):

  * batch-like dims shard over every non-'model' axis;
  * width-like dims (q/kv projections, ffn, experts, vocab) shard over
    'model' **iff divisible**, otherwise replicate (e.g. qwen2's 12 heads
    on a 16-way axis: the flat 1536 q-dim shards; kv 256-dim replicates);
  * with cfg.use_fsdp, the d_model ("embed") dim of big-arch params also
    shards over 'data' (FSDP);
  * optimizer moments get ZeRO-1 spreading (optim.adamw.shard_opt_spec).

A spec is a tuple with one entry per dim, in the reference's
PartitionSpec terms (as `dist.dspmm.edge_spec` has them): None
(replicated), an axis name, or a tuple of axis names; a tuple of one name
is that name, as a PartitionSpec normalizes it. The engine reads only a
mesh's `axis_names` and its `shape` mapping (`launch.mesh.MeshShape`, or
`dist.comm.Mesh`) and the leaves' shapes, so meta tensors do: no weight
is materialized.

Applying the specs to tensors takes a `dist.comm.Mesh` (a world of
ranks): `to_named` turns each spec into a `Placement`, the port's
`NamedSharding`. A dim whose spec names axes is cut into equal blocks in
the spec's axis order (a rank's index on ('pod', 'data') is
pod·D + data); `shard` keeps this rank's block of a full tensor (no
communication) and `unshard` all-gathers the blocks back, one axis at a
time, innermost first. Sharded training (`train.sharded`) is built on
them.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Iterator

import torch

from repro_torch.launch.mesh import data_axes
from repro_torch.tree import flatten_with_paths, unflatten


def _spec(dims) -> tuple:
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                 for d in dims)


def _div(size: int, mesh, axes) -> bool:
    if axes is None:
        return True
    ax = axes if isinstance(axes, tuple) else (axes,)
    total = math.prod(mesh.shape[a] for a in ax)
    return size % total == 0 and size >= total


def _maybe(size: int, mesh, axes):
    return axes if _div(size, mesh, axes) else None


# (path regex, [logical dim roles]) — roles consumed right-to-left so stacked
# leading layer dims fall through to None.
_PARAM_RULES: list[tuple[str, list]] = [
    (r"embed/tok$",               ["vocab", "embed"]),
    (r"embed/in_proj/w$",         ["embed", "model_out"]),
    (r"lm_head/w$",               ["embed", "vocab"]),
    (r"attn/wq/w$",               ["embed", "model_out"]),
    (r"attn/w[kv]/w$",            ["embed", "model_out"]),
    (r"attn/wo/w$",               ["model_out", "embed"]),
    (r"attn/w[qkv]/b$",           ["model_out"]),
    (r"ffn/(up|gate)/w$",         ["embed", "model_out"]),
    (r"ffn/down/w$",              ["model_out", "embed"]),
    (r"ffn/router/w$",            ["embed", None]),
    (r"ffn/(up|gate)$",           ["experts", "embed", "model_out"]),
    (r"ffn/down$",                ["experts", "model_out", "embed"]),
    (r"ffn/dense/(up|gate)/w$",   ["embed", "model_out"]),
    (r"ffn/dense/down/w$",        ["model_out", "embed"]),
    (r"ssm/in_proj/w$",           ["embed", None]),
    (r"ssm/out_proj/w$",          ["model_out", "embed"]),
    (r"rec/(in_x|in_gate|w_a|w_i)/w$", ["embed", "model_out"]),
    (r"rec/out/w$",               ["model_out", "embed"]),
]


def _role_axis(role, size: int, cfg, mesh):
    if role in ("vocab", "model_out", "experts"):
        return _maybe(size, mesh, "model")
    if role == "embed" and cfg.use_fsdp:
        return _maybe(size, mesh, "data")
    return None


def param_specs(params: Any, cfg, mesh) -> Any:
    """Tree of specs mirroring params."""
    names, leaves, _ = flatten_with_paths(params)
    specs = []
    for pstr, leaf in zip(names, leaves):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        used: set = set()
        for pat, roles in _PARAM_RULES:
            if re.search(pat, pstr):
                # align roles to trailing dims (leading dims = layer stacking)
                for i, role in enumerate(roles):
                    dim = len(shape) - len(roles) + i
                    if dim < 0:
                        continue
                    ax = _role_axis(role, shape[dim], cfg, mesh)
                    # each mesh axis may appear once per spec: first role
                    # wins (e.g. arctic: experts take 'model' → EP, the
                    # within-expert ffn dim replicates; grok: 8 experts
                    # don't divide 16 → ffn dim takes 'model' → TP)
                    if ax is not None and ax in used:
                        ax = None
                    if ax is not None:
                        used.add(ax)
                    spec[dim] = ax
                break
        specs.append(_spec(spec))
    return unflatten(params, specs)


def batch_specs(batch: Any, mesh, global_batch: int) -> Any:
    """Every batch leaf: dim 0 over the row axes when they divide
    global_batch, the rest replicated."""
    rows = data_axes(mesh)
    nrows = math.prod(mesh.shape[a] for a in rows)
    ax = rows if global_batch % nrows == 0 else None
    return unflatten(batch, [
        _spec((ax,) + (None,) * (len(leaf.shape) - 1))
        for leaf in flatten_with_paths(batch)[1]])


def cache_specs(cache: Any, cfg, mesh, batch: int,
                *, shard_seq: bool = False) -> Any:
    """Decode caches: batch over row axes; kv-head/state dims over 'model'
    when divisible. Stacked leading layer dim stays unsharded.

    shard_seq=True: when the kv-head dim doesn't divide the model axis
    (every GQA arch with kv<16), shard the cache *sequence* dim over
    'model' instead of replicating — attention over a seq-sharded ring
    buffer is a partial-softmax reduction, tiny vs gathering the cache."""
    del cfg
    rows = data_axes(mesh)
    nrows = math.prod(mesh.shape[a] for a in rows)
    batch_ax = rows if batch % nrows == 0 else None
    names, leaves, _ = flatten_with_paths(cache)
    specs = []
    for pstr, leaf in zip(names, leaves):
        shape = tuple(leaf.shape)
        off = 1 if "stack" in pstr else 0
        spec = [None] * len(shape)
        name = pstr.rsplit("/", 1)[-1]
        if name in ("k", "v", "ck", "cv"):        # (B, S, K, hd)
            if len(shape) - off == 4:
                spec[off] = batch_ax
                spec[off + 2] = _maybe(shape[off + 2], mesh, "model")
                if spec[off + 2] is None and shard_seq:
                    spec[off + 1] = _maybe(shape[off + 1], mesh, "model")
        elif name == "state":                      # ssm (B, H, P, N)
            spec[off] = batch_ax
            spec[off + 1] = _maybe(shape[off + 1], mesh, "model")
        elif name == "conv":                       # (B, K-1, C)
            spec[off] = batch_ax
            spec[off + 2] = _maybe(shape[off + 2], mesh, "model")
        elif name == "h":                          # rglru (B, RW)
            spec[off] = batch_ax
            spec[off + 1] = _maybe(shape[off + 1], mesh, "model")
        elif name == "pos":
            if shard_seq:
                spec[off] = _maybe(shape[off], mesh, "model")
        specs.append(_spec(spec))
    return unflatten(cache, specs)


def _axes(entry) -> tuple:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """Where a tensor lives on a `dist.comm.Mesh`: `spec` (one entry per
    dim, as the engine writes it) read at this rank's coordinates. The
    port's `NamedSharding`; `restore(shardings=)` takes it."""
    spec: tuple
    mesh: Any

    def part(self, dim: int) -> tuple[int, int]:
        """(this rank's block index, the number of blocks) along `dim`."""
        index, count = 0, 1
        entry = self.spec[dim] if dim < len(self.spec) else None
        for a in _axes(entry):
            size = self.mesh.shape[a]
            index, count = index * size + self.mesh.coords[a], count * size
        return index, count

    def slices(self, shape) -> tuple:
        """This rank's block of a full tensor of `shape`, as slices."""
        out = []
        for dim, n in enumerate(shape):
            index, count = self.part(dim)
            if n % count:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split into {count} blocks ({self.spec})")
            out.append(slice(index * (n // count), (index + 1) * (n // count)))
        return tuple(out)

    def block_shape(self, shape) -> tuple:
        return tuple(s.stop - s.start for s in self.slices(shape))

    def replica(self) -> bool:
        """Whether this rank holds the first copy of its block: index 0
        on every axis the spec leaves out (a block held on several ranks
        counts once in a sum over ranks)."""
        used = {a for e in self.spec for a in _axes(e)}
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names
                   if a not in used)

    def gather_plan(self, block_shape) -> Iterator[tuple]:
        """(dim, axis, gathered shape) of each all-gather `unshard` makes,
        in order: each dim, its axes innermost first."""
        shape = list(block_shape)
        for dim, entry in enumerate(self.spec):
            for a in reversed(_axes(entry)):
                shape[dim] *= self.mesh.shape[a]
                yield dim, a, tuple(shape)


def _map_specs(fn, tree):
    """fn over the spec tuples of a tree of specs (dicts, lists and
    NamedTuples of spec tuples), in the tree's leaf order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    return fn(tree)


def to_named(tree_specs: Any, mesh) -> Any:
    """Each spec of the tree as a `Placement` on `mesh`, a
    `dist.comm.Mesh` (the reference's `NamedSharding(mesh, P(*spec))`)."""
    return _map_specs(lambda spec: Placement(tuple(spec), mesh), tree_specs)


def shard(full: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's block of `full`, a tensor of its own (no communication:
    every rank holds `full`)."""
    return full[placement.slices(full.shape)].clone(
        memory_format=torch.contiguous_format)


def unshard(block: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The full tensor from every rank's block: an all-gather along each
    sharded dim over each of its axes (counted in `mesh.bytes`)."""
    for dim, axis, _ in placement.gather_plan(block.shape):
        block = placement.mesh.all_gather(block, axis=axis, dim=dim)
    return block.contiguous()
