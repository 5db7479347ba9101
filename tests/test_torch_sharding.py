"""The sharding spec engine (`models.sharding`, `optim.adamw`'s ZeRO-1
specs, `launch.mesh`) against the reference's, for all ten architectures
at their published sizes on both production mesh shapes.

Shapes only: the reference's trees come from `jax.eval_shape` (no array
is made), the port's from `init_model(..., device="meta")` and
`init_cache(..., device="meta")`. Both engines get the same mesh
description (`launch.mesh.MeshShape`: the reference reads only a mesh's
`axis_names` and `shape`). Each leaf's path, shape and spec must be
equal, the reference's PartitionSpec taken as a tuple. Batch and cache
specs run at the reference's dry-run shapes (`repro.configs.SHAPES`).
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.models import sharding as ref_shd
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro_torch import configs, tree
from repro_torch.launch import mesh
from repro_torch.models import sharding as shd
from repro_torch.models import steps
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

ARCHS = list(ref_configs.ARCHS)
MESHES = {"16x16": mesh.make_production_mesh(),
          "2x16x16": mesh.make_production_mesh(multi_pod=True)}
SHAPES = ref_configs.SHAPES
DECODE = [s for s in SHAPES.values() if s.kind == "decode"]


def _ref_leaves(tree) -> list:
    """(path, shape) of a reference tree in JAX's order, the path as
    `repro.models.sharding` writes it."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(leaf.shape))
            for path, leaf in flat]


def _ref_specs(tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_leaves(params) -> list:
    names, leaves, _ = tree.flatten_with_paths(params)
    return [(path, tuple(leaf.shape)) for path, leaf in zip(names, leaves)]


def _port_specs(specs, like) -> list:
    """The spec tuples of a spec tree, in the order of `like`'s leaves
    (a spec is a tuple, so the walk follows `like`'s structure)."""
    if isinstance(like, dict):
        assert sorted(specs) == sorted(like)
        return [s for k in sorted(like) for s in _port_specs(specs[k],
                                                             like[k])]
    if isinstance(like, (list, tuple)):
        assert type(specs) is type(like) and len(specs) == len(like)
        return [s for a, b in zip(specs, like) for s in _port_specs(a, b)]
    assert isinstance(specs, tuple)
    return [specs]


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return jax.eval_shape(functools.partial(
        ref_tf.init_model, jax.random.PRNGKey(0), ref_configs.get(name)))


@functools.lru_cache(maxsize=None)
def _ref_cache(name, batch, seq):
    return jax.eval_shape(functools.partial(
        ref_tf.init_cache, ref_configs.get(name), batch, seq))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_optimizer_specs_match_reference(name, mesh_name):
    """param_specs leaf for leaf, then shard_opt_spec (ZeRO-1) of every
    leaf on its parameter's spec, as the reference's dry run builds the
    moments' placements."""
    m = MESHES[mesh_name]
    cfg = configs.get(name)
    ref_params = _ref_params(name)
    params = tf.init_model(0, cfg, device="meta")
    leaves = _port_leaves(params)
    assert leaves == _ref_leaves(ref_params)
    want = _ref_specs(ref_shd.param_specs(ref_params, ref_configs.get(name),
                                          m))
    got = _port_specs(shd.param_specs(params, cfg, m), params)
    assert got == want
    assert any(any(s is not None for s in spec) for spec in got)
    want_opt = [tuple(ref_adamw.shard_opt_spec(P(*s), shape, m))
                for s, (_, shape) in zip(want, leaves)]
    got_opt = [adamw.shard_opt_spec(s, shape, m)
               for s, (_, shape) in zip(got, leaves)]
    assert got_opt == want_opt
    assert [adamw.zero1_sharding(s, m) for s in got] == got


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_batch_specs_match_reference(name, mesh_name):
    """At every dry-run shape's global batch: rows over the row axes when
    they divide it, else replicated."""
    m = MESHES[mesh_name]
    cfg = configs.get(name)
    for shape in SHAPES.values():
        ref_batch = ref_steps.make_batch_specs(ref_configs.get(name),
                                               shape.global_batch, 8)
        batch = steps.make_batch_specs(cfg, shape.global_batch, 8)
        assert _port_leaves(batch) == _ref_leaves(ref_batch)
        want = _ref_specs(ref_shd.batch_specs(ref_batch, m,
                                              shape.global_batch))
        assert _port_specs(shd.batch_specs(batch, m, shape.global_batch),
                           batch) == want


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_match_reference(name, mesh_name, shard_seq):
    """Decode caches at the dry run's decode shapes (batch 128 at 32,768
    tokens, batch 1 at 524,288), with and without the sequence split."""
    m = MESHES[mesh_name]
    cfg = configs.get(name)
    for shape in DECODE:
        ref_cache = _ref_cache(name, shape.global_batch, shape.seq_len)
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device="meta")
        assert _port_leaves(cache) == _ref_leaves(ref_cache)
        want = _ref_specs(ref_shd.cache_specs(
            ref_cache, ref_configs.get(name), m, shape.global_batch,
            shard_seq=shard_seq))
        got = _port_specs(shd.cache_specs(cache, cfg, m, shape.global_batch,
                                          shard_seq=shard_seq), cache)
        assert got == want


def test_meta_init_materializes_nothing():
    """The full-size trees the spec tests build hold no storage."""
    params = tf.init_model(0, configs.get("arctic-480b"), device="meta")
    leaves = adamw.tree_leaves(params)
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) > 4e11


def test_mesh_shapes():
    """The production meshes and the debug mesh's factorization (the
    reference's rule: the largest divisor of n not above √n rows)."""
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].shape == {"pod": 2, "data": 16, "model": 16}
    got = {n: mesh.make_debug_mesh(n).sizes for n in (1, 2, 6, 8, 12, 16)}
    assert got == {1: (1, 1), 2: (1, 2), 6: (2, 3), 8: (2, 4), 12: (3, 4),
                   16: (4, 4)}
    two = mesh.make_debug_mesh(8, multi_pod=True)
    assert (two.axis_names, two.sizes) == (("pod", "data", "model"),
                                           (2, 1, 4))
    with pytest.raises(ValueError):
        mesh.make_debug_mesh(3, multi_pod=True)
    for m in (*MESHES.values(), two):
        assert mesh.data_axes(m) == ref_mesh.data_axes(m)
        assert mesh.all_axes(m) == ref_mesh.all_axes(m)


def test_to_named_waits_for_sharded_training():
    """`to_named` places each spec on a device mesh: one `Placement` per
    leaf, holding the spec; on a (1, 1, 1) mesh every block is the whole
    leaf, and `shard`/`unshard` give it back bit for bit."""
    from repro_torch.dist import comm
    m = comm.Mesh((1, 1, 1), device="cpu")
    cfg = configs.reduced("qwen2-1.5b")
    params = tf.init_model(0, cfg, device="cpu")
    specs = shd.param_specs(params, cfg, m)
    named = shd.to_named(specs, m)
    got, want = [], []
    shd._map_specs(got.append, named)
    shd._map_specs(want.append, specs)
    assert [p.spec for p in got] == want and all(p.mesh is m for p in got)
    for leaf, p in zip(adamw.tree_leaves(params), got):
        assert p.block_shape(leaf.shape) == tuple(leaf.shape)
        assert torch.equal(shd.unshard(shd.shard(leaf, p), p), leaf)


def test_specs_read_a_device_mesh_too():
    """`dist.comm.Mesh` (one rank, no world) has the axis names and sizes
    the engine reads: a (1, 1, 1) grid replicates everything that a
    size-1 axis cannot split."""
    from repro_torch.dist import comm
    m = comm.Mesh((1, 1, 1), device="cpu")
    cfg = configs.reduced("qwen2-1.5b")
    params = tf.init_model(0, cfg, device="meta")
    got = _port_specs(shd.param_specs(params, cfg, m), params)
    want = _ref_specs(ref_shd.param_specs(
        jax.eval_shape(functools.partial(
            ref_tf.init_model, jax.random.PRNGKey(0),
            ref_configs.reduced("qwen2-1.5b"))),
        ref_configs.reduced("qwen2-1.5b"), m))
    assert got == want
    assert torch.device("meta") == adamw.tree_leaves(params)[0].device
