"""`optim.adamw`'s tree helpers over trees that hold NamedTuples.

The reference maps its optimizer state with `jax.tree_util.tree_map`,
which rebuilds a NamedTuple field by field; the port's `tree_map` and
`tree_unflatten` must do the same for `AdamWState` and for a
`(params, state)` pair, in the reference's leaf order. Inputs are small
float32 arrays from a numpy generator of a fixed seed; the mapped leaves
are compared exactly (the maps are identities or sums of equal inputs).
"""
import jax
import numpy as np
import torch

from repro.optim import adamw as ref_adamw
from repro_torch.optim import adamw


def _params():
    g = np.random.default_rng(7)
    return {"w": g.standard_normal((3, 2)).astype(np.float32),
            "blocks": [{"b": g.standard_normal(4).astype(np.float32)},
                       {"b": g.standard_normal(4).astype(np.float32)}],
            "scale": (g.standard_normal(2).astype(np.float32),)}


def _torch(tree):
    return adamw.tree_map(torch.from_numpy, tree)


def _same(got, want):
    got, want = adamw.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_tree_map_keeps_the_optimizer_state_a_namedtuple():
    state = adamw.init(_torch(_params()))
    mapped = adamw.tree_map(lambda t: t + 1, state)
    assert type(mapped) is adamw.AdamWState
    assert isinstance(mapped.m["scale"], tuple)
    assert int(mapped.step) == 1
    ref = jax.tree_util.tree_map(lambda t: t + 1,
                                 ref_adamw.init(_params()))
    _same(mapped, ref)


def test_tree_map_over_params_and_state_with_a_second_tree():
    params = _torch(_params())
    tree = (params, adamw.init(params))
    doubled = adamw.tree_map(lambda a, b: a + b, tree, tree)
    assert type(doubled) is tuple and type(doubled[1]) is adamw.AdamWState
    assert type(doubled[0]["blocks"]) is list
    ref_tree = (_params(), ref_adamw.init(_params()))
    _same(doubled, jax.tree_util.tree_map(lambda a, b: a + b, ref_tree,
                                          ref_tree))


def test_tree_unflatten_round_trips_the_state():
    state = adamw.init(_torch(_params()))
    state = adamw.AdamWState(step=state.step,
                             m=adamw.tree_map(torch.ones_like, state.m),
                             v=state.v)
    back = adamw.tree_unflatten(state, adamw.tree_leaves(state))
    assert type(back) is adamw.AdamWState
    assert all(x is y for x, y in zip(adamw.tree_leaves(back),
                                      adamw.tree_leaves(state)))
    # the reference's leaf order: step, then m and v with keys sorted
    ref = ref_adamw.init(_params())
    ref = ref._replace(m=jax.tree_util.tree_map(np.ones_like, ref.m))
    _same(back, ref)


def test_flatten_and_unflatten_leave_no_reference_cycle():
    """`tree.flatten_with_paths` and `tree.unflatten` hold their leaves in
    no reference cycle: a leaf dies with its last reference, without the
    garbage collector (gathered parameters in sharded training are
    freed as soon as their layer drops them)."""
    import gc
    import weakref
    from repro_torch.tree import flatten_with_paths, unflatten
    enabled = gc.isenabled()
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        names, leaves, treedef = flatten_with_paths({"a": t, "b": [None]})
        assert names == ["a"] and leaves[0] is t
        del names, leaves, treedef, t      # (the treedef is the tree)
        assert ref() is None
        t = torch.zeros(3)
        ref = weakref.ref(t)
        out = unflatten({"a": 0, "b": [None, 1]}, [t, t])
        assert out["b"][1] is t
        del out, t
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
