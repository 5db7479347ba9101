"""AdamW in plain PyTorch (port of `repro.optim.adamw`).

Trees of parameters, gradients and moments are nested dicts and lists of
tensors, as the model keeps them; leaves are visited in JAX's order
(dict keys sorted), so a sum over leaves runs in the reference's order.
`update` and `global_norm_clip` follow the reference's order of
operations in float32: the moments are float32 whatever the parameter
type, and a new parameter is rounded once to its type. They return new
trees (the inputs are not changed): the trainer drops the old ones.

The reference's `zero1_sharding` and `shard_opt_spec` spread the moments
over a mesh's data axis; they wait for the port of `models/sharding.py`
(ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, the number of updates taken
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in tree_leaves(c)]
    return [tree]


def _is_namedtuple(node) -> bool:
    # the rule of ckpt/checkpoint.py: a NamedTuple takes its fields as
    # arguments, a plain tuple or list one iterable
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (same structure), called in `tree_leaves` order, rebuilt in `tree`'s
    structure (dicts keep their key order; a NamedTuple such as
    `AdamWState` stays one)."""
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, c, *(r[i] for r in rest))
                    for i, c in enumerate(tree)]
        return (type(tree)(*children) if _is_namedtuple(tree)
                else type(tree)(children))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """`like`'s structure holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def init(params) -> AdamWState:
    """Step 0 and float32 zeros for m and v, on each parameter's device."""
    first = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def update(state: AdamWState, grads, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step with bias correction and decoupled weight decay:
    (new params, new AdamWState). lr is a float or a 0-d tensor."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / c1
        vh = v2 / c2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p - lr * delta).to(p.dtype), m2, v2

    outs = [upd(*leaf) for leaf in zip(
        *(tree_leaves(t) for t in (grads, state.m, state.v, params)))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in outs])
                           for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


def global_norm_clip(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (‖g‖ + 1e-12)) in float32, ‖g‖):
    the norm over every leaf in float32, leaves summed in tree order."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm
