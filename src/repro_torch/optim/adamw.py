"""AdamW in plain PyTorch (port of `repro.optim.adamw`).

Trees of parameters, gradients and moments are nested dicts and lists of
tensors, as the model keeps them; leaves are visited in JAX's order
(dict keys sorted: `repro_torch.tree`), so a sum over leaves runs in the
reference's order.
`update` and `global_norm_clip` follow the reference's order of
operations in float32: the moments are float32 whatever the parameter
type, and a new parameter is rounded once to its type. They return new
trees (the inputs are not changed): the trainer drops the old ones.

`shard_opt_spec` spreads a moment over a mesh's data axis (ZeRO-1) on
top of its parameter's spec, and `zero1_sharding` is the reference's
conservative default; both work on the spec tuples of
`models.sharding`. Sharded training (`train.sharded`) keeps each
moment as its rank's block by `shard_opt_spec` and runs `update` on the
part of the parameter block that the moment block covers.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

# the tree helpers, re-exported: callers write adamw.tree_map
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: F401


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, the number of updates taken
    m: Any
    v: Any


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


def zero1_sharding(param_spec: tuple, mesh) -> tuple:
    """The reference's default for an optimizer-state tensor: its
    parameter's spec unchanged (the trainer asks `shard_opt_spec` for
    the real spreading)."""
    del mesh
    return tuple(param_spec or ())


def shard_opt_spec(param_spec: tuple, shape, mesh,
                   data_axis: str = "data") -> tuple:
    """ZeRO-1: add the data axis to the first unsharded, divisible dim
    (or stack it onto a model-sharded dim). No-op if the param's spec
    already consumes the data axis (FSDP archs)."""
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))

    def axes_of(s):
        if s is None:
            return ()
        return s if isinstance(s, tuple) else (s,)
    used = {a for s in spec for a in axes_of(s)}
    if data_axis in used:
        return tuple(spec)
    dsize = mesh.shape[data_axis]
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % dsize == 0 and dim >= dsize:
            spec[i] = data_axis
            return tuple(spec)
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is not None and not isinstance(s, tuple):
            total = dsize * mesh.shape[s]
            if dim % total == 0:
                spec[i] = (s, data_axis)
                return tuple(spec)
    return tuple(spec)


def global_norm_clip(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (‖g‖ + 1e-12)) in float32, ‖g‖):
    the norm over every leaf in float32, leaves summed in tree order."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm
