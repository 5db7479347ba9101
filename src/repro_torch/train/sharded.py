"""Sharded training on `torch.distributed`: the reference's
`train(mesh=...)` (`repro.train.trainer`), where sharding changes where
the state lives and never what is computed.

On a `dist.comm.Mesh` of (pod, data, model) ranks:

  * parameters: each rank keeps its block of every leaf by
    `models.sharding.param_specs` ('model' on width dims, and 'data' on
    the embed dim with cfg.use_fsdp);
  * batch: every rank draws the same global batch (a pure function of
    (seed, step)) and keeps the rows `batch_specs` give its (pod, data)
    coordinate; the 'model' ranks of a row group see the same rows. When
    the batch does not divide, every rank keeps all of it;
  * gather on use: each super-layer's blocks are all-gathered just
    before the layer runs, inside the remat region (a recompute gathers
    again), and every other leaf once per forward
    (`transformer.forward`'s `gather` hook). The gather's backward keeps
    this rank's block of the full gradient and sums it over the ranks
    that saw other rows (all-reduce over the row group, or reduce-scatter
    over 'data' where the leaf is data-sharded, then all-reduce over
    'pod'), in float32; there is no sum over 'model', whose ranks
    computed the same rows;
  * loss: each row group's mean, summed over the row groups and scaled
    by 1/R (R row groups), after the microbatches' own 1/n: the
    reference's global mean;
  * clip: the norm of the full gradient, from each block's sum of
    squares counted once (only the first replica of a block adds it:
    `Placement.replica`), summed leaf by leaf in tree order;
  * moments (ZeRO-1): m and v take `adamw.shard_opt_spec(param_spec)`.
    Each rank runs `adamw.update` on the part of its parameter block
    that its moment block covers, then all-gathers the updated part over
    'data' where the moment spec added it. The step counter and lr are
    replicated.

Every collective goes through the mesh and is counted in `mesh.bytes`;
`Sharding.analytic_bytes` is the design's count for one step. On a
(1, 1, 1) mesh every collective is over one rank, and the step is the
unsharded one operation for operation.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch.ckpt.checkpoint import restore as _restore
from repro_torch.launch.mesh import data_axes
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_paths, unflatten

_F32 = 4


class _Gather(torch.autograd.Function):
    """A parameter block in, the full parameter out (`unshard`); the
    gradient comes back as this rank's block summed over the row
    groups (`Sharding._reduce_grad`)."""

    @staticmethod
    def forward(ctx, block, placement, reduce):
        ctx.placement, ctx.reduce = placement, reduce
        return shd.unshard(block, placement)

    @staticmethod
    def backward(ctx, grad):
        return ctx.reduce(grad, ctx.placement), None, None


def _data_dim(spec) -> int | None:
    """The dim a parameter shards over 'data' (the embed dim under FSDP;
    a parameter's spec names one axis a dim)."""
    for dim, entry in enumerate(spec):
        if entry == "data":
            return dim
    return None


def global_norm_clip(grads, placements: list, mesh, max_norm: float):
    """`adamw.global_norm_clip` over the full gradient from its blocks
    (`placements` in leaf order): each leaf's sum of squares is its
    blocks' sums, each block counted once (by its first replica), and
    the leaves are summed in tree order."""
    leaves = adamw.tree_leaves(grads)
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    sums = mesh.all_reduce(torch.stack([
        torch.sum(g.float() ** 2) if p.replica() else zero
        for g, p in zip(leaves, placements)]), axis="all")
    norm = torch.sqrt(sum(sums.unbind(0)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return adamw.tree_map(lambda g: g.float() * scale, grads), norm


class Sharding:
    """The placements of one model's training state on `mesh` and the
    collectives of its step."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh
        meta = tf.init_model(0, cfg, device="meta")
        self.names, leaves, self.treedef = flatten_with_paths(meta)
        self.shapes = [tuple(t.shape) for t in leaves]
        self.dtypes = [t.dtype for t in leaves]
        specs: List[tuple] = []
        shd._map_specs(specs.append, shd.param_specs(meta, cfg, mesh))
        self.params = [shd.Placement(s, mesh) for s in specs]
        self.moments = [shd.Placement(adamw.shard_opt_spec(s, shape, mesh),
                                      mesh)
                        for s, shape in zip(specs, self.shapes)]
        self._by_path = dict(zip(self.names, self.params))
        # a stacked leaf's slice: its spec without the stacking dim (the
        # rules give roles to the trailing dims only)
        self._slice = {n: shd.Placement(p.spec[1:], mesh)
                       for n, p in self._by_path.items()
                       if n.startswith("stack/")}
        self.row_groups = math.prod(mesh.shape[a] for a in data_axes(mesh))
        # where each moment block sits in its parameter block, and the dim
        # to which `shard_opt_spec` added 'data' (None: the moment block is
        # the parameter block)
        self._within, self._zero_dim = [], []
        for p, o, shape in zip(self.params, self.moments, self.shapes):
            sl, zero = [], None
            for dim, n in enumerate(shape):
                (pi, pc), (oi, oc) = p.part(dim), o.part(dim)
                start = oi * (n // oc) - pi * (n // pc)
                sl.append(slice(start, start + n // oc))
                if o.spec[dim] != p.spec[dim]:
                    zero = dim
            self._within.append(tuple(sl))
            self._zero_dim.append(zero)

    # ------------------------------------------------------------ state
    def tree(self, leaves: list) -> Any:
        """A list of leaves in the parameters' order, as their tree."""
        return unflatten(self.treedef, leaves)

    def shard_params(self, full) -> Any:
        """This rank's blocks of a full parameter tree."""
        return self.tree([shd.shard(t, p) for t, p in zip(
            flatten_with_paths(full)[1], self.params)])

    def init_all(self, seed: int):
        """(parameter blocks, AdamWState of moment blocks): the full model
        drawn from `seed` on every rank (the unsharded init, bit for bit),
        each rank keeping its blocks; zero float32 moments."""
        dev = self.mesh.device
        params = self.shard_params(tf.init_model(seed, self.cfg, device=dev))
        zeros = lambda: self.tree([
            torch.zeros(o.block_shape(s), dtype=torch.float32, device=dev)
            for o, s in zip(self.moments, self.shapes)])
        return params, adamw.AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=zeros(), v=zeros())

    def placements(self):
        """`restore(shardings=)`'s tree for (params, AdamWState)."""
        return (self.tree(self.params), adamw.AdamWState(
            step=shd.Placement((), self.mesh), m=self.tree(self.moments),
            v=self.tree(self.moments)))

    def full_state(self, params, opt) -> tuple | None:
        """The full (params, AdamWState) as host tensors on rank 0 (None
        on the others), gathered leaf by leaf: every rank takes part."""
        def host(blocks, places):
            out = []
            for b, p in zip(flatten_with_paths(blocks)[1], places):
                full = shd.unshard(b, p)
                out.append(full.cpu() if self.mesh.rank == 0 else None)
                del full
            return self.tree(out) if self.mesh.rank == 0 else None
        p = host(params, self.params)
        m, v = host(opt.m, self.moments), host(opt.v, self.moments)
        if self.mesh.rank:
            return None
        return p, adamw.AdamWState(step=opt.step.cpu(), m=m, v=v)

    def held_bytes(self) -> Dict[str, int]:
        """The bytes of parameter and moment blocks each rank holds, by
        the specs."""
        par = sum(math.prod(p.block_shape(s)) * d.itemsize
                  for p, s, d in zip(self.params, self.shapes, self.dtypes))
        mom = sum(2 * _F32 * math.prod(o.block_shape(s))
                  for o, s in zip(self.moments, self.shapes))
        return {"params": par, "moments": mom}

    # ------------------------------------------------------------ step
    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (all of it when the batch
        does not split over the row groups)."""
        rows = next(iter(batch.values())).shape[0]
        specs = shd.batch_specs(batch, self.mesh, rows)
        return {k: v[shd.Placement(specs[k], self.mesh).slices(v.shape)]
                for k, v in batch.items()}

    def gather(self, prefix: str, tree):
        """`transformer.forward`'s hook: the full parameters of a subtree
        of blocks ("stack": one super-layer's slices; "": the leaves
        outside the stack)."""
        names, leaves, treedef = flatten_with_paths(tree)
        full = [_Gather.apply(
            leaf, self._slice[f"stack/{n}"] if prefix == "stack"
            else self._by_path[n], self._reduce_grad)
            for n, leaf in zip(names, leaves)]
        return unflatten(treedef, full)

    def _reduce_grad(self, grad: torch.Tensor, placement) -> torch.Tensor:
        """This rank's block of the full gradient, summed in float32 over
        the ranks that saw other rows, in the block's type."""
        mesh, dtype = self.mesh, grad.dtype
        zero = _data_dim(placement.spec)
        sl = list(placement.slices(grad.shape))
        if zero is not None:
            sl[zero] = slice(None)
        g = grad[tuple(sl)].float()
        if zero is None:
            g = mesh.all_reduce(g, axis="rows")
        else:
            g = mesh.all_reduce(mesh.reduce_scatter(g, axis="data",
                                                    dim=zero), axis="pod")
        return g.to(dtype)

    def mean_over_rows(self, loss, grads):
        """The row groups' losses summed, then loss and gradients scaled
        by 1/R: each row group's mean becomes the global batch's."""
        loss = self.mesh.all_reduce(loss, axis="rows")
        if self.row_groups == 1:
            return loss, grads
        s = 1.0 / self.row_groups
        return loss * s, adamw.tree_map(lambda g: g * s, grads)

    def clip(self, grads, max_norm: float):
        return global_norm_clip(grads, self.params, self.mesh, max_norm)

    def update(self, state, grads, params, *, lr):
        """`adamw.update` on the part of each parameter block that its
        moment block covers; the updated parts gathered over 'data'."""
        g, p = adamw.tree_leaves(grads), adamw.tree_leaves(params)
        new_p, st = adamw.update(
            adamw.AdamWState(step=state.step,
                             m=adamw.tree_leaves(state.m),
                             v=adamw.tree_leaves(state.v)),
            [x[w] for x, w in zip(g, self._within)],
            [x[w] for x, w in zip(p, self._within)], lr=lr)
        new_p = [x if d is None else self.mesh.all_gather(x, axis="data",
                                                          dim=d).contiguous()
                 for x, d in zip(new_p, self._zero_dim)]
        return self.tree(new_p), adamw.AdamWState(
            step=st.step, m=self.tree(st.m), v=self.tree(st.v))

    # ------------------------------------------------------------ counts
    def analytic_bytes(self, num_microbatches: int = 1) -> Dict[str, int]:
        """The design's collective bytes of one step on this rank, by kind
        (`mesh.bytes`' convention: an all-gather's output, a
        reduce-scatter's input, an all-reduce's tensor)."""
        out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
        regather = 1 + bool(self.cfg.remat)
        for n, p, s, d, zero in zip(self.names, self.params,
                                    self.shapes, self.dtypes,
                                    self._zero_dim):
            size = d.itemsize
            block = p.block_shape(s)
            if n.startswith("stack/"):
                per = self.cfg.n_super * regather * sum(
                    math.prod(sh) for _, _, sh in
                    self._slice[n].gather_plan(block[1:]))
            else:
                per = sum(math.prod(sh) for _, _, sh in p.gather_plan(block))
            out["all_gather"] += num_microbatches * per * size
            data = _data_dim(p.spec)
            if data is None:
                out["all_reduce"] += num_microbatches * _F32 * math.prod(
                    block)
            else:
                pre = list(block)
                pre[data] = s[data]
                out["reduce_scatter"] += num_microbatches * _F32 * \
                    math.prod(pre)
                out["all_reduce"] += num_microbatches * _F32 * math.prod(
                    block)
            if zero is not None:
                out["all_gather"] += size * math.prod(block)
        out["all_reduce"] += _F32 * (1 + len(self.names))   # loss, norms
        return out


# ------------------------------------------------------------ rank programs
def restore_state(mesh, cfg, root: str, step: int):
    """Checkpoint `step` of a training run (any mesh's, or unsharded)
    restored onto `mesh`: this rank's (parameter blocks, AdamWState of
    moment blocks), each block read alone."""
    shards = Sharding(cfg, mesh)
    like = shards.tree([torch.empty(0, device=mesh.device)] * len(
        shards.names))
    state, _ = _restore(root, step, (like, adamw.AdamWState(
        step=torch.empty(0, device=mesh.device), m=like, v=like)),
        shardings=shards.placements())
    return state


def clip_full(mesh, grads, specs, max_norm: float):
    """`global_norm_clip` of a full gradient tree (every rank holds it),
    each leaf cut by its spec on `mesh`: (norm, this rank's clipped
    blocks)."""
    places = []
    shd._map_specs(places.append, shd.to_named(specs, mesh))
    leaves = adamw.tree_leaves(grads)
    blocks = [shd.shard(torch.as_tensor(g), p) for g, p in zip(leaves,
                                                               places)]
    clipped, norm = global_norm_clip(blocks, places, mesh, max_norm)
    return norm, clipped


def serve_rows(mesh, cfg, seed: int, tokens, decode_steps: int = 2) -> dict:
    """The sharded prefill and decode steps (`build_prefill_step` and
    `build_decode_step` with a `Sharding`) beside the unsharded ones, on
    this rank's rows of the global batch `tokens` (B, S): the model drawn
    from `seed`, prefill logits of every row, then `decode_steps` decode
    steps fed the rows' first tokens, against an empty cache of
    S + decode_steps positions. Sharding gathers the parameters on use, so each pair
    should be the same bits."""
    from repro_torch.models import steps as S
    dev = mesh.device
    shards = Sharding(cfg, mesh)
    full = tf.init_model(seed, cfg, device=dev)
    blocks = shards.shard_params(full)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    local = shards.local_batch(batch)
    rows, seq = local["tokens"].shape
    out: Dict[str, Any] = {}
    with torch.no_grad():
        out["prefill"] = (S.build_prefill_step(cfg, sharding=shards)(
            blocks, batch), S.build_prefill_step(cfg)(full, local))
        steps = (S.build_decode_step(cfg, sharding=shards),
                 S.build_decode_step(cfg))
        states = (blocks, full)
        caches = [tf.init_cache(cfg, rows, seq + decode_steps, device=dev)
                  for _ in steps]
        out["decode"] = ([], [])
        for pos in range(decode_steps):
            tok = local["tokens"][:, pos:pos + 1]
            for i, step in enumerate(steps):
                logits, caches[i] = step(states[i], caches[i], tok, pos)
                out["decode"][i].append(logits)
    out["cache"] = tuple(adamw.tree_leaves(c) for c in caches)
    return out
