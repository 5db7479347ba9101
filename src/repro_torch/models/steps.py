"""train_step / prefill_step / decode_step builders (port of
`repro.models.steps`).

Each builder returns a plain function of explicit state. The train step
takes gradients with `torch.autograd.grad` through detached aliases of
the parameters (no copy; the caller's tensors are not touched) and, over
several microbatches, sums them in float32 in microbatch order and
scales by 1/num_microbatches, as the reference's `lax.scan` does. Given
a `train.sharded.Sharding`, the same step runs on parameter and moment
blocks: it keeps this rank's rows of the batch, gathers the parameters
on use, and takes the loss, the clip and the update from the sharding.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.modules import dtype_of
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine


def make_batch_specs(cfg: ArchConfig, batch: int, seq: int
                     ) -> dict[str, torch.Tensor]:
    """Meta-device tensors (shape and dtype, no storage) for one global
    train batch: the torch analogue of the reference's ShapeDtypeStructs."""
    meta = torch.device("meta")
    specs: dict[str, Any] = {}
    if cfg.frontend == "audio":
        specs["frames"] = torch.empty((batch, seq, cfg.d_model),
                                      dtype=dtype_of(cfg), device=meta)
    else:
        specs["tokens"] = torch.empty((batch, seq), dtype=torch.int32,
                                      device=meta)
    if cfg.frontend == "patch":
        specs["image_embeds"] = torch.empty(
            (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=dtype_of(cfg),
            device=meta)
    specs["targets"] = torch.empty((batch, seq), dtype=torch.int32,
                                   device=meta)
    return specs


def _microbatch(batch: dict, n: int, i: int) -> dict:
    """Rows [i B/n, (i + 1) B/n) of every array of the batch."""
    def cut(x):
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows]
    return {k: cut(v) for k, v in batch.items() if v is not None}


def build_train_step(cfg: ArchConfig, *, num_microbatches: int = 1,
                     peak_lr: float = 3e-4, warmup: int = 100,
                     total_steps: int = 10000, max_grad_norm: float = 1.0,
                     device=None, sharding=None):
    """(params, opt_state, batch) → (params, opt_state, metrics), metrics
    {"loss", "grad_norm", "lr"} as 0-d tensors on the parameters' device.
    The batch holds numpy arrays or tensors ("tokens" or "frames",
    "targets", "image_embeds"); the global batch must split evenly into
    the microbatches (a rank's rows, with `sharding`)."""
    gather = None if sharding is None else sharding.gather
    clip = adamw.global_norm_clip if sharding is None else sharding.clip
    update = adamw.update if sharding is None else sharding.update

    def value_and_grad(params, mb):
        alias = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = tf.loss_fn(alias, cfg, mb, device=device, gather=gather)
        grads = torch.autograd.grad(loss, adamw.tree_leaves(alias))
        return loss.detach(), adamw.tree_unflatten(params, list(grads))

    def grads_of(params, batch):
        if num_microbatches == 1:
            return value_and_grad(params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % num_microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{num_microbatches} microbatches")
        acc_l, acc_g = None, None
        for i in range(num_microbatches):
            l, g = value_and_grad(params, _microbatch(batch, num_microbatches,
                                                      i))
            if acc_g is None:
                acc_l = torch.zeros((), dtype=torch.float32, device=l.device)
                acc_g = adamw.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
            acc_l = acc_l + l
            adamw.tree_map(lambda a, x: a.add_(x), acc_g, g)
            del g
        scale = 1.0 / num_microbatches
        return acc_l * scale, adamw.tree_map(lambda x: x * scale, acc_g)

    def train_step(params, opt_state, batch):
        if sharding is None:
            l, g = grads_of(params, batch)
        else:
            l, g = sharding.mean_over_rows(
                *grads_of(params, sharding.local_batch(batch)))
        g, gnorm = clip(g, max_grad_norm)
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        params, opt_state = update(opt_state, g, params, lr=lr)
        return params, opt_state, {"loss": l, "grad_norm": gnorm, "lr": lr}

    return train_step


def build_prefill_step(cfg: ArchConfig, *, device=None, sharding=None):
    """(params, batch) → logits f32: (B, S, V), or (B, 1, V) with
    cfg.prefill_last_only (serving samples only the last position, so the
    vocab head need not project every position). The batch holds
    "tokens", or "frames" (B, S, D) for an audio frontend, and
    "image_embeds" (B, n_img, D) for a patch frontend. Given a
    `train.sharded.Sharding`, params are this rank's blocks, gathered on
    use, and the step keeps this rank's rows of the batch (B is then the
    rank's rows): as `build_train_step` does, it splits storage, not
    FLOPs."""
    gather = None if sharding is None else sharding.gather

    def prefill_step(params, batch):
        if sharding is not None:
            batch = sharding.local_batch(batch)
        enc = batch.get("image_embeds")
        inp = (batch["frames"] if cfg.frontend == "audio"
               else batch["tokens"])
        return tf.logits_fn(params, cfg, inp, encoder=enc, device=device,
                            gather=gather,
                            last_only=cfg.prefill_last_only and cfg.decoder)

    return prefill_step


def build_decode_step(cfg: ArchConfig, *, device=None, sharding=None):
    """(params, cache, token (B,1), pos) → (logits (B,1,V), cache); the
    cache is updated in place. Given a `train.sharded.Sharding`, params
    are this rank's blocks, gathered on use, and cache and token hold
    this rank's rows."""
    gather = None if sharding is None else sharding.gather

    def decode(params, cache, token, pos):
        return tf.decode_step(params, cfg, cache, token, pos, device=device,
                              gather=gather)

    return decode


def init_all(seed: int, cfg: ArchConfig, *, device=None):
    """(params, AdamWState) on `device` (the card when None): the model's
    parameters from `seed`, float32 zero moments."""
    params = tf.init_model(seed, cfg, device=resolve_device(device))
    return params, adamw.init(params)
