"""prefill_step / decode_step builders (port of `repro.models.steps`).

Each builder returns a plain function of explicit state. `build_train_step`,
`make_batch_specs` and `init_all` wait for the optimizer and training
port (ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.modules import lm_logits


def build_prefill_step(cfg: ArchConfig, *, device=None):
    """(params, batch) → logits f32: (B, S, V), or (B, 1, V) with
    cfg.prefill_last_only (serving samples only the last position, so the
    vocab head need not project every position). The batch holds
    "tokens", or "frames" (B, S, D) for an audio frontend, and
    "image_embeds" (B, n_img, D) for a patch frontend."""

    def prefill_step(params, batch):
        enc = batch.get("image_embeds")
        inp = (batch["frames"] if cfg.frontend == "audio"
               else batch["tokens"])
        if cfg.prefill_last_only and cfg.decoder:
            h = tf.forward(params, cfg, inp, encoder=enc, device=device)
            return lm_logits(cfg, params, h[:, -1:])
        return tf.logits_fn(params, cfg, inp, encoder=enc, device=device)

    return prefill_step


def build_decode_step(cfg: ArchConfig, *, device=None):
    """(params, cache, token (B,1), pos) → (logits (B,1,V), cache); the
    cache is updated in place."""

    def decode(params, cache, token, pos):
        return tf.decode_step(params, cfg, cache, token, pos, device=device)

    return decode
