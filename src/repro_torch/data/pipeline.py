"""Deterministic, shard-aware token pipeline (a numpy copy of
`repro.data.pipeline`: batches equal the reference's bit for bit).

Production posture: every batch is a pure function of (seed, step), so a
restarted / re-sharded job resumes mid-epoch exactly (skip-ahead = just pass
the restored step). File-backed mode memory-maps a token file; synthetic
mode generates a fixed pseudo-corpus (zipfian unigrams + short-range
repetition so a ~100M model actually has something to learn)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: str | None = None  # .npy int32 flat tokens


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.token_file:
            self._tokens = np.load(cfg.token_file, mmap_mode="r")
        else:
            self._tokens = None

    def _synthetic(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        shape = (cfg.global_batch, cfg.seq_len + 1)
        # zipf-ish unigram distribution over the vocab
        z = rng.zipf(1.3, size=shape).astype(np.int64)
        toks = (z - 1) % cfg.vocab_size
        # inject copy structure: second half repeats first half shifted
        half = cfg.seq_len // 2
        toks[:, half:half * 2] = toks[:, :half]
        return toks.astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Global batch for `step` → {tokens, targets} (targets shifted)."""
        cfg = self.cfg
        if self._tokens is None:
            full = self._synthetic(step)
        else:
            need = cfg.global_batch * (cfg.seq_len + 1)
            start = (step * need) % max(1, len(self._tokens) - need)
            full = np.asarray(self._tokens[start:start + need]).reshape(
                cfg.global_batch, cfg.seq_len + 1).astype(np.int32)
        return {"tokens": full[:, :-1], "targets": full[:, 1:]}

    def host_shard(self, batch: dict, host_id: int, n_hosts: int) -> dict:
        """Per-host slice of the global batch (data-parallel ingestion)."""
        b = self.cfg.global_batch
        if b % n_hosts:
            raise ValueError(f"global batch {b} does not split over "
                             f"{n_hosts} hosts")
        lo = host_id * (b // n_hosts)
        hi = lo + b // n_hosts
        return {k: v[lo:hi] for k, v in batch.items()}
