"""Training launcher (port of `repro.launch.train`).

  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 100
  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 6 \
      --seq-len 4096 --global-batch 4 --microbatches 2 --ckpt-dir /dev/shm/ck

Trains on the CUDA card (the flash forward and backward kernels) unless
`--device cpu`; without a card and without `--device cpu` it raises.
Checkpoint/restart, preemption handling and the deterministic pipeline
come from train.trainer; rerun with the same --ckpt-dir to resume. The
reference's debug mesh has no counterpart: one process trains on one
device (sharded training is ROADMAP queue 1 item 7.4).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import TrainConfig, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the arch family")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    if cfg.frontend is not None:
        raise SystemExit("frontend archs need the example drivers "
                         "(precomputed embeddings)")
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, peak_lr=args.lr,
                       num_microbatches=args.microbatches, seed=args.seed)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=args.seed)
    # "cuda" is the default device, which raises without a card
    summary = train(cfg, tcfg, dcfg,
                    device=None if args.device == "cuda" else "cpu")
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    main()
