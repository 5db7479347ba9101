"""Training launcher (port of `repro.launch.train`).

  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 100
  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 6 \
      --seq-len 4096 --global-batch 4 --microbatches 2 --ckpt-dir /dev/shm/ck
  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 10 \
      --world 4 --backend gloo --device cpu

Trains on the CUDA card (the flash forward and backward kernels) unless
`--device cpu`; without a card and without `--device cpu` it raises.
Checkpoint/restart, preemption handling and the deterministic pipeline
come from train.trainer; rerun with the same --ckpt-dir to resume.

`--world N` (N > 1) trains sharded on N ranks started by `dist.spawn`:
the reference's debug mesh `make_debug_mesh(N)`, (data d, model N/d),
as a (1, d, N/d) `dist.comm.Mesh`. `--backend nccl` needs a card per
rank; ranks that share a card, or the CPU, take gloo (CUDA tensors
staged through host memory). A backend that does not fit the device
raises (`comm.check_backend`): nothing falls back. `--world 1` is the
single process of before.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import comm
from repro_torch.launch.mesh import make_debug_mesh, rank_grid
from repro_torch.train.trainer import TrainConfig, train


def rank_main(mesh, cfg, tcfg: TrainConfig, dcfg: DataConfig, *,
              log=print) -> dict:
    """One rank of a sharded run (`dist.spawn`'s rank function)."""
    return train(cfg, tcfg, dcfg, mesh=mesh, log=log)


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
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of a sharded run (1: one process)")
    ap.add_argument("--backend", choices=comm.BACKENDS, default="gloo")
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
    device = None if args.device == "cuda" else "cpu"
    if args.world == 1:
        summary = train(cfg, tcfg, dcfg, device=device)
    else:
        shape = rank_grid(make_debug_mesh(args.world))
        print(f"mesh (pod, data, model) = {shape} over {args.world} "
              f"{args.backend} ranks")
        summary = comm.spawn(rank_main, shape, backend=args.backend,
                             device=device, args=(cfg, tcfg, dcfg))[0]
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    main()
