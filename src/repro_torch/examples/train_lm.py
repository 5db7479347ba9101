"""End-to-end training driver: train a small LM for a few hundred steps on
the deterministic synthetic corpus, with checkpoint/restart (port of the
root `examples/train_lm.py`).

    PYTHONPATH=src python -m repro_torch.examples.train_lm             # ~20M
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --steps 30

Runs on the CUDA card unless `--device cpu`. Interrupt it (SIGTERM) and
rerun: it resumes from the newest checkpoint.
"""
import argparse
import dataclasses

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import TrainConfig, train


PRESETS = {
    # ~21M params: qwen2-family (GQA + GLU), scaled
    "20m": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                head_dim=64, d_ff=1024, vocab_size=8192,
                seq_len=128, global_batch=8, steps=300),
    # ~113M params
    "100m": dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=2,
                 head_dim=64, d_ff=2048, vocab_size=32000,
                 seq_len=512, global_batch=32, steps=300),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="20m", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    p = PRESETS[args.preset]
    base = configs.get("qwen2-1.5b")
    cfg = dataclasses.replace(
        base, name=f"lm-{args.preset}",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], param_dtype="float32", remat=False)
    print(f"model: {cfg.param_count()/1e6:.1f}M params")
    steps = args.steps or p["steps"]
    tcfg = TrainConfig(steps=steps, ckpt_every=50, ckpt_dir=args.ckpt_dir,
                       peak_lr=1e-3, warmup=30, log_every=10)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq_len"],
                      global_batch=p["global_batch"])
    # "cuda" is the default device, which raises without a card
    summary = train(cfg, tcfg, dcfg,
                    device=None if args.device == "cuda" else "cpu")
    print("summary:", {k: v for k, v in summary.items()
                       if k not in ("losses", "grad_norms", "step_s")})
    if not summary["final_loss"] < summary["first_loss"]:
        raise SystemExit("the loss did not fall")
    return summary


if __name__ == "__main__":
    main()
