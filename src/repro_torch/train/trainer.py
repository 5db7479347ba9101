"""Training loop: data pipeline + optimizer + checkpoint/restart + FT
hooks (port of `repro.train.trainer`).

Fault-tolerance wiring, as in the reference:
  * checkpoint every `ckpt_every` steps through AsyncWriter (atomic
    manifest); restore-on-start picks the newest valid step, so
    preemption or a crash loses at most `ckpt_every` steps. The state is
    `(params, AdamWState)` in the reference's on-disk format: a
    checkpoint of either package resumes in the other;
  * PreemptionGuard converts SIGTERM into "checkpoint now, exit 0";
  * StragglerTracker consumes per-step timings;
  * the data pipeline is a pure function of (seed, step): a restart
    resumes mid-epoch exactly.

The loop runs on `device` (the card when None; the CPU tests pass
"cpu"). A step's time is taken after `float(loss)`, which waits for the
device. The final checkpoint's write is logged with its path, bytes and
seconds. `mesh` (the reference's sharded training) raises: the specs
are ported (`models/sharding.py`), applying them is ROADMAP.md queue 1
item 7.4.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.ft.preemption import PreemptionGuard
from repro_torch.ft.straggler import StragglerTracker
from repro_torch.models import steps as S


@dataclasses.dataclass
class TrainConfig:
    steps: int = 300
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    log_every: int = 10
    peak_lr: float = 3e-4
    warmup: int = 50
    num_microbatches: int = 1
    seed: int = 0


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def train(cfg, tcfg: TrainConfig, data_cfg: DataConfig, *, mesh=None,
          log: Callable[[str], None] = print, device=None) -> dict:
    """Returns summary metrics: the reference's (final and first loss,
    steps run, wall seconds, straggler decisions) and, per step run,
    "losses", "grad_norms" and "step_s". cfg is an ArchConfig."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...) is sharded training, not ported yet: "
            "ROADMAP.md queue 1 item 7.4")
    dev = resolve_device(device)
    params, opt_state = S.init_all(tcfg.seed, cfg, device=dev)
    step_fn = S.build_train_step(cfg, num_microbatches=tcfg.num_microbatches,
                                 peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                                 total_steps=tcfg.steps, device=dev)
    pipe = TokenPipeline(data_cfg)
    writer = ckpt.AsyncWriter()
    start_step = 0
    latest = ckpt.latest_step(tcfg.ckpt_dir)
    if latest is not None:
        (params, opt_state), extra = ckpt.restore(
            tcfg.ckpt_dir, latest, (params, opt_state))
        start_step = int(extra.get("data_step", latest))
        log(f"restored checkpoint step {latest}; resuming at {start_step}")

    tracker = StragglerTracker()
    losses, norms, times = [], [], []
    t_start = time.time()
    with PreemptionGuard() as guard:
        step = start_step
        while step < tcfg.steps:
            batch = pipe.batch(step)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            tracker.record(0, dt)
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            times.append(dt)
            if step % tcfg.log_every == 0:
                log(f"step {step:5d} loss {loss:8.4f} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")
            step += 1
            if step % tcfg.ckpt_every == 0 or guard.requested():
                writer.submit(tcfg.ckpt_dir, step, (params, opt_state),
                              extra={"data_step": step})
                if guard.requested():
                    log("preemption requested — checkpointed, exiting")
                    break
        t0 = time.time()
        writer.submit(tcfg.ckpt_dir, step, (params, opt_state),
                      extra={"data_step": step})
        writer.wait()
        log(f"final checkpoint {writer.last_path}: "
            f"{_dir_bytes(writer.last_path)} bytes in "
            f"{time.time() - t0:.2f} s")
        ckpt.gc_old(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)

    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "steps_run": len(losses),
        "wall_s": time.time() - t_start,
        "straggler_decisions": [dataclasses.asdict(d)
                                for d in tracker.decisions()],
        "losses": losses,
        "grad_norms": norms,
        "step_s": times,
    }
