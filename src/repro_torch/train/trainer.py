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
seconds.

With `mesh` (a `dist.comm.Mesh`, in a world started by `dist.spawn`)
the same loop runs sharded (`train.sharded`): every rank holds its
blocks of the parameters and moments and runs the same steps on its
rows. Rank 0 reads the newest checkpoint step and every rank resumes
from it, each reading only its blocks (`ckpt.restore(shardings=)`); a
checkpoint is written by rank 0 in the unsharded format (full arrays,
gathered leaf by leaf), so it resumes on any mesh, unsharded, or in the
reference; a preemption on any rank stops every rank at the same step.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.ft.preemption import PreemptionGuard
from repro_torch.ft.straggler import StragglerTracker
from repro_torch.models import steps as S
from repro_torch.optim import adamw
from repro_torch.train import sharded as sh


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
    "losses", "grad_norms" and "step_s". cfg is an ArchConfig. With
    `mesh`, on the mesh's device (`device` is not read), per rank also
    "held_bytes" (parameter and moment blocks, as held and as the specs
    count them), "step_bytes" (each step's collective bytes by kind),
    "analytic_bytes" (the design's count of one step), "mesh_bytes" (the
    whole run's, checkpoints included) and "peak_device_bytes" (None on
    the CPU)."""
    shards = None
    if mesh is None:
        dev = resolve_device(device)
        params, opt_state = S.init_all(tcfg.seed, cfg, device=dev)
    else:
        dev = mesh.device
        shards = sh.Sharding(cfg, mesh)
        params, opt_state = shards.init_all(tcfg.seed)
        log = log if mesh.rank == 0 else (lambda *_: None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    step_fn = S.build_train_step(cfg, num_microbatches=tcfg.num_microbatches,
                                 peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                                 total_steps=tcfg.steps, device=dev,
                                 sharding=shards)
    pipe = TokenPipeline(data_cfg)
    writer = ckpt.AsyncWriter()
    start_step = 0
    latest = _latest_step(tcfg.ckpt_dir, mesh)
    if latest is not None:
        (params, opt_state), extra = ckpt.restore(
            tcfg.ckpt_dir, latest, (params, opt_state),
            shardings=None if shards is None else shards.placements())
        start_step = int(extra.get("data_step", latest))
        log(f"restored checkpoint step {latest}; resuming at {start_step}")

    def submit(step):
        state = ((params, opt_state) if shards is None
                 else shards.full_state(params, opt_state))
        if state is not None:
            writer.submit(tcfg.ckpt_dir, step, state,
                          extra={"data_step": step})

    tracker = StragglerTracker()
    losses, norms, times, step_bytes = [], [], [], []
    t_start = time.time()
    with PreemptionGuard() as guard:
        step = start_step
        while step < tcfg.steps:
            batch = pipe.batch(step)
            before = None if mesh is None else dict(mesh.bytes)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if mesh is not None:
                step_bytes.append({k: v - before.get(k, 0)
                                   for k, v in mesh.bytes.items()
                                   if v != before.get(k, 0)})
            tracker.record(0, dt)
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            times.append(dt)
            if step % tcfg.log_every == 0:
                log(f"step {step:5d} loss {loss:8.4f} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")
            step += 1
            stop = _any_rank(guard.requested(), mesh)
            if step % tcfg.ckpt_every == 0 or stop:
                submit(step)
                if stop:
                    log("preemption requested — checkpointed, exiting")
                    break
        t0 = time.time()
        submit(step)
        writer.wait()
        if writer.last_path is not None:
            log(f"final checkpoint {writer.last_path}: "
                f"{_dir_bytes(writer.last_path)} bytes in "
                f"{time.time() - t0:.2f} s")
        if mesh is None or mesh.rank == 0:
            ckpt.gc_old(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)

    summary = {
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
    if shards is not None:
        held = lambda tree: sum(t.numel() * t.element_size()
                                for t in adamw.tree_leaves(tree))
        summary.update(
            held_bytes={"params": held(params),
                         "moments": held((opt_state.m, opt_state.v)),
                         "specs": shards.held_bytes()},
            step_bytes=step_bytes,
            analytic_bytes=shards.analytic_bytes(tcfg.num_microbatches),
            mesh_bytes=dict(mesh.bytes),
            peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None))
    return summary


def _latest_step(root: str, mesh) -> int | None:
    """The newest checkpoint step; with a mesh, rank 0's, broadcast."""
    if mesh is None:
        return ckpt.latest_step(root)
    mine = ckpt.latest_step(root) if mesh.rank == 0 else None
    t = torch.tensor(-1 if mine is None else mine, dtype=torch.int64,
                     device=mesh.device)
    got = int(mesh.broadcast(t))
    return None if got < 0 else got


def _any_rank(flag: bool, mesh) -> bool:
    """Whether any rank's flag is set (a max over the ranks)."""
    if mesh is None:
        return flag
    t = torch.tensor(int(flag), dtype=torch.int32, device=mesh.device)
    return bool(mesh.all_reduce(t, op="max"))
