"""repro_torch.ckpt — atomic checkpoints + eigensolve suspend/resume
(port of `repro.ckpt`, in the reference's on-disk format).

`checkpoint` holds the storage primitives (atomic tree manifests, SAFS
page snapshots, stale-tmp GC); `solver` the eigensolve-facing layer
(restart-boundary snapshots, preemption suspend, bit-identical resume).
"""
from repro_torch.ckpt.checkpoint import (AsyncWriter, gc_old, latest_step,
                                         restore, restore_safs, save,
                                         save_safs, valid_steps)
from repro_torch.ckpt.solver import (CheckpointPolicy, ResumeState,
                                     SolveCheckpointer, SolveSuspended)

__all__ = [
    "AsyncWriter", "gc_old", "latest_step", "restore", "restore_safs",
    "save", "save_safs", "valid_steps",
    "CheckpointPolicy", "ResumeState", "SolveCheckpointer",
    "SolveSuspended",
]
