"""repro_torch.ft — preemption-safe shutdown (port of `repro.ft`'s
`PreemptionGuard`). The solver-side consumer is
`ckpt.solver.SolveCheckpointer` (pass a `PreemptionGuard` in its
`CheckpointPolicy`)."""
from repro_torch.ft.preemption import PreemptionGuard

__all__ = ["PreemptionGuard"]
