"""repro_torch.ft — fault-tolerance primitives (port of `repro.ft`):
preemption-safe shutdown, file-based membership coordination, straggler
detection. The consumers are `ckpt.solver.SolveCheckpointer` (pass a
`PreemptionGuard` in its `CheckpointPolicy`) and `train.trainer.train`.
"""
from repro_torch.ft.coordinator import Coordinator
from repro_torch.ft.preemption import PreemptionGuard
from repro_torch.ft.straggler import StragglerDecision, StragglerTracker

__all__ = ["Coordinator", "PreemptionGuard", "StragglerDecision",
           "StragglerTracker"]
