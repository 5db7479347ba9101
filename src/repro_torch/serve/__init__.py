"""repro_torch.serve — eigensolver-as-a-service over one shared SAFS store
(port of `repro.serve`).

Layers (see serve/README.md): `TieredStore.namespace()` gives each job an
isolated, accounted slice of one store; `BudgetArbiter` splits the global
device budget across live sessions by priority; `SolveScheduler` runs an
admission-controlled priority queue with checkpoint-based preemption;
`EigenService` is the front end that submits JobSpecs and emits the
machine-readable serve report. `PagedKVCache` (the LM-serving demo) rides
the same namespace API. On the card every session's solve launches the
SpMM, gram and tsgemm kernels.
"""
from repro_torch.serve.api import EigenService, build_service, validate_report
from repro_torch.serve.arbiter import BudgetArbiter
from repro_torch.serve.paged_kv import PagedConfig, PagedKVCache
from repro_torch.serve.scheduler import AdmissionError, SolveScheduler
from repro_torch.serve.session import (JobSpec, PreemptFlag, SolveSession,
                                       spectrum_digest)

__all__ = [
    "AdmissionError", "BudgetArbiter", "EigenService", "JobSpec",
    "PagedConfig", "PagedKVCache", "PreemptFlag", "SolveScheduler",
    "SolveSession", "build_service", "spectrum_digest", "validate_report",
]
