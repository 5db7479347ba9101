"""The pluggable solver family — one protocol over the streamed substrate.

Port of `repro.core.solver` with `krylov_schur` registered. Drivers call

    solve(op, nev, method="krylov_schur")

and every implementation receives a `SolverContext`: the operator, the
`TieredStore` holding its out-of-core blocks, the ortho policy ("fused"
streams each CGS step as one `SubspacePass`, "unfused" keeps the
single-consumer passes), the convergence targets and the per-restart
`callback(step, theta[:nev], res[:nev])`.

Not ported yet, and raising `NotImplementedError` that names the ROADMAP
item: the other family members ("lanczos", "lobpcg", "svd") and the
spectral transforms (queue 1 item 3), `trace=` (item 4, with the rest of
`repro.obs`) and `checkpoint=` / `resume=` (item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Protocol

from repro_torch.core.krylov_schur import eigsh
from repro_torch.core.operator import CAP_SPECTRAL_TRANSFORM, capabilities
from repro_torch.core.residuals import EigResult
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops

# family members of the reference that are still to port, by ROADMAP item
_NOT_PORTED = {"lanczos": 3, "lobpcg": 3, "svd": 3}


@dataclasses.dataclass
class SolverContext:
    """Everything a solver implementation receives. One context = one
    solve."""
    op: object
    nev: int
    which: str
    tol: float
    max_iters: int
    store: TieredStore
    block_size: Optional[int] = None
    ortho: str = "fused"                  # "fused" | "unfused" pass policy
    impl: kops.Impl = "auto"
    seed: int = 0
    compute_eigenvectors: bool = True
    callback: Optional[Callable] = None
    options: Dict = dataclasses.field(default_factory=dict)
    # method-specific extras (num_blocks, group_size, x0, ...)

    @property
    def fused_passes(self) -> bool:
        return self.ortho == "fused"


class Solver(Protocol):
    """A solver implementation: a name for the registry plus a solve
    entry point."""
    name: str

    def solve(self, ctx: SolverContext) -> EigResult:
        ...


class _KrylovSchur:
    name = "krylov_schur"
    default_which = "LM"

    def solve(self, ctx: SolverContext) -> EigResult:
        return eigsh(
            ctx.op, ctx.nev, block_size=ctx.block_size or 4,
            num_blocks=ctx.options.get("num_blocks"),
            tol=ctx.tol, max_restarts=ctx.max_iters, which=ctx.which,
            store=ctx.store, impl=ctx.impl, seed=ctx.seed,
            group_size=ctx.options.get("group_size", 8),
            compute_eigenvectors=ctx.compute_eigenvectors,
            fused_passes=ctx.fused_passes, callback=ctx.callback,
            x0=ctx.options.get("x0"))


_REGISTRY: Dict[str, Solver] = {}


def register_solver(solver: Solver) -> None:
    """Add (or replace) a family member."""
    _REGISTRY[solver.name] = solver


def solver_names() -> list:
    return sorted(_REGISTRY)


register_solver(_KrylovSchur())


def solve(op, nev: int, *, method: str = "krylov_schur",
          which: str | None = None, tol: float = 1e-6,
          max_iters: int = 60, block_size: int | None = None,
          store: TieredStore | None = None, ortho: str = "fused",
          impl: kops.Impl = "auto", seed: int = 0,
          compute_eigenvectors: bool = True,
          callback: Callable | None = None,
          trace=None, checkpoint=None, resume=None,
          **options) -> EigResult:
    """Solve for `nev` eigenpairs of `op` with the chosen family member.

    The store defaults to a `TieredStore` on the operator's device (the
    CUDA card unless the operator was built with `device="cpu"`). All
    remaining keyword arguments land in `SolverContext.options`
    (num_blocks, group_size, x0, ...).
    """
    if trace is not None:
        raise NotImplementedError(
            "solve(trace=...) needs the rest of repro.obs (metrics, "
            "progress, report): ROADMAP.md queue 1 item 4")
    if checkpoint is not None or resume is not None:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet: ROADMAP.md queue 1 item 4")
    if method in _NOT_PORTED and method not in _REGISTRY:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: ROADMAP.md queue 1 item "
            f"{_NOT_PORTED[method]}")
    if method not in _REGISTRY:
        raise ValueError(f"unknown method {method!r}; "
                         f"registered: {solver_names()}")
    if CAP_SPECTRAL_TRANSFORM in capabilities(op):
        raise NotImplementedError(
            "spectral transforms are not ported yet: ROADMAP.md queue 1 "
            "item 3")
    solver = _REGISTRY[method]
    if which is None:
        which = getattr(solver, "default_which", "LM")
    ctx = SolverContext(
        op=op, nev=nev, which=which, tol=tol, max_iters=max_iters,
        store=store or TieredStore(device=getattr(op, "device", None)),
        block_size=block_size, ortho=ortho, impl=impl, seed=seed,
        compute_eigenvectors=compute_eigenvectors, callback=callback,
        options=options)
    return solver.solve(ctx)
