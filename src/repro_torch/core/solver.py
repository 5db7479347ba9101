"""The pluggable solver family — one protocol over the streamed substrate.

Port of `repro.core.solver`. Drivers call

    solve(op, nev, method="krylov_schur" | "lanczos" | "lobpcg" | "svd")

and every implementation receives a `SolverContext`: the operator, the
`TieredStore` holding its out-of-core blocks, the ortho policy ("fused"
streams each CGS / gram / update step as one `SubspacePass`, "unfused"
keeps the single-consumer passes), the convergence targets and the
per-restart (or per-iteration) `callback(step, theta[:nev], res[:nev])`.

Spectral transforms compose at this layer: when the operator declares
`CAP_SPECTRAL_TRANSFORM` (ShiftInvertOperator, ChebyshevFilterOperator),
`solve` runs the chosen method on the transform — `which` then selects in
the transformed spectrum, "LM" by default — and afterwards maps the Ritz
values back through `op.untransform` and replaces the cheap residual
bounds with true residuals against the inner operator, so the returned
`EigResult` describes eigenpairs of A itself.

The start block of every method can be given explicitly through the
options (`x0=`, passed on to the method), as parity tests do with the
reference's `jax.random` draw.

`trace=` records the whole solve on one timeline (`repro_torch.obs`),
and `checkpoint=` / `resume=` snapshot and continue Krylov–Schur and
LOBPCG at their restart (iteration) boundaries (`repro_torch.ckpt`), in
the reference's formats: a trace of either package passes either
package's `report.validate`, and a snapshot of either resumes in the
other.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Protocol, Union

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.progress import ConvergenceTracker
from repro_torch.core.krylov_schur import eigsh
from repro_torch.core.lanczos import lanczos_eigsh
from repro_torch.core.lobpcg import lobpcg
from repro_torch.core.operator import CAP_SPECTRAL_TRANSFORM, capabilities
from repro_torch.core.residuals import EigResult
from repro_torch.core.svd import svds
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops


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
    checkpoint: Optional[object] = None   # ckpt.solver.CheckpointPolicy
    resume: Optional[str] = None          # checkpoint root to resume from
    options: Dict = dataclasses.field(default_factory=dict)
    # method-specific extras (num_blocks, group_size, precond, at_op, x0)

    @property
    def fused_passes(self) -> bool:
        return self.ortho == "fused"


class Solver(Protocol):
    """A solver implementation: a name for the registry plus a solve
    entry point."""
    name: str

    def solve(self, ctx: SolverContext) -> EigResult:
        ...


def _make_checkpointer(ctx: SolverContext, method: str, *, block_size):
    """Build the checkpoint/resume bridge for the methods that support it
    (None when the context asks for neither). The solve-shape params are
    recorded in every snapshot and verified on resume, so a checkpoint
    can never silently continue a *different* solve."""
    if ctx.checkpoint is None and ctx.resume is None:
        return None
    from repro_torch.ckpt.solver import SolveCheckpointer
    return SolveCheckpointer(
        ctx.checkpoint, method=method,
        resume_from=(os.fspath(ctx.resume) if ctx.resume else None),
        params={"nev": ctx.nev, "which": ctx.which,
                "block_size": block_size})


class _KrylovSchur:
    name = "krylov_schur"
    default_which = "LM"

    def solve(self, ctx: SolverContext) -> EigResult:
        b = ctx.block_size or 4
        return eigsh(
            ctx.op, ctx.nev, block_size=b,
            num_blocks=ctx.options.get("num_blocks"),
            tol=ctx.tol, max_restarts=ctx.max_iters, which=ctx.which,
            store=ctx.store, impl=ctx.impl, seed=ctx.seed,
            group_size=ctx.options.get("group_size", 8),
            compute_eigenvectors=ctx.compute_eigenvectors,
            fused_passes=ctx.fused_passes, callback=ctx.callback,
            checkpointer=_make_checkpointer(ctx, self.name, block_size=b),
            x0=ctx.options.get("x0"))


class _Lanczos:
    name = "lanczos"
    default_which = "LM"

    def solve(self, ctx: SolverContext) -> EigResult:
        return lanczos_eigsh(
            ctx.op, ctx.nev, block_size=ctx.block_size or 4,
            num_blocks=ctx.options.get("num_blocks"), which=ctx.which,
            store=ctx.store, impl=ctx.impl, seed=ctx.seed,
            group_size=ctx.options.get("group_size", 8),
            compute_eigenvectors=ctx.compute_eigenvectors,
            fused_passes=ctx.fused_passes, callback=ctx.callback,
            x0=ctx.options.get("x0"))


class _Lobpcg:
    name = "lobpcg"
    default_which = "LA"

    def solve(self, ctx: SolverContext) -> EigResult:
        return lobpcg(
            ctx.op, ctx.nev, block_size=ctx.block_size,
            tol=ctx.tol, max_iters=ctx.max_iters, which=ctx.which,
            precond=ctx.options.get("precond"), store=ctx.store,
            seed=ctx.seed, impl=ctx.impl, fused_passes=ctx.fused_passes,
            group_size=ctx.options.get("group_size", 8),
            callback=ctx.callback,
            checkpointer=_make_checkpointer(
                ctx, self.name, block_size=ctx.block_size or ctx.nev),
            x0=ctx.options.get("x0"))


class _Svd:
    """`svd.svds` behind the family dispatch: eigensolve of AᵀA via the
    Krylov–Schur manager, σ = √λ. Requires `at_op` (the Aᵀ operator) in
    ctx.options; the returned EigResult carries σ as `eigenvalues` and U
    as `eigenvectors` (use `svd.svds` directly for the full triplet)."""
    name = "svd"
    default_which = "LA"

    def solve(self, ctx: SolverContext) -> EigResult:
        at_op = ctx.options.get("at_op")
        if at_op is None:
            raise ValueError("method='svd' needs options={'at_op': <Aᵀ op>}")
        r = svds(ctx.op, at_op, ctx.nev, block_size=ctx.block_size or 2,
                 num_blocks=ctx.options.get("num_blocks"), tol=ctx.tol,
                 max_restarts=ctx.max_iters, store=ctx.store, impl=ctx.impl,
                 seed=ctx.seed, compute_vectors=ctx.compute_eigenvectors,
                 callback=ctx.callback, x0=ctx.options.get("x0"))
        return EigResult(
            eigenvalues=r.s, eigenvectors=r.u,
            residuals=np.zeros_like(r.s), n_restarts=r.n_restarts,
            n_ops=r.n_ops, m_subspace=0, converged=r.converged,
            io_stats=r.io_stats)


_REGISTRY: Dict[str, Solver] = {}


def register_solver(solver: Solver) -> None:
    """Add (or replace) a family member."""
    _REGISTRY[solver.name] = solver


def solver_names() -> list:
    return sorted(_REGISTRY)


for _s in (_KrylovSchur(), _Lanczos(), _Lobpcg(), _Svd()):
    register_solver(_s)


def _untransform(op, res: EigResult) -> EigResult:
    """Map an EigResult computed on a spectral transform back to the inner
    operator: eigenvalues via `op.untransform` (Rayleigh quotients on the
    inner operator when vectors were materialized), residuals re-measured
    against the inner operator (the solver's cheap bounds were residuals
    of f(A), which say nothing quantitative about A)."""
    vecs = res.eigenvectors
    lam = op.untransform(res.eigenvalues, vecs)
    if vecs is None:
        return dataclasses.replace(res, eigenvalues=lam)
    x = vecs.float()
    ax = op.inner.matmat(x)
    th = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    resid = torch.linalg.norm(ax - x * th[None, :], dim=0)
    return dataclasses.replace(res, eigenvalues=lam,
                               residuals=resid.double().cpu().numpy())


def solve(op, nev: int, *, method: str = "krylov_schur",
          which: str | None = None, tol: float = 1e-6,
          max_iters: int = 60, block_size: int | None = None,
          store: TieredStore | None = None, ortho: str = "fused",
          impl: kops.Impl = "auto", seed: int = 0,
          compute_eigenvectors: bool = True,
          callback: Callable | None = None,
          trace: Union[obs_trace.Tracer, str, os.PathLike, None] = None,
          checkpoint=None, resume: Union[str, os.PathLike, None] = None,
          **options) -> EigResult:
    """Solve for `nev` eigenpairs of `op` with the chosen family member.

    method: one of `solver_names()` — "krylov_schur" (the paper's driver),
    "lanczos" (HEIGEN-style no-restart baseline), "lobpcg" (3·b working
    set, out-of-core [X, W, P]), "svd" (AᵀA Gram path; needs
    `at_op=<Aᵀ operator>`).

    which defaults per method ("LM" for the Krylov solvers, "LA" for
    LOBPCG and svd). When `op` declares CAP_SPECTRAL_TRANSFORM, `which`
    selects in the transformed spectrum (default "LM"; LOBPCG takes "LA"
    for it) and the result is mapped back to eigenpairs of the inner
    operator, with true residuals against it.

    The store defaults to a `TieredStore` on the operator's device (the
    CUDA card unless the operator was built with `device="cpu"`).

    trace: an `obs.Tracer` (or a path — a fresh Tracer is created and its
    JSONL timeline written there on completion) records the whole solve:
    a root "solve" span, every instrumented substrate span, per-step
    "convergence.step" events with an ETA estimate, and a "solve.io"
    metrics record with before/after/delta I/O-counter snapshots. The
    Tracer is attached to the result as `EigResult.trace`; feed its JSONL
    to `python -m repro_torch.obs.report` for the report and the
    `--validate` gate.

    checkpoint: a `ckpt.solver.CheckpointPolicy(root, every_restarts=N,
    guard=...)` — the solve snapshots its full state at restart (eigsh) /
    iteration (lobpcg) boundaries into `root` and, when the policy's
    `ft.PreemptionGuard` fires mid-solve, finishes the in-flight restart,
    checkpoints, and raises `ckpt.solver.SolveSuspended`. resume: a
    checkpoint root to continue from — the solve restores the newest
    committed snapshot bit-identically and walks on; pass both to keep
    checkpointing after a resume. Supported by "krylov_schur" and
    "lobpcg".

    All remaining keyword arguments land in `SolverContext.options`
    (num_blocks, group_size, precond, at_op, x0).
    """
    if method not in _REGISTRY:
        raise ValueError(f"unknown method {method!r}; "
                         f"registered: {solver_names()}")
    if (checkpoint is not None or resume is not None) and method not in (
            "krylov_schur", "lobpcg"):
        raise ValueError(
            f"checkpoint/resume is supported for methods "
            f"'krylov_schur' and 'lobpcg', not {method!r}")
    solver = _REGISTRY[method]
    is_transform = CAP_SPECTRAL_TRANSFORM in capabilities(op)
    if which is None:
        which = "LM" if is_transform else getattr(solver, "default_which",
                                                  "LM")
    if is_transform and method == "lobpcg" and which == "LM":
        # LOBPCG optimizes an algebraic extreme; for the transforms LM ≈ LA
        # (shift-invert near a dominant σ-neighborhood, Chebyshev filters
        # are ≥ 1 on the wanted set) — take the algebraic top
        which = "LA"
    trace_path = None
    tracer = None
    if trace is not None:
        if isinstance(trace, obs_trace.Tracer):
            tracer = trace
        else:
            trace_path = os.fspath(trace)
            tracer = obs_trace.Tracer()

    ctx = SolverContext(
        op=op, nev=nev, which=which, tol=tol, max_iters=max_iters,
        store=store or TieredStore(device=getattr(op, "device", None)),
        block_size=block_size, ortho=ortho, impl=impl, seed=seed,
        compute_eigenvectors=compute_eigenvectors, callback=callback,
        checkpoint=checkpoint,
        resume=os.fspath(resume) if resume is not None else None,
        options=options)

    if tracer is None:
        res = solver.solve(ctx)
        if is_transform:
            res = _untransform(op, res)
        return res

    conv = ConvergenceTracker(tracer, tol=tol, nev=nev, method=method)
    ctx.callback = conv.chain(callback)
    with obs_trace.tracing(tracer):
        with obs_trace.span("solve", method=method, nev=nev, which=which,
                            tol=tol) as sp:
            s0 = obs_metrics.snapshot_store(ctx.store)
            res = solver.solve(ctx)
            if is_transform:
                res = _untransform(op, res)
            s1 = obs_metrics.snapshot_store(ctx.store)
            sp.set(converged=res.converged, restarts=res.n_restarts,
                   n_ops=res.n_ops)
        tracer.metric("solve.io", {"start": s0, "end": s1,
                                   "delta": obs_metrics.delta(s0, s1)})
    if trace_path is not None:
        tracer.write_jsonl(trace_path)
    return dataclasses.replace(res, trace=tracer)
