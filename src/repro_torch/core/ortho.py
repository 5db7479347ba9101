"""Block (re)orthogonalization — step (1) of Algorithm 1.

Port of `repro.core.ortho` (cholqr, bcgs2, ortho_error). Reorthogonaliza-
tion (MvTransMv + MvTimesMatAddMv) dominates the solver's cost when many
eigenvalues are wanted:

  * cholqr — CholeskyQR2: Gram (the `gram` kernel) → Cholesky →
             triangular solve, twice. The b×b factorizations go to
             `torch.linalg`.
  * bcgs2  — block Gram–Schmidt (×2) of a new block against an
             out-of-core MultiVector basis; fused=True runs each pass as
             one streamed subspace read (`MultiVector.project_out`),
             fused=False keeps the MvTransMv + MvTimesMatAddMv pair per
             pass (4 reads) for parity tests.

`svqb` / `svqb_transform` come with the LOBPCG port (ROADMAP queue 1
item 3).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.multivector import MultiVector
from repro_torch.kernels import ops as kops


def _robust_cholesky(g: torch.Tensor) -> torch.Tensor:
    """Shifted Cholesky with escalating shifts (rank-deficient guards):
    the first of g + s·tr(g)/b·I, s ∈ (1e-7, 1e-4, 1e-1), that factors.
    The reference computes all three and keeps the first NaN-free one,
    which selects the same factor."""
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    tr = torch.trace(g) / g.shape[0] + 1e-30
    for shift in (1e-7, 1e-4):
        l, info = torch.linalg.cholesky_ex(g + shift * tr * eye)
        if int(info) == 0 and bool(torch.isfinite(l).all()):
            return l
    return torch.linalg.cholesky_ex(g + 1e-1 * tr * eye)[0]


def cholqr(x: torch.Tensor, *, impl: kops.Impl = "auto", iters: int = 2
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CholeskyQR² — returns (Q, R) with Q orthonormal, X = Q R.

    Shifted Cholesky guards ill-conditioning: G + eps*tr(G)*I, with
    escalating shifts on (near-)rank-deficient blocks.
    """
    r_total = torch.eye(x.shape[1], dtype=torch.float32, device=x.device)
    q = x
    for _ in range(iters):
        g = kops.gram(q, q, impl=impl)
        l = _robust_cholesky(g)
        r = l.T
        # Q ← Q L⁻ᵀ, i.e. (L⁻¹ Qᵀ)ᵀ as in the reference
        q = torch.linalg.solve_triangular(r, q, upper=True,
                                          left=False).contiguous()
        r_total = r @ r_total
    return q, r_total


def bcgs2(basis: MultiVector, w: torch.Tensor, *, impl: kops.Impl = "auto",
          fused: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Orthogonalize block W against the out-of-core basis V, twice, then
    orthonormalize within the block (CholQR).

    Returns (Q, H, R):  W = V @ H + Q @ R,  VᵀQ = 0,  QᵀQ = I, with
    H = h1 + h2 including the second-pass correction, so the Krylov
    invariant holds with the returned H exactly.
    """
    if basis.nblocks == 0:
        q, r = cholqr(w, impl=impl)
        h = torch.zeros((0, w.shape[1]), dtype=torch.float32, device=w.device)
        return q, h, r
    if fused:
        h1, w = basis.project_out(w)              # one streamed read
        h2, w = basis.project_out(w)              # second pass (CGS2)
    else:
        h1 = basis.mv_trans_mv(w)                 # VᵀW
        w = w - basis.mv_times_mat(h1)            # W -= V (VᵀW)
        h2 = basis.mv_trans_mv(w)
        w = w - basis.mv_times_mat(h2)
    q, r = cholqr(w, impl=impl)
    return q, h1 + h2, r


def ortho_error(q: torch.Tensor) -> float:
    """‖QᵀQ − I‖_max — test invariant."""
    g = q.T @ q
    return float(torch.max(torch.abs(
        g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device))))
