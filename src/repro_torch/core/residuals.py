"""Ritz ordering, the solve result, and true residuals (Algorithm 1,
steps 3–4). Port of `repro.core.residuals`."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def sort_ritz(theta, which: str) -> np.ndarray:
    """Return index order putting the wanted Ritz values first.

    LM: largest magnitude (spectral analysis default),
    LA: largest algebraic, SA: smallest algebraic.
    """
    t = np.asarray(theta)
    if which == "LM":
        return np.argsort(-np.abs(t), kind="stable")
    if which == "LA":
        return np.argsort(-t, kind="stable")
    if which == "SA":
        return np.argsort(t, kind="stable")
    raise ValueError(f"unknown which={which}")


def ritz_residual_bounds(s_coupling, y) -> np.ndarray:
    """Cheap residual norms from the Krylov relation A V = V H + Q S eᵀ:
    ‖A x_i − θ_i x_i‖ = ‖S y_i[last-block rows]‖ — no I/O needed.

    s_coupling: (b, m) coupling (nonzero only in trailing columns
    pre-restart); y: (m, k) Ritz eigenvectors of H. Host arrays (H and
    its Ritz bookkeeping stay in float64 numpy, as in the reference)."""
    return np.linalg.norm(np.asarray(s_coupling) @ np.asarray(y), axis=0)


@dataclasses.dataclass
class EigResult:
    eigenvalues: np.ndarray        # (nev,)
    eigenvectors: torch.Tensor | None  # (n, nev) on the operator's device
    residuals: np.ndarray          # (nev,) cheap bounds at convergence
    n_restarts: int
    n_ops: int                     # number of operator block applications
    m_subspace: int
    converged: bool
    io_stats: dict | None = None
    trace: object | None = None    # obs.Tracer when solve(..., trace=) was used
    resumed_step: int | None = None  # checkpoint step this solve resumed from


def true_residuals(op, x, theta: Sequence[float]) -> np.ndarray:
    """‖A x_i − θ_i x_i‖₂ / max(1,|θ_i|) — the exact check used by tests
    and chip_smoke.py (one extra operator pass)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=op.device)
    ax = op.matmat(x)
    th = torch.as_tensor(np.asarray(theta), dtype=torch.float32,
                         device=op.device)
    r = ax - x * th[None, :]
    return (torch.linalg.norm(r, dim=0)
            / torch.clamp(torch.abs(th), min=1.0)).cpu().numpy()
