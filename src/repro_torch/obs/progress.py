"""Restart telemetry → convergence events + ETA from residual decay
(a copy of `repro.obs.progress`).

Every solver in the family already exposes `callback(step, theta, res)`
(per restart for Krylov–Schur/svd, per iteration for LOBPCG, per
expansion for the Lanczos baseline). `ConvergenceTracker` consumes that
stream, records the theta/residual history, and emits one
"convergence.step" instant event per call into the installed tracer —
giving the exported timeline the third axis the ROADMAP's serving layer
needs: not just *where the time went* but *how far along the solve is*.

The ETA estimator assumes geometric residual decay — the right model for
a restarted Krylov method past its initial transient: the worst relative
residual r_k shrinks by a roughly constant factor per restart, so

    steps_remaining ≈ log(tol / r_k) / log(rho),

with rho the geometric-mean decay of the last `window` steps. Stagnation
(rho >= 1) and the pre-transient phase report no estimate rather than a
wrong one.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


class ConvergenceTracker:
    """Feed `update(step, theta, res)` (the solver callback signature);
    reads back `history`, `eta_steps()`, and emits tracer events."""

    def __init__(self, tracer=None, *, tol: float = 1e-6, nev: int = 0,
                 method: str = "", window: int = 4):
        self.tracer = tracer
        self.tol = float(tol)
        self.nev = int(nev)
        self.method = method
        self.window = max(2, int(window))
        self.history: List[Tuple[int, float]] = []   # (step, worst rel res)
        self.theta_history: List[np.ndarray] = []

    # ------------------------------------------------------------- intake
    def update(self, step: int, theta, res) -> None:
        theta = np.asarray(theta, dtype=np.float64)
        res = np.asarray(res, dtype=np.float64)
        scale = np.maximum(1.0, np.abs(theta))
        finite = np.isfinite(res)
        rel = np.where(finite, res / scale, np.inf)
        r = float(np.max(rel)) if rel.size else math.inf
        self.history.append((int(step), r))
        self.theta_history.append(theta.copy())
        if self.tracer is not None:
            eta = self.eta_steps()
            self.tracer.event(
                "convergence.step", step=int(step), method=self.method,
                nev=self.nev, theta=theta.tolist(),
                res=[None if not np.isfinite(x) else float(x)
                     for x in res.tolist()],
                res_max_rel=None if math.isinf(r) else r,
                tol=self.tol, eta_steps=eta)

    # ---------------------------------------------------------- estimator
    def decay_rate(self) -> Optional[float]:
        """Geometric-mean per-step decay of the worst relative residual
        over the trailing window; None until two finite points exist."""
        pts = [(s, r) for s, r in self.history
               if math.isfinite(r) and r > 0.0]
        if len(pts) < 2:
            return None
        tail = pts[-self.window:]
        (s0, r0), (s1, r1) = tail[0], tail[-1]
        if s1 <= s0 or r0 <= 0.0:
            return None
        return (r1 / r0) ** (1.0 / (s1 - s0))

    def eta_steps(self) -> Optional[int]:
        """Estimated steps until the worst residual crosses tol, or None
        when no defensible estimate exists (stagnation, transient)."""
        if not self.history:
            return None
        r = self.history[-1][1]
        if not math.isfinite(r):
            return None
        if r <= self.tol:
            return 0
        rho = self.decay_rate()
        if rho is None or rho >= 1.0 or rho <= 0.0:
            return None
        return int(math.ceil(math.log(self.tol / r) / math.log(rho)))

    def chain(self, user_callback=None):
        """The callback to hand a solver: updates this tracker, then
        forwards to `user_callback` unchanged."""
        def cb(step, theta, res):
            self.update(step, theta, res)
            if user_callback is not None:
                user_callback(step, theta, res)
        return cb
