"""The plain reference of the eigen and singular-value cells.

Plain PyTorch in float64, built from the harness's own COO arrays (never
from the program's packed image), importing nothing of the program:

  * `PlainOperator`: A (and Aᵀ) as float64 CSR tensors;
  * `extreme_eigs`: the wanted end of the spectrum by restarted block
    Krylov with full reorthogonalization and Rayleigh–Ritz, iterated
    until every wanted Ritz pair's residual is at `REF_TOL` of its value:
    the eigenvalues that every solve is held to;
  * `judge_eig` / `judge_svd`: the numbers that decide `correct` for one
    solve's answer, measured on the plain operator: how far the returned
    values lie from the reference's (by magnitude for "LM"), the true
    residuals of the returned vectors, and their departure from
    orthonormality.

These graphs hold +1 and −1 many times over (one copy for each small
component), so a solve may return any orthonormal set of vectors in those
eigenspaces: the residuals and orthonormality hold each returned pair to
being an eigenpair of the plain operator, and the values to being the
wanted end of its spectrum, whichever copies were returned.

`extreme_eigs(..., work_dtype=torch.bfloat16)` is the control: the same
algorithm with every n-length vector rounded to bfloat16 after each
product.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

# a Ritz pair of the reference counts as converged at this residual, as a
# share of max(1, |θ|): far below any limit the judged numbers have
REF_TOL = 1e-10


class PlainOperator:
    """A as a float64 CSR tensor on `device`, from COO arrays; `t=True`
    also keeps Aᵀ."""

    def __init__(self, n: int, rows, cols, vals, device, *, t: bool = False):
        self.n = n
        self.device = torch.device(device)
        r = torch.as_tensor(np.asarray(rows), device=self.device).long()
        c = torch.as_tensor(np.asarray(cols), device=self.device).long()
        v = torch.as_tensor(np.asarray(vals), device=self.device).double()
        self.a = self._csr(r, c, v)
        self.at = self._csr(c, r, v) if t else None

    def _csr(self, r, c, v):
        order = torch.argsort(r * self.n + c)
        r, c, v = r[order], c[order], v[order]
        crow = torch.zeros(self.n + 1, dtype=torch.int64, device=self.device)
        crow[1:] = torch.cumsum(torch.bincount(r, minlength=self.n), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # "CSR support is in beta"
            return torch.sparse_csr_tensor(crow, c, v, (self.n, self.n),
                                           check_invariants=False)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.a @ x

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        """AᵀA x."""
        return self.at @ (self.a @ x)

    def cogram(self, x: torch.Tensor) -> torch.Tensor:
        """AAᵀ x."""
        return self.a @ (self.at @ x)


def _order(theta: np.ndarray, which: str) -> np.ndarray:
    if which == "LM":
        return np.argsort(-np.abs(theta), kind="stable")
    if which == "LA":
        return np.argsort(-theta, kind="stable")
    raise ValueError(f"unknown which {which!r}")


def _orthonormal(w: torch.Tensor, q: torch.Tensor | None) -> torch.Tensor:
    for _ in range(2):
        if q is not None:
            w = w - q @ (q.T @ w)
        w, _ = torch.linalg.qr(w)
    return w


def extreme_eigs(apply, n: int, k: int, which: str, device, *,
                 seed: int = 0, block: int = 32, steps: int = 8,
                 max_cycles: int = 40, work_dtype=torch.float64,
                 x0: torch.Tensor | None = None):
    """The k wanted eigenpairs of the symmetric operator `apply` (a
    function of an (n, j) float64 tensor), by restarted block Krylov:
    [X, AX, ..., A^steps X] orthonormalized, Rayleigh–Ritz, X ← the
    `block` best Ritz vectors. Returns (θ, X, residuals, cycles) with θ
    in wanted order. With `work_dtype` below float64 every n-length
    vector is rounded to it after each product (the control)."""
    dev = torch.device(device)

    def rnd(t):
        return t if work_dtype == torch.float64 else \
            t.to(work_dtype).to(torch.float64)

    if x0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        x0 = torch.randn((n, block), generator=gen, dtype=torch.float64,
                         device=dev)
    x = rnd(_orthonormal(x0.to(dev, torch.float64), None))
    theta = res = None
    for cycle in range(1, max_cycles + 1):
        basis = [x]
        for _ in range(steps):
            q = torch.cat(basis, 1)
            basis.append(rnd(_orthonormal(rnd(apply(basis[-1])), q)))
        q = torch.cat(basis, 1)
        aq = rnd(apply(q))
        h = (q.T @ aq).cpu().numpy()
        th, y = np.linalg.eigh(0.5 * (h + h.T))
        order = _order(th, which)[:block]
        theta = th[order]
        yt = torch.as_tensor(y[:, order], dtype=torch.float64, device=dev)
        x, ax = rnd(q @ yt), rnd(aq @ yt)
        del q, aq, basis
        th_t = torch.as_tensor(theta, dtype=torch.float64, device=dev)
        res = (torch.linalg.norm(ax - x * th_t, dim=0)
               / torch.clamp(th_t.abs(), min=1.0)).cpu().numpy()
        if work_dtype == torch.float64 and np.all(res[:k] <= REF_TOL):
            break
        if work_dtype != torch.float64 and cycle >= 4:
            break
        x = rnd(_orthonormal(x, None))
    return theta[:k], x[:, :k], res[:k], cycle


def _orth_error(x64: torch.Tensor) -> float:
    g = x64.T @ x64
    return float((g - torch.eye(g.shape[0], dtype=g.dtype,
                                device=g.device)).abs().max())


def _as_f64(x: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).double()


def judge_eig(op: PlainOperator, theta, x, ref_theta, which: str) -> dict:
    """One eigen solve's answer (θ, X) against the plain operator and the
    reference's eigenvalues: {"value_gap", "residual", "orthogonality"}."""
    theta = np.asarray(theta, np.float64)
    x64 = _as_f64(x, op.device)
    th = torch.as_tensor(theta, dtype=torch.float64, device=op.device)
    resid = (torch.linalg.norm(op.matmat(x64) - x64 * th, dim=0)
             / torch.linalg.norm(x64, dim=0)
             / torch.clamp(th.abs(), min=1.0))
    key = np.abs if which == "LM" else (lambda t: t)
    got = np.sort(key(theta))[::-1]
    want = np.sort(key(np.asarray(ref_theta, np.float64)))[::-1]
    gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    return {"value_gap": float(gap.max()),
            "residual": float(resid.max()),
            "orthogonality": _orth_error(x64)}


def judge_svd(op: PlainOperator, sigma, u, ref_sigma) -> dict:
    """One SVD solve's answer (σ, U) against the plain operator and the
    reference's singular values: U's columns as eigenvectors of AAᵀ with
    eigenvalues σ², {"value_gap", "residual", "orthogonality"}."""
    sigma = np.asarray(sigma, np.float64)
    u64 = _as_f64(u, op.device)
    lam = torch.as_tensor(sigma ** 2, dtype=torch.float64, device=op.device)
    resid = (torch.linalg.norm(op.cogram(u64) - u64 * lam, dim=0)
             / torch.linalg.norm(u64, dim=0)
             / torch.clamp(lam, min=1.0))
    got = np.sort(sigma)[::-1]
    want = np.sort(np.asarray(ref_sigma, np.float64))[::-1]
    gap = np.abs(got - want) / np.maximum(1.0, want)
    return {"value_gap": float(gap.max()),
            "residual": float(resid.max()),
            "orthogonality": _orth_error(u64)}


def reference_values(op: PlainOperator, k: int, kind: str, device, *,
                     seed: int = 0):
    """The reference's k wanted values: eigenvalues of A by magnitude
    ("eig"), or singular values of A ("svd", from AᵀA), with the largest
    reference residual and the cycles it took."""
    if kind == "eig":
        theta, _, res, cycles = extreme_eigs(op.matmat, op.n, k, "LM",
                                             device, seed=seed)
        return theta, float(res.max()), cycles
    lam, _, res, cycles = extreme_eigs(op.gram, op.n, k, "LA", device,
                                       seed=seed)
    return np.sqrt(np.maximum(lam, 0.0)), float(res.max()), cycles


def control_answer(op: PlainOperator, k: int, kind: str, x0, *,
                   work_dtype=torch.bfloat16):
    """The reference put in the program's place at a lower precision: from
    a solve's start block x0, the k wanted values and vectors with every
    n-length vector rounded to `work_dtype` ((θ, X) for "eig", (σ, U) for
    "svd", U = A V / σ rounded likewise)."""
    dev = op.device
    x0 = torch.as_tensor(x0, device=dev).double()
    block = max(32, x0.shape[1])
    if x0.shape[1] < block:
        gen = torch.Generator(device=dev).manual_seed(0)
        x0 = torch.cat([x0, torch.randn((op.n, block - x0.shape[1]),
                                        generator=gen, dtype=torch.float64,
                                        device=dev)], 1)
    if kind == "eig":
        theta, x, _, _ = extreme_eigs(op.matmat, op.n, k, "LM", dev, x0=x0,
                                      work_dtype=work_dtype)
        return theta, x
    lam, v, _, _ = extreme_eigs(op.gram, op.n, k, "LA", dev, x0=x0,
                                work_dtype=work_dtype)
    sigma = np.sqrt(np.maximum(lam, 0.0))
    s = torch.as_tensor(sigma, dtype=torch.float64, device=dev)
    u = (op.matmat(v) / s).to(work_dtype).to(torch.float64)
    return sigma, u
