"""Block Krylov–Schur (thick-restart) eigensolver — the paper's driver.

Port of `repro.core.krylov_schur`. For symmetric operators Krylov–Schur
reduces to thick-restart block Lanczos: maintain

    A V = V H + Q S eᵀ_last-block ,   H = Vᵀ A V  (symmetric, m×m)

expand the subspace block by block (semi-external SpMM + out-of-core
CGS2), and at m = b·NB restart by compressing V onto the k best Ritz
vectors (`MultiVector.compress`), with H collapsing to diag(θ).

H, its eigendecomposition and the Ritz bookkeeping stay in float64 numpy
on the host, as in the reference; every n-row operation runs on the
store's device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.multivector import MultiVector
from repro_torch.core.operator import CAP_FUSED_EXPAND, capabilities
from repro_torch.core.ortho import bcgs2, cholqr
from repro_torch.core.residuals import EigResult, sort_ritz
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops


def _expand(op, v: MultiVector, q: torch.Tensor, h: np.ndarray,
            impl: kops.Impl, *, fused_passes: bool = True
            ) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """One block expansion. Appends q to V; returns (q_next, new H,
    R_next), with the Krylov invariant A·q = V·h + q_next·r and
    h = h1 + h2 (the bcgs2 convention). Two paths, as in the reference:

      * local: semi-external SpMM then `ortho.bcgs2` over the out-of-core
        subspace (two streamed reads of V when fused_passes, four when
        not);
      * operator-fused (declares the `fused_expand` capability, e.g. the
        sharded `dist.DistOperator`): one combined SpMM+CGS2/CholQR2 step
        over the operator's own subspace shards — V's blocks are not
        re-read from the store unless the operator rebuilds its stack;
        the MultiVector is the spill/restart copy.
    """
    b = q.shape[1]
    v.append_block(q)
    if CAP_FUSED_EXPAND in capabilities(op):
        q_next, h_col, r_next = op.fused_expand(v, q)
    else:
        w = op.matmat(q)                               # semi-external SpMM
        q_next, h_col, r_next = bcgs2(v, w, impl=impl, fused=fused_passes)

    m_old = h.shape[0]
    m_new = m_old + b
    h_new = np.zeros((m_new, m_new), dtype=np.float64)
    h_new[:m_old, :m_old] = h
    col = h_col.double().cpu().numpy()
    h_new[:, m_old:] = col
    h_new[m_old:, :] = col.T                            # enforce symmetry
    return q_next, h_new, r_next.double().cpu().numpy()


def _start_block(store: TieredStore, n: int, b: int, seed: int,
                 x0=None) -> torch.Tensor:
    """The (n, b) float32 start block on the store's device: `x0` when
    given, else a standard normal draw from a `torch.Generator` seeded
    with `seed` on that device. (The reference draws with `jax.random`,
    which torch cannot reproduce; a parity test passes that draw as x0.)"""
    if x0 is None:
        gen = torch.Generator(device=store.device).manual_seed(seed)
        return torch.randn((n, b), generator=gen, dtype=torch.float32,
                           device=store.device)
    x0 = store.as_tensor(x0).float().contiguous()
    if tuple(x0.shape) != (n, b):
        raise ValueError(f"x0 is {tuple(x0.shape)}, expected ({n}, {b})")
    return x0


def eigsh(op, nev: int, *, block_size: int = 4, num_blocks: int | None = None,
          tol: float = 1e-6, max_restarts: int = 60, which: str = "LM",
          store: TieredStore | None = None, impl: kops.Impl = "auto",
          group_size: int = 8, seed: int = 0,
          compute_eigenvectors: bool = True, fused_passes: bool = True,
          callback: Callable | None = None, checkpointer=None,
          x0=None) -> EigResult:
    """Compute `nev` eigenpairs of a symmetric LinearOperator.

    Defaults follow the paper's parameter study (§4.3): block size b,
    num_blocks NB with subspace m = b·NB; NB defaults to 2·ceil(nev/b)+2.

    x0: an explicit (n, b) start block, orthonormalized by CholQR² as the
    reference orthonormalizes its own draw. Without it the start block is
    drawn from a `torch.Generator` seeded with `seed` on the store's
    device. (The reference draws with `jax.random`, which torch cannot
    reproduce; a parity test passes the reference's draw as x0.)

    The store defaults to a `TieredStore` on the operator's device.

    checkpointer: a `ckpt.solver.SolveCheckpointer` (normally built by
    `core.solver.solve(..., checkpoint=/resume=)`). Snapshots land at
    restart boundaries — right after thick-restart compression, when the
    live state is exactly the compressed subspace plus H = diag(θ), q and
    r_next (restart compression IS the checkpoint compression, §3.4).
    Resume restores that state bit-identically and continues at the next
    restart index; it ignores `x0`.
    """
    b = block_size
    if num_blocks is None:
        num_blocks = 2 * (-(-nev // b)) + 2
    num_blocks = max(num_blocks, -(-nev // b) + 2)
    m_max = b * num_blocks
    keep_blocks = max(-(-nev // b) + 1, num_blocks // 2)
    k_keep = min(keep_blocks * b, m_max - b)

    store = store or TieredStore(device=getattr(op, "device", None))
    dev = store.device
    n = op.n

    resume = checkpointer.load(store) if checkpointer is not None else None
    if resume is not None:
        # bit-identical continuation from the last committed restart
        # boundary: same subspace blocks, same H/q/r_next, same counters
        v = resume.mvs["v"]
        h = np.asarray(resume.arrays["h"], np.float64)
        q = store.as_tensor(resume.arrays["q"]).float()
        r_next = np.asarray(resume.arrays["r_next"], np.float64)
        theta_out = np.asarray(resume.arrays["theta_out"], np.float64)
        res_out = np.asarray(resume.arrays["res_out"], np.float64)
        n_ops = int(resume.extra["n_ops"])
        start_restart = resume.step
    else:
        q, _ = cholqr(_start_block(store, n, b, seed, x0), impl=impl)
        v = MultiVector(store, n, group_size=group_size, impl=impl)
        h = np.zeros((0, 0), dtype=np.float64)
        r_next = np.zeros((b, b), dtype=np.float64)
        n_ops = 0
        theta_out = np.zeros(nev)
        res_out = np.full(nev, np.inf)
        start_restart = 0
    converged = False
    restarts = start_restart

    for restarts in range(start_restart, max_restarts):
        while v.ncols + b <= m_max:
            q, h, r_next = _expand(op, v, q, h, impl,
                                   fused_passes=fused_passes)
            n_ops += 1

        # --- restart: Rayleigh-Ritz on H ---------------------------------
        theta, y = np.linalg.eigh(h)
        order = sort_ritz(theta, which)
        theta, y = theta[order], y[:, order]

        # residual bounds via the coupling S = R_next · y[last block rows]
        s = r_next @ y[-b:, :]
        res = np.linalg.norm(s, axis=0)
        scale = np.maximum(1.0, np.abs(theta))
        ok = res <= tol * scale
        theta_out = theta[:nev].copy()
        res_out = res[:nev].copy()
        if callback is not None:
            callback(restarts, theta_out.copy(), res_out.copy())
        if bool(ok[:nev].all()):
            converged = True
            break

        # --- thick restart: compress V onto k best Ritz vectors ----------
        yk = torch.as_tensor(y[:, :k_keep], dtype=torch.float32, device=dev)
        v_new = v.compress(yk, [b] * (k_keep // b), fused=fused_passes)
        v.delete()
        v = v_new
        h = np.diag(theta[:k_keep])

        if checkpointer is not None:
            # restart boundary = snapshot point; may raise SolveSuspended
            # after committing on preemption
            checkpointer.maybe_checkpoint(store, restarts + 1, lambda: {
                "mvs": {"v": v},
                "arrays": {"h": h, "q": q, "r_next": r_next,
                           "theta_out": theta_out, "res_out": res_out},
                "extra": {"n_ops": n_ops}})

    # --- materialize Ritz vectors: one more streamed pass ----------------
    vec = None
    if compute_eigenvectors:
        theta_full, y_full = np.linalg.eigh(h)
        order = sort_ritz(theta_full, which)
        yk = torch.as_tensor(y_full[:, order[:nev]], dtype=torch.float32,
                             device=dev)
        vec = v.mv_times_mat(yk)

    return EigResult(
        eigenvalues=theta_out, eigenvectors=vec, residuals=res_out,
        n_restarts=restarts, n_ops=n_ops, m_subspace=m_max,
        converged=converged, io_stats=store.stats.as_dict(),
        resumed_step=(checkpointer.resumed_step
                      if checkpointer is not None else None))
