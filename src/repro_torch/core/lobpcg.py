"""Block LOBPCG on the streamed-pass substrate — the other Anasazi-family
solver (paper §2, and the one Zhou et al. [31] ran on SSD clusters).

Port of `repro.core.lobpcg`. Locally-optimal block preconditioned
conjugate gradient: the subspace per iteration is span[X, W, P] (Ritz
block, preconditioned residuals, search directions) — only 3·b basis
vectors, no growing Krylov history. The opposite I/O trade from
Krylov–Schur: no restart compression and no history to reorthogonalize
against, but the operator is applied every iteration and the whole
[X, W, P] basis (plus its A-images) streams from the slow tier several
times per iteration.

Out-of-core layout: two 3-block MultiVectors hold the basis S = [X, W, P]
and its images AS = [AX, AW, AP]; every block is written through to the
slow tier immediately (`_put_spilled` = write + demote), so the pass
accounting below is byte-exact on any device budget. A-images are
maintained algebraically — every linear transform applied to a basis
block is co-applied to its image (`ortho.svqb_transform`) — so the
operator runs exactly once per iteration (on W).

Streamed passes per iteration (fused_passes=True), B = n·b·4 bytes:

  residual pass   reads X ⊕ AX                 (2 blocks, 2B)
  gram pass       reads [X, W (, P)] ⊕ images  (4B at it 0, else 6B)
                  → inline P deflation (ortho vs X, W + SVQB, transforms
                    co-applied to AP, write-back), then G = SᵀS, H = SᵀAS
  update pass     reads the same blocks        (4B / 6B)
                  → four accumulators in one read: X' = S·y_x,
                    P' = S·y_p, AX' = AS·y_x, AP' = AS·y_p

so a run that converges at iteration `it` (the check fires after the
residual pass; it ≥ 1) costs exactly

  passes     = 3·it + 1
  pass bytes = (10 + 14·(it − 1) + 2) · B

unless P fully deflates in some iteration, which drops the 2B P⊕AP share
of that iteration's gram and update passes. fused_passes=False splits
every consumer into its own single-consumer pass: 8 passes and 29B per
full iteration — the unfused reference for parity tests and I/O benches.

On the card each iteration launches the gram kernel (deflation, W's
projection, SVQB, G and H), the tsgemm kernel (the projections, the SVQB
transforms and the four update accumulators) and the SpMM kernel (A·W).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.krylov_schur import _start_block
from repro_torch.core.multivector import MultiVector
from repro_torch.core.ortho import svqb, svqb_transform
from repro_torch.core.residuals import EigResult
from repro_torch.core.stream import SubspacePass
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops


def _put_spilled(mv: MultiVector, i: int, arr: torch.Tensor) -> None:
    """Write block i (append when it doesn't exist yet) and immediately
    demote it: the basis lives on "SSD", every pass read is a host read,
    and the module-docstring pass accounting holds on any device budget."""
    if i < mv.nblocks:
        mv.set_block(i, arr)
    else:
        if i != mv.nblocks:
            raise ValueError(f"block {i} appended to {mv.nblocks} blocks")
        mv.append_block(arr, pin_recent=False)
    mv.store.demote(mv._block_name(i))


def _rayleigh_ritz(g: np.ndarray, h: np.ndarray, which: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense RR on the [X W P] Grams (m ≤ 3b): the generalized symmetric
    problem H y = G y θ via Cholesky whitening with an escalating-jitter
    ladder (the basis is deflated, but can still be borderline near
    convergence). Float64 numpy on the host, as in the reference."""
    h = 0.5 * (h + h.T)
    tr = np.trace(g) / g.shape[0]
    l = None
    for jitter in (1e-10, 1e-7, 1e-4, 1e-2):
        try:
            l = np.linalg.cholesky(g + jitter * tr * np.eye(g.shape[0]))
            break
        except np.linalg.LinAlgError:
            continue
    if l is None:
        raise np.linalg.LinAlgError("RR basis numerically singular")
    linv = np.linalg.inv(l)
    hw = linv @ h @ linv.T
    theta, z = np.linalg.eigh(0.5 * (hw + hw.T))
    y = linv.T @ z
    order = np.argsort(-theta) if which == "LA" else np.argsort(theta)
    return theta[order], y[:, order]


def _deflate_p(x, ax, w, aw, p, ap, impl
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Orthogonalize P against X and W, then SVQB; every transform is
    co-applied to AP so the image stays exact with zero operator applies.
    Returns (None, None) when P is numerically rank deficient after
    deflation — the caller drops P from this iteration's basis."""
    c = kops.gram(x, p, impl=impl)
    p = kops.tsgemm(x, c, alpha=-1.0, beta=1.0, c0=p, impl=impl)
    ap = kops.tsgemm(ax, c, alpha=-1.0, beta=1.0, c0=ap, impl=impl)
    c = kops.gram(w, p, impl=impl)
    p = kops.tsgemm(w, c, alpha=-1.0, beta=1.0, c0=p, impl=impl)
    ap = kops.tsgemm(aw, c, alpha=-1.0, beta=1.0, c0=ap, impl=impl)
    t, rank = svqb_transform(p, impl=impl)
    if rank < p.shape[1]:
        return None, None
    return kops.tsgemm(p, t, impl=impl), kops.tsgemm(ap, t, impl=impl)


def _grams(s_mat: torch.Tensor, as_mat: torch.Tensor, impl
           ) -> Tuple[np.ndarray, np.ndarray]:
    """G = SᵀS and H = SᵀAS in float64 on the host."""
    g = kops.gram(s_mat, s_mat, impl=impl).double().cpu().numpy()
    h = kops.gram(s_mat, as_mat, impl=impl).double().cpu().numpy()
    return g, h


def _gram_fused(s, a_s, have_p, impl) -> Tuple[np.ndarray, np.ndarray, bool]:
    """One multi-consumer streamed pass: basis blocks and their images
    (peers, lockstep) stream once; the P visit deflates the search
    directions in place (write-back via `_put_spilled`), then G and H
    assemble from the pass's materialized blocks. The 3+3 block working
    set stays device-resident for the pass — the LOBPCG memory model."""
    held: List[Tuple[torch.Tensor, torch.Tensor]] = []
    gp = SubspacePass(s, peers=[a_s],
                      block_ids=[0, 1, 2] if have_p else [0, 1])

    def visit(i, blk, peers):
        img = peers[0]
        if i == 2:
            (x, ax), (w, aw) = held[0], held[1]
            blk, img = _deflate_p(x, ax, w, aw, blk, img, impl)
            if blk is None:
                return
            _put_spilled(s, 2, blk)
            _put_spilled(a_s, 2, img)
        held.append((blk, img))

    gp.add_visit(visit, axis=None)
    gp.run()
    g, h = _grams(torch.cat([t[0] for t in held], dim=1),
                  torch.cat([t[1] for t in held], dim=1), impl)
    return g, h, len(held) == 3


def _gram_unfused(s, a_s, have_p, impl
                  ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Same results as `_gram_fused` as single-consumer passes: a
    deflation walk (write-back), a basis walk for G, a basis⊕image walk
    for H — three subspace reads where the fused pass pays one."""
    use_p = have_p
    if have_p:
        held: List = []
        dp = SubspacePass(s, peers=[a_s], block_ids=[0, 1, 2])

        def deflate(i, blk, peers):
            if i < 2:
                held.append((blk, peers[0]))
                return
            p, ap = _deflate_p(held[0][0], held[0][1], held[1][0],
                               held[1][1], blk, peers[0], impl)
            held.append(p)
            if p is not None:
                _put_spilled(s, 2, p)
                _put_spilled(a_s, 2, ap)

        dp.add_visit(deflate, axis=None)
        dp.run()
        use_p = held[2] is not None
    ids = [0, 1, 2] if use_p else [0, 1]

    g_pass = SubspacePass(s, block_ids=ids)
    hg = g_pass.add_visit(lambda i, blk, peers: blk, axis=1)
    g_pass.run()
    s_mat = hg.value
    g = kops.gram(s_mat, s_mat, impl=impl).double().cpu().numpy()

    h_pass = SubspacePass(s, peers=[a_s], block_ids=ids)
    hh = h_pass.add_visit(lambda i, blk, peers: (blk, peers[0]), axis=None)
    h_pass.run()
    sm = torch.cat([t[0] for t in hh.value], dim=1)
    am = torch.cat([t[1] for t in hh.value], dim=1)
    h = kops.gram(sm, am, impl=impl).double().cpu().numpy()
    return g, h, use_p


def _update_fused(s, a_s, y_x, y_p, ids, impl) -> List[torch.Tensor]:
    """One streamed read of basis⊕images filling four accumulators:
    X' = S·y_x, P' = S·y_p, AX' = AS·y_x, AP' = AS·y_p."""
    widths = s.block_widths()
    offs, off = {}, 0
    for i in ids:
        offs[i] = off
        off += widths[i]
    n, b = s.n, y_x.shape[1]
    accs = [torch.zeros((n, b), dtype=torch.float32, device=y_x.device)
            for _ in range(4)]
    up = SubspacePass(s, peers=[a_s], block_ids=ids)

    def visit(i, blk, peers):
        rows = slice(offs[i], offs[i] + widths[i])
        for j, (src, small) in enumerate(((blk, y_x), (blk, y_p),
                                          (peers[0], y_x), (peers[0], y_p))):
            accs[j] = kops.tsgemm(src, small[rows], beta=1.0, c0=accs[j],
                                  impl=impl)

    up.add_visit(visit, axis=None)
    up.run()
    return accs


def _update_unfused(s, a_s, y_x, y_p, ids, impl) -> List[torch.Tensor]:
    outs = []
    for mv, small in ((s, y_x), (s, y_p), (a_s, y_x), (a_s, y_p)):
        up = SubspacePass(mv, block_ids=ids)
        h = up.add_matmul(small)
        up.run()
        outs.append(h.value[0])
    return outs


def lobpcg(op, nev: int, *, block_size: int | None = None,
           tol: float = 1e-6, max_iters: int = 200, which: str = "LA",
           precond: Callable | None = None,
           store: TieredStore | None = None, seed: int = 0,
           impl: kops.Impl = "auto", fused_passes: bool = True,
           group_size: int = 8, stall_iters: int = 8,
           callback: Callable | None = None,
           checkpointer=None, x0=None) -> EigResult:
    """Compute `nev` eigenpairs by block LOBPCG with the [X, W, P] basis
    streamed from the TieredStore (pass accounting: module docstring).

    which: 'LA' (largest algebraic) or 'SA' (smallest). For interior or
    magnitude targets wrap the operator in a spectral transform
    (`ShiftInvertOperator` / `ChebyshevFilterOperator` via `solve`).

    impl defaults to "auto" here, where the reference defaults to "ref":
    the one deliberate difference in a default. In the port "ref" forces
    the plain versions even on CUDA tensors, so the reference's default
    would run a direct call on the card without a kernel; "auto" takes
    the plain versions on CPU tensors, as "ref" does.

    stall_iters: stagnation guard. The f32 residual floor can sit above
    `tol`; after `stall_iters` iterations without residual improvement
    the loop exits (converged=False unless `tol` was met) and the best
    iterate seen — not the last — is returned.

    callback(it, theta[:nev], res[:nev]) fires once per iteration right
    after the residual pass.

    x0: an explicit (n, b) start block, orthonormalized by SVQB as the
    reference orthonormalizes its own draw; without it the start block is
    drawn from a `torch.Generator` seeded with `seed` on the store's
    device.

    checkpointer: a `ckpt.solver.SolveCheckpointer` (normally built by
    `core.solver.solve(..., checkpoint=/resume=)`). LOBPCG has no
    restarts, so the snapshot boundary is the end of an iteration: the
    whole live state is the two 3-block MultiVectors S = [X, W, P] and
    AS (already spilled to the slow tier by `_put_spilled`) plus the
    Ritz values, residual norms, best-iterate tracker and a few flags.
    Resume ignores `x0`.
    """
    if which not in ("LA", "SA"):
        raise ValueError(f"lobpcg supports which='LA'|'SA', got {which!r}")
    b = block_size or nev
    if b < nev:
        raise ValueError(f"block_size {b} < nev {nev}")
    store = store or TieredStore(device=getattr(op, "device", None))
    dev = store.device
    n = op.n

    resume = checkpointer.load(store) if checkpointer is not None else None
    if resume is not None:
        # the next iteration's residual pass re-reads X ⊕ AX from the
        # restored blocks, so x/ax need no separate restore; the best-
        # iterate tracker continues where it stopped
        s = resume.mvs["s"]
        a_s = resume.mvs["a_s"]
        theta = np.asarray(resume.arrays["theta"], np.float64)
        res_norms = np.asarray(resume.arrays["res_norms"], np.float64)
        best_x = store.as_tensor(resume.arrays["best_x"]).float()
        best_theta = np.asarray(resume.arrays["best_theta"], np.float64)
        best_res = np.asarray(resume.arrays["best_res"], np.float64)
        n_ops = int(resume.extra["n_ops"])
        have_p = bool(resume.extra["have_p"])
        stall = int(resume.extra["stall"])
        best = float(resume.extra["best"])
        x = best_x
        start_it = resume.step
    else:
        x, _ = svqb(_start_block(store, n, b, seed, x0), impl=impl)
        ax = op.matmat(x)
        n_ops = 1
        s = MultiVector(store, n, group_size=group_size, impl=impl)
        a_s = MultiVector(store, n, group_size=group_size, impl=impl)
        _put_spilled(s, 0, x)
        _put_spilled(a_s, 0, ax)
        have_p = False
        theta = np.zeros(b)
        res_norms = np.full(b, np.inf)
        best = np.inf
        stall = 0
        best_x, best_theta, best_res = x, theta[:nev], res_norms[:nev]
        start_it = 0
    converged = False
    it = start_it

    for it in range(start_it, max_iters):
        # --- residual pass: one streamed read of X ⊕ AX ------------------
        rp = SubspacePass(s, peers=[a_s], block_ids=[0])
        hr = rp.add_visit(lambda i, blk, peers: (blk, peers[0]), axis=None)
        rp.run()
        x, ax = hr.value[0]
        theta_f = torch.sum(x * ax, dim=0)      # Rayleigh (X orthonormal)
        theta = theta_f.double().cpu().numpy()
        r = ax - x * theta_f[None, :]           # f32 end to end
        res_norms = torch.linalg.norm(r, dim=0).double().cpu().numpy()
        scale = np.maximum(1.0, np.abs(theta))
        if callback is not None:
            callback(it, theta[:nev].copy(), res_norms[:nev].copy())
        cur = float(np.max(res_norms[:nev] / scale[:nev]))
        if cur < best * (1.0 - 1e-3):
            best, stall = cur, 0
            best_x = x
            best_theta = theta[:nev].copy()
            best_res = res_norms[:nev].copy()
        else:
            stall += 1
        if it > 0 and bool((res_norms[:nev] <= tol * scale[:nev]).all()):
            converged = True
            break
        if stall >= stall_iters:
            break               # f32 floor reached — stop before the noise
            # W blocks degrade the basis

        # --- residual block W: precondition, deflate vs X, renormalize ---
        w = precond(r) if precond is not None else r
        w = kops.tsgemm(x, kops.gram(x, w, impl=impl), alpha=-1.0,
                        beta=1.0, c0=w, impl=impl)
        w, _ = svqb(w, impl=impl)
        aw = op.matmat(w)                       # the only operator apply
        n_ops += 1
        _put_spilled(s, 1, w)
        _put_spilled(a_s, 1, aw)

        # --- gram pass: P deflation + G = SᵀS, H = SᵀAS ------------------
        gram = _gram_fused if fused_passes else _gram_unfused
        g, h, use_p = gram(s, a_s, have_p, impl)

        theta_all, y = _rayleigh_ritz(g, h, which)
        y_x = y[:, :b]
        y_p = y_x.copy()
        y_p[:b, :] = 0.0        # the search direction is the (W, P) share
        # contiguous: the update pass hands row slices to tsgemm
        y_x = torch.as_tensor(np.ascontiguousarray(y_x),
                              dtype=torch.float32, device=dev)
        y_p = torch.as_tensor(y_p, dtype=torch.float32, device=dev)

        # --- update pass: four accumulators from one read ----------------
        ids = [0, 1, 2] if use_p else [0, 1]
        upd = _update_fused if fused_passes else _update_unfused
        x, p_new, ax, ap_new = upd(s, a_s, y_x, y_p, ids, impl)
        # X' = S·y_x is G-orthonormal by RR construction; re-running SVQB
        # here would rotate the Ritz columns into mixtures (see the
        # reference's note)
        _put_spilled(s, 0, x)
        _put_spilled(a_s, 0, ax)
        _put_spilled(s, 2, p_new)
        _put_spilled(a_s, 2, ap_new)
        have_p = True
        theta = theta_all[:b]

        if checkpointer is not None:
            # iteration boundary = snapshot point; may raise
            # SolveSuspended after committing on preemption
            checkpointer.maybe_checkpoint(store, it + 1, lambda: {
                "mvs": {"s": s, "a_s": a_s},
                "arrays": {"theta": np.asarray(theta, np.float64),
                           "res_norms": res_norms, "best_x": best_x,
                           "best_theta": best_theta, "best_res": best_res},
                "extra": {"n_ops": n_ops, "have_p": have_p,
                          "stall": stall, "best": float(best)}})

    if converged:
        vec, lam, rn = x[:, :nev], theta[:nev], res_norms[:nev]
    else:                       # stall / max_iters: best iterate, not last
        vec, lam, rn = best_x[:, :nev], best_theta, best_res
    return EigResult(
        eigenvalues=np.asarray(lam), eigenvectors=vec.contiguous(),
        residuals=np.asarray(rn), n_restarts=it, n_ops=n_ops,
        m_subspace=3 * b, converged=converged,
        io_stats=store.stats.as_dict(),
        resumed_step=(checkpointer.resumed_step
                      if checkpointer is not None else None))
