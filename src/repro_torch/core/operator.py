"""LinearOperator — matrix-free "multiply a TAS block by A".

Port of `repro.core.operator`: `capabilities`, `GraphOperator` (with the
SSD-streamed image), `NormalOperator` (AᵀA for the SVD of directed
graphs), `DenseOperator`, and the composable spectral transforms every
solver of the family inherits through the same `matmat` seam:

  ShiftInvertOperator     (A − σI)⁻¹ via an inner blocked CG/CGNR on the
                          wrapped operator's matmat;
  ChebyshevFilterOperator p(A) with p a Chebyshev polynomial damping a
                          measured spectral interval
                          (`estimate_spectral_range`).

`HvpOperator` is the Hessian of a loss over a model's parameters (the
curvature spectrum, `examples/curvature_spectrum.py`).

Operators declare what they can do through `capabilities()`; solvers
dispatch on the declared set instead of sniffing attributes. Every
operator has the `device` its matmat runs on.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Protocol, Tuple

import numpy as np
import torch

from repro_torch.core.tiered import HOST, TieredStore
from repro_torch.device import resolve_device
from repro_torch.graphs.tiles import TiledMatrix
from repro_torch.kernels import ops as kops
from repro_torch.kernels import spmm_tile
from repro_torch.kernels.spmm_ref import coo_spmm_ref
from repro_torch.obs import trace
from repro_torch.tree import tree_leaves, tree_map


class LinearOperator(Protocol):
    n: int  # problem size (rows of padded operand)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for a TAS block X (n, b)."""
        ...


#   CAP_FUSED_EXPAND        the operator runs one whole expansion step
#                           (SpMM + CGS2 + CholQR2) itself via
#                           `fused_expand(v, q)` — the sharded operator.
#   CAP_SPECTRAL_TRANSFORM  matmat applies f(A), not A.
CAP_FUSED_EXPAND = "fused_expand"
CAP_SPECTRAL_TRANSFORM = "spectral_transform"


def capabilities(op) -> frozenset:
    """The operator's declared capability set.

    Operators declare via a `capabilities` method (or attribute).
    Operators predating the protocol are adapted here, as in the
    reference: the legacy `supports_fused_expand` attribute is read in
    this function only, so call sites stay protocol-pure.
    """
    declared = getattr(op, "capabilities", None)
    if declared is not None:
        return frozenset(declared() if callable(declared) else declared)
    caps = set()
    if getattr(op, "supports_fused_expand", False):
        caps.add(CAP_FUSED_EXPAND)
    return frozenset(caps)


@dataclasses.dataclass
class _ImageSpan:
    """One streamed span of the matrix image: the dense blocks of block
    rows [br_lo, br_hi) live in the store under `name`; its index (block
    columns, rebased row_ptr, the SpMM work plan) stays on the device —
    the paper's split of §3.3.1 (matrix index in fast memory, edge tiles
    on SSD)."""
    name: str
    n_block_rows: int
    n_blocks: int
    block_cols: torch.Tensor
    row_ptr: torch.Tensor
    plan: spmm_tile.Plan


class GraphOperator:
    """Semi-external-memory SpMM operator over a TiledMatrix image.

    Two residency modes for the image, as in the reference:

      * default (stream_image=False): the dense blocks, their block
        columns, the block-row CSR `row_ptr` and the COO remainder are
        copied once to the operator's device and stay there. Every
        matmat accounts the whole image as one slow-tier read against
        the store, so the two packages' I/O counters agree;
      * stream_image=True (requires a store): the image really lives in
        the store's host tier, as read-only entries — block-row spans of
        about `image_chunk_bytes` of dense blocks
        (`TiledMatrix.chunk_block_rows`) and the COO triple as three
        entries. Every matmat walks the spans through
        `TieredStore.stream` (the readahead pool stages the next
        `image_readahead` spans) and runs the SpMM on each span as it
        arrives on the device. Each span's work plan is built once here
        with the whole image's `chunk`, so a span's heavy rows split
        exactly as in the resident plan, and a streamed matmat equals
        the resident one bit for bit. With `TieredStore(backend="safs")`
        subspace and matrix bytes traverse the same page cache.

    The dense part runs the `spmm_blocksparse` kernel on CUDA with the
    image's work plan (`spmm_tile.plan`); the COO side path is plain
    PyTorch (`coo_spmm_ref`, a segment sum whose `index_add_` uses
    atomics on CUDA, so its sum order, and the last bits of Y, change
    from run to run unless deterministic algorithms are on).

    The blocks keep the image's type, float32 or bf16 (numpy's `bfloat16`
    extension type, uploaded as its raw 16-bit words), as in the
    reference; matmat takes and returns float32 either way. `astype`
    makes the bf16 operator of an uploaded float32 image on its device.

    `device=None` takes the store's device, or the CUDA card when there
    is no store (raising when there is none). `symmetric` records whether
    the image is symmetric, as in the reference (`NormalOperator`'s
    factors are not); matmat does not read it.
    """

    _counter = 0

    def __init__(self, tm: TiledMatrix, *, store: TieredStore | None = None,
                 impl: kops.Impl = "auto", symmetric: bool = True,
                 stream_image: bool = False,
                 image_chunk_bytes: int = 4 << 20, image_readahead: int = 2,
                 name: str | None = None, device=None):
        if device is None and store is not None:
            device = store.device
        self.device = resolve_device(device)
        self.n = tm.shape[0]
        self.store = store
        self.impl = impl
        self.symmetric = symmetric
        self._image_bytes = tm.nbytes_image()
        self.stream_image = bool(stream_image)
        if self.stream_image:
            if store is None:
                raise ValueError("stream_image=True requires a TieredStore")
            self._init_streamed(tm, image_chunk_bytes, image_readahead, name)
            return
        dev = self.device
        self._blocks = kops.from_numpy(tm.blocks).to(dev)
        self._block_cols = torch.from_numpy(tm.block_cols).to(dev)
        self._row_ptr = torch.from_numpy(tm.row_ptr).to(dev)
        # the SpMM kernel's work plan: heavy block rows split over CTAs
        self._plan = spmm_tile.plan(self._row_ptr)
        self._coo = (torch.from_numpy(tm.coo_rows).to(dev),
                     torch.from_numpy(tm.coo_cols).to(dev),
                     torch.from_numpy(tm.coo_vals).to(dev))

    # ------------------------------------------------- SSD-streamed image
    def _init_streamed(self, tm: TiledMatrix, chunk_bytes: int,
                       readahead: int, name: str | None) -> None:
        GraphOperator._counter += 1
        self._name = name or f"Aimg{GraphOperator._counter}"
        self._bm = tm.block_shape[0]
        self._readahead = int(readahead)
        dev = self.device
        # the whole image's chunk: every span's heavy rows split as in the
        # resident plan, so the partial sums run in the same order
        chunk = spmm_tile.default_chunk(tm.nblocks, spmm_tile.sm_count(dev))
        self._spans: List[_ImageSpan] = []
        for k, (r0, r1, b0, b1) in enumerate(tm.chunk_block_rows(chunk_bytes)):
            sname = f"{self._name}/tiles/c{k}"
            # readonly: the streamed image has no per-span dirty tracking,
            # so writing through a span name must raise, not diverge
            self.store.put(sname, kops.from_numpy(tm.blocks[b0:b1]),
                           tier=HOST, readonly=True)
            row_ptr = torch.from_numpy(tm.row_ptr[r0:r1 + 1]
                                       - tm.row_ptr[r0]).to(dev)
            self._spans.append(_ImageSpan(
                name=sname, n_block_rows=r1 - r0, n_blocks=b1 - b0,
                block_cols=torch.from_numpy(tm.block_cols[b0:b1]).to(dev),
                row_ptr=row_ptr, plan=spmm_tile.plan(row_ptr, chunk=chunk)))
        self._has_coo = tm.coo_vals.size > 0
        if self._has_coo:
            for part in ("coo_rows", "coo_cols", "coo_vals"):
                self.store.put(f"{self._name}/{part}", getattr(tm, part),
                               tier=HOST, readonly=True)

    def _matmat_streamed(self, x: torch.Tensor) -> torch.Tensor:
        k = x.shape[1]
        parts: List[torch.Tensor] = []
        names = [c.name for c in self._spans]
        for c, blocks in zip(self._spans, self.store.stream(
                names, readahead=self._readahead)):
            if c.n_blocks == 0:          # span of empty block rows
                parts.append(torch.zeros((c.n_block_rows * self._bm, k),
                                         dtype=torch.float32,
                                         device=x.device))
                continue
            parts.append(kops.spmm_blocks(blocks, c.block_cols, c.row_ptr,
                                          x, impl=self.impl, plan=c.plan))
        y = (torch.cat(parts) if parts else
             torch.zeros((self.n, k), dtype=torch.float32, device=x.device))
        if self._has_coo:
            y = y + coo_spmm_ref(self.store.get(f"{self._name}/coo_rows"),
                                 self.store.get(f"{self._name}/coo_cols"),
                                 self.store.get(f"{self._name}/coo_vals"),
                                 x, self.n)
        return y

    def delete_image(self) -> None:
        """Drop the spilled image entries (streamed mode only)."""
        if not self.stream_image:
            return
        for c in self._spans:
            self.store.delete(c.name)
        if self._has_coo:
            for part in ("coo_rows", "coo_cols", "coo_vals"):
                self.store.delete(f"{self._name}/{part}")

    def astype(self, dtype: torch.dtype) -> "GraphOperator":
        """This operator over its blocks cast to `dtype` (round to nearest
        even, as numpy's bf16 `astype`) on its device: the operator that
        `GraphOperator` builds from the cast image, sharing this one's
        block columns, row_ptr, plan, COO side path and store, with no
        copy through the host. Its image bytes count the cast blocks.
        A streamed image is cast by building the operator anew."""
        if self.stream_image:
            raise ValueError("astype casts a resident image; build a "
                             "streamed operator from the cast TiledMatrix")
        op = copy.copy(self)
        op._blocks = self._blocks.to(dtype)
        op._image_bytes = self._image_bytes + (
            op._blocks.numel() * op._blocks.element_size()
            - self._blocks.numel() * self._blocks.element_size())
        return op

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="GraphOperator",
                        k=int(x.shape[1]), n=self.n,
                        streamed=self.stream_image,
                        bytes=self._image_bytes):
            if self.stream_image:   # reads counted by the store itself
                return self._matmat_streamed(x)
            if self.store is not None:  # account the matrix image stream
                self.store.account_read(self._image_bytes)
            y = kops.spmm_blocks(self._blocks, self._block_cols,
                                 self._row_ptr, x, impl=self.impl,
                                 plan=self._plan)
            rows, cols, vals = self._coo
            if vals.shape[0]:
                y = y + coo_spmm_ref(rows, cols, vals, x, self.n)
            return y


class DenseOperator:
    """Small dense operator (oracle in tests)."""

    def __init__(self, a, *, device=None):
        self.device = resolve_device(device)
        self.a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self.n = self.a.shape[0]

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="DenseOperator",
                        k=int(x.shape[1]), n=self.n):
            return self.a @ x


class NormalOperator:
    """AᵀA for the SVD of directed graphs. Requires the transpose image
    (packed once, offline — the paper builds both images too).

    Both images follow the streamed-image machinery: build via
    `from_tiles(..., stream_image=True)` to spill the forward and the
    transpose edge tiles into the page store, and `delete_image()` drops
    both spills when the solve is done."""

    def __init__(self, a_op: GraphOperator, at_op: GraphOperator):
        self.a = a_op
        self.at = at_op
        self.n = at_op.n
        self.device = at_op.device

    @classmethod
    def from_tiles(cls, tm_a: TiledMatrix, tm_at: TiledMatrix, *,
                   store: TieredStore | None = None,
                   impl: kops.Impl = "auto", stream_image: bool = False,
                   image_chunk_bytes: int = 4 << 20,
                   image_readahead: int = 2, name: str | None = None,
                   device=None) -> "NormalOperator":
        """Build both GraphOperators with the streamed-image configuration
        forwarded to each (the transpose image spills too)."""
        kw = dict(store=store, impl=impl, symmetric=False,
                  stream_image=stream_image,
                  image_chunk_bytes=image_chunk_bytes,
                  image_readahead=image_readahead, device=device)
        a_op = GraphOperator(tm_a, name=None if name is None else f"{name}/A",
                             **kw)
        at_op = GraphOperator(tm_at,
                              name=None if name is None else f"{name}/At",
                              **kw)
        return cls(a_op, at_op)

    @property
    def stream_image(self) -> bool:
        return self.a.stream_image or self.at.stream_image

    def delete_image(self) -> None:
        """Drop both operators' spilled images (streamed mode only)."""
        self.a.delete_image()
        self.at.delete_image()

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="NormalOperator",
                        k=int(x.shape[1]), n=self.n):
            return self.at.matmat(self.a.matmat(x))


class HvpOperator:
    """Matrix-free Hessian-vector product of `loss_fn(params)`.

    The parameters are flattened into one vector space in JAX's leaf
    order (`tree.tree_leaves`: dict keys sorted), so a vector has
    the reference's coordinates: n_logical of them, padded to n, a
    multiple of pad_to (the padding rows of x are ignored and come back
    zero). Each matmat runs the loss forward once and takes its gradient
    with a graph (`create_graph=True`); each column of the block is then
    one more backward through that gradient (reverse over reverse: the
    reference's `jax.jvp` of `jax.grad` gives the same Hessian, with
    another float32 rounding). Attention's second-order terms take the
    plain route (`kernels.ops._FlashAttentionGrad`); every first-order
    product launches the kernels on the card.

    `loss_fn` takes the parameter tree and returns a scalar; the tree's
    tensors live on `device` (the card unless `device="cpu"`)."""

    def __init__(self, loss_fn: Callable, params, *, pad_to: int = 8,
                 device=None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self._params = tree_map(
            lambda t: t.detach().to(self.device).requires_grad_(), params)
        self._leaves = tree_leaves(self._params)
        self._offsets = np.cumsum([0] + [t.numel() for t in self._leaves])
        self.n_logical = int(self._offsets[-1])
        self.n = -(-self.n_logical // pad_to) * pad_to

    def capabilities(self) -> frozenset:
        return frozenset()

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="HvpOperator",
                        k=int(x.shape[1]), n=self.n):
            x = x.to(self.device, torch.float32)
            hv = torch.zeros((self.n, x.shape[1]), dtype=torch.float32,
                             device=self.device)
            with torch.enable_grad():
                loss = self.loss_fn(self._params)
                grads = torch.autograd.grad(loss, self._leaves,
                                            create_graph=True)
                # a gradient without a graph is constant: its rows of Hv
                # stay zero
                live = [(i, g) for i, g in enumerate(grads)
                        if g.requires_grad]
                off = self._offsets
                for j in range(x.shape[1]):
                    vs = [x[off[i]:off[i + 1], j]
                          .reshape(self._leaves[i].shape)
                          .to(self._leaves[i].dtype) for i, _ in live]
                    cols = torch.autograd.grad(
                        [g for _, g in live], self._leaves, vs,
                        retain_graph=True, allow_unused=True)
                    for i, c in enumerate(cols):
                        if c is not None:
                            hv[off[i]:off[i + 1], j] = c.reshape(-1)
            return hv


# ---------------------------------------------------------------- transforms
def _rayleigh_eigenvalues(inner, vecs) -> np.ndarray:
    """λ_i = v_iᵀ A v_i / v_iᵀ v_i — recover original-operator eigenvalues
    from a transform's Ritz vectors (one extra inner matmat)."""
    v = torch.as_tensor(vecs, dtype=torch.float32, device=inner.device)
    av = inner.matmat(v)
    num = torch.sum(v * av, dim=0)
    den = torch.sum(v * v, dim=0)
    return (num / torch.clamp(den, min=1e-30)).double().cpu().numpy()


class ShiftInvertOperator:
    """(A − σI)⁻¹ as a LinearOperator: interior/smallest eigenpairs for the
    whole solver family through the matmat seam.

    Eigenvalues map as μ = 1/(λ − σ), so the λ nearest σ become the
    largest |μ| — run any solver with which="LM" on the transform.
    `untransform` maps Ritz values back (Rayleigh quotients on the inner
    operator when vectors are available).

    Each matmat solves (A − σI) Y = X blocked over the columns with an
    inner Krylov iteration on the wrapped operator's matmat:

      inner="cg"    plain conjugate gradients — requires the shifted
                    operator to be definite (σ outside the spectrum);
      inner="cgnr" (default) CG on the squared system
                    (A − σI)² Y = (A − σI) X — SPD for any σ that is not
                    exactly an eigenvalue, at two inner matmats per
                    iteration.

    The declared capability set is {spectral_transform} only: an inner
    operator's fused-expansion program computes A·q, not (A−σI)⁻¹·q, so
    the transform drops CAP_FUSED_EXPAND explicitly, as in the reference
    (solvers take the streamed bcgs2 path by protocol).
    `n_inner_iters` totals the inner CG iterations.
    """

    def __init__(self, inner, sigma: float, *, inner_solver: str = "cgnr",
                 cg_tol: float = 1e-8, cg_maxiter: int = 400):
        if inner_solver not in ("cg", "cgnr"):
            raise ValueError(f"inner_solver must be cg|cgnr, "
                             f"got {inner_solver!r}")
        self.inner = inner
        self.sigma = float(sigma)
        self.n = inner.n
        self.device = inner.device
        self.inner_solver = inner_solver
        self.cg_tol = float(cg_tol)
        self.cg_maxiter = int(cg_maxiter)
        self.n_inner_iters = 0      # total inner CG iterations (telemetry)

    def capabilities(self) -> frozenset:
        return frozenset({CAP_SPECTRAL_TRANSFORM})

    def _shifted(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner.matmat(x) - self.sigma * x

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="ShiftInvertOperator",
                        k=int(x.shape[1]), n=self.n,
                        inner=self.inner_solver) as sp:
            x = x.float()
            if self.inner_solver == "cg":
                apply_fn, rhs = self._shifted, x
            else:                               # CGNR: (A−σ)² y = (A−σ) x
                apply_fn = lambda v: self._shifted(self._shifted(v))  # noqa: E731,E501
                rhs = self._shifted(x)
            y, iters = _block_cg(apply_fn, rhs, tol=self.cg_tol,
                                 maxiter=self.cg_maxiter)
            self.n_inner_iters += iters
            sp.set(inner_iters=iters)
            return y

    def untransform(self, theta, vecs=None) -> np.ndarray:
        if vecs is not None:
            return _rayleigh_eigenvalues(self.inner, vecs)
        mu = np.asarray(theta, np.float64)
        safe = np.where(np.abs(mu) > 1e-300, mu, 1e-300)
        return self.sigma + 1.0 / safe


def _block_cg(apply_fn, b: torch.Tensor, *, tol: float, maxiter: int
              ) -> Tuple[torch.Tensor, int]:
    """CG on an SPD apply_fn, all columns of b advanced together
    (per-column step sizes). Columns that converge early keep taking
    ~zero-length steps; the loop exits when the worst column is under
    tol, a test that reads one scalar back from the device per
    iteration, as the reference does."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=0)
    b_norm = torch.sqrt(torch.clamp(torch.sum(b * b, dim=0), min=1e-30))
    zero = torch.zeros_like(rs)
    it = 0
    for it in range(1, maxiter + 1):
        ap = apply_fn(p)
        denom = torch.sum(p * ap, dim=0)
        alpha = torch.where(torch.abs(denom) > 1e-30, rs / denom, zero)
        x = x + p * alpha[None, :]
        r = r - ap * alpha[None, :]
        rs_new = torch.sum(r * r, dim=0)
        if float(torch.max(torch.sqrt(rs_new) / b_norm)) <= tol:
            rs = rs_new
            break
        beta = torch.where(rs > 1e-30, rs_new / rs, zero)
        p = r + p * beta[None, :]
        rs = rs_new
    return x, it


class ChebyshevFilterOperator:
    """p(A) with p = T_deg ∘ affine: polynomial spectral filter.

    The affine map sends the damped interval [lo, hi] onto [−1, 1] where
    Chebyshev polynomials stay bounded by 1; eigenvalues outside it are
    amplified like cosh(deg·acosh|t(λ)|). Damping the unwanted part of a
    measured spectral range (`estimate_spectral_range`) turns the wanted
    modes into the dominant eigenvalues of p(A), reachable with
    which="LM" by any solver — `degree` inner matmats per application.

    `untransform` recovers λ via Rayleigh quotients on the inner operator
    (T_deg is not invertible, so vectors are required).
    """

    def __init__(self, inner, interval: Tuple[float, float], *,
                 degree: int = 10):
        lo, hi = float(interval[0]), float(interval[1])
        if not hi > lo:
            raise ValueError(f"damped interval must have hi > lo, "
                             f"got ({lo}, {hi})")
        self.inner = inner
        self.n = inner.n
        self.device = inner.device
        self.lo, self.hi = lo, hi
        self.degree = int(degree)

    def capabilities(self) -> frozenset:
        return frozenset({CAP_SPECTRAL_TRANSFORM})

    def _mapped(self, x: torch.Tensor) -> torch.Tensor:
        c = 0.5 * (self.lo + self.hi)
        e = 0.5 * (self.hi - self.lo)
        return (self.inner.matmat(x) - c * x) / e

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("operator.matmat", op="ChebyshevFilterOperator",
                        k=int(x.shape[1]), n=self.n, degree=self.degree):
            t_prev = x.float()
            t_cur = self._mapped(t_prev)
            for _ in range(self.degree - 1):
                t_prev, t_cur = t_cur, 2.0 * self._mapped(t_cur) - t_prev
            return t_cur

    def untransform(self, theta, vecs=None) -> np.ndarray:
        if vecs is None:
            raise ValueError("ChebyshevFilterOperator.untransform needs the "
                             "Ritz vectors (the polynomial is not invertible)"
                             " — solve with compute_eigenvectors=True")
        return _rayleigh_eigenvalues(self.inner, vecs)


def estimate_spectral_range(op, *, iters: int = 30, seed: int = 0,
                            safety: float = 0.05, v0=None
                            ) -> Tuple[float, float]:
    """Cheap [λmin, λmax] estimate for filter construction: `iters` steps
    of scalar Lanczos (full reorthogonalization, host-side tridiagonal),
    widened by the last off-diagonal coupling plus a relative `safety`
    margin so the true extremes stay inside the returned interval.

    v0: an explicit (n, 1) start vector (normalized here). Without it the
    start is drawn from a `torch.Generator` seeded with `seed` on the
    operator's device (the reference draws with `jax.random`, which
    torch cannot reproduce; a parity test passes the reference's draw)."""
    dev = op.device
    if v0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        v = torch.randn((op.n, 1), generator=gen, dtype=torch.float32,
                        device=dev)
    else:
        v = torch.as_tensor(v0, dtype=torch.float32, device=dev)
        if tuple(v.shape) != (op.n, 1):
            raise ValueError(f"v0 is {tuple(v.shape)}, expected ({op.n}, 1)")
    v = v / torch.linalg.norm(v)
    basis = [v]
    alphas: List[float] = []
    betas: List[float] = []
    beta = 0.0
    for _ in range(iters):
        w = op.matmat(basis[-1])
        alpha = float(torch.sum(basis[-1] * w))
        alphas.append(alpha)
        for u in basis:                       # full reorth — iters is tiny
            w = w - u * torch.sum(u * w)
        beta = float(torch.linalg.norm(w))
        if beta < 1e-12:
            beta = 0.0
            break
        betas.append(beta)
        basis.append(w / beta)
    t = np.diag(np.asarray(alphas))
    if len(alphas) > 1:
        off = np.asarray(betas[:len(alphas) - 1])
        t += np.diag(off, 1) + np.diag(off, -1)
    ritz = np.linalg.eigvalsh(t)
    lo, hi = float(ritz[0]) - beta, float(ritz[-1]) + beta
    pad = safety * max(abs(lo), abs(hi), 1e-30)
    return lo - pad, hi + pad
