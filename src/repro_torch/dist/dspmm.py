"""Sharded semi-external-memory SpMM + fused eigensolver expansion step.

Port of `repro.dist.dspmm` onto `torch.distributed` (`comm.Mesh`). The
layout is the reference's (`layout`):

  * the sparse graph is packed into a 2D grid of *edge panels*
    (`pack_edge_panels`, numpy, bit-equal to the reference's): panel
    (g, m) holds the edges whose destination row lives in row group g and
    whose source column lives in column group m, and rank g·M + m holds
    it (`edge_spec`);
  * the dense vector subspace X is sharded over every rank in rank order
    (`vector_spec`). One SpMM all-gathers each column group's rows over
    the row axes (the panel's column working set), contracts the local
    panel, and reduce-scatters partial rows over the model axis: per rank
    n_pad/M·b gathered and n_pad/R·b reduced floats (§3.3);
  * `build_eigen_step` fuses SpMM → CGS2 block orthogonalization against
    the cached subspace V → CholQR2, returning (q_new, h, r) with
    A·x = V·h + q_new·r (the Krylov expansion invariant);
  * `build_eigen_step_compressed` streams the 6-byte/edge format
    (`pack_compressed_panels`: endpoints delta-coded per CHUNK edges into
    one uint32, values and operands bfloat16, sums float32).

Where the reference contracts a panel with a jnp gather + scatter-add and
runs CGS2/CholQR2 as einsums, a rank here runs the port's kernels, which
compute exactly these products: the panel is packed once into the
solver's 64×64 block image (`graphs.pack_tiles`, min 4 entries a block)
and contracted by a `GraphOperator` over it (`csrc/spmm_tile.cu` plus the
COO remainder); the projections h_j = V_jᵀw and the CholQR Grams go through
`ops.gram`, the updates w -= V_j h_j and q ← q·L⁻ᵀ through `ops.tsgemm`.
On CPU tensors `ops` takes the plain versions. The compressed stream keeps
the plain gather + `index_add_` (the reference's compressed step has no
Pallas kernel either). `panel_spmm_blocksparse` is the reference's bridge
to its Pallas tile kernel, here onto `csrc/spmm_tile.cu`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.dist import layout
from repro_torch.dist.compress import compressed_psum_pod
from repro_torch.graphs.tiles import pack_tiles
from repro_torch.kernels import ops as kops

# Edge-stream chunk: compressed panels delta-encode endpoints against one
# (row, col) base per CHUNK edges, and panel lengths pad to a CHUNK
# multiple so the streaming grid is uniform.
CHUNK = 4096

# the solver image's tiling of a panel (`GraphOperator`'s, chip_smoke.py)
PANEL_BLOCK, PANEL_MIN_BLOCK_NNZ = (64, 64), 4


# ------------------------------------------------------------------ specs
def row_axes(mesh) -> tuple:
    """Mesh axes forming the R row groups (everything but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def edge_spec(mesh) -> tuple:
    """Placement of (R, M, e_loc) panel arrays, in the reference's
    PartitionSpec terms: dim 0 over the row axes, dim 1 over 'model', so
    rank g·M + m holds panel [g, m] (`local_shard`)."""
    return (row_axes(mesh), "model", None)


def vector_spec(mesh) -> tuple:
    """Placement of (n_pad, b) vector blocks: rows over every axis, so rank
    r holds rows [r·s, (r+1)·s) (`local_shard`)."""
    return (tuple(mesh.axis_names), None)


def local_shard(arr, spec: tuple, mesh):
    """This rank's piece of `arr` under `edge_spec` or `vector_spec`."""
    if spec == edge_spec(mesh):
        return arr[mesh.g, mesh.m]
    if spec == vector_spec(mesh):
        s = arr.shape[0] // mesh.size
        return arr[mesh.rank * s:(mesh.rank + 1) * s]
    raise ValueError(f"unknown placement {spec!r}")


def _groups(mesh) -> tuple[int, int]:
    return mesh.r_groups, mesh.m_groups


# ------------------------------------------------------------- panel pack
def pack_edge_panels(n_pad: int, rows, cols, vals, *, r_groups: int,
                     m_groups: int, e_loc: int | None = None):
    """Partition permuted COO edges into the (R, M) panel grid.

    rows/cols are *positions* (already through `vertex_permutation`).
    Returns (panel_cols, panel_rows, panel_vals, e_loc), each array of shape
    (r_groups, m_groups, e_loc):

      panel_rows: destination row local to the row group's contiguous block
      panel_cols: source row local to the column group's gathered buffer
      panel_vals: edge weights; padding slots carry value 0 (and repeat the
                  panel's last endpoint so compressed delta bases stay tight)

    Every edge lands in exactly one panel. Panel interiors are sorted by
    (row, col) so output-tile revisits are consecutive (the paper's
    block-row-major stream order) and compressed chunk deltas small.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if not rows.shape == cols.shape == vals.shape:
        raise ValueError("pack_edge_panels: rows, cols and vals differ in "
                         "shape")
    g = layout.row_group_of(rows, n_pad, r_groups)
    m = layout.col_group_of(cols, n_pad, r_groups, m_groups)
    r_loc = layout.local_row(rows, n_pad, r_groups)
    c_loc = layout.local_col(cols, n_pad, r_groups, m_groups)

    panel = g * m_groups + m
    order = np.lexsort((c_loc, r_loc, panel))
    panel, r_loc, c_loc, vals = (a[order] for a in (panel, r_loc, c_loc,
                                                    vals))
    counts = np.bincount(panel, minlength=r_groups * m_groups)
    need = int(counts.max()) if counts.size else 1
    if e_loc is None:
        e_loc = max(need, 1)
    if need > e_loc:
        raise ValueError(f"panel overflow: {need} edges > e_loc={e_loc}")

    pr = np.zeros((r_groups * m_groups, e_loc), dtype=np.int32)
    pc = np.zeros_like(pr)
    pv = np.zeros((r_groups * m_groups, e_loc), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for p in range(r_groups * m_groups):
        lo, hi = starts[p], starts[p + 1]
        _fill_panel(pr[p], pc[p], pv[p], r_loc[lo:hi], c_loc[lo:hi],
                    vals[lo:hi])
    shape3 = (r_groups, m_groups, e_loc)
    return (pc.reshape(shape3), pr.reshape(shape3), pv.reshape(shape3),
            e_loc)


def _fill_panel(pr, pc, pv, r_loc, c_loc, vals) -> None:
    """Write one panel's sorted edges into its (e_loc,) rows; padding slots
    repeat the last endpoint with weight 0."""
    k = len(vals)
    pr[:k], pc[:k], pv[:k] = r_loc, c_loc, vals
    if 0 < k < len(pv):
        pr[k:], pc[k:] = r_loc[-1], c_loc[-1]


def pack_local_panel(n_pad: int, rows, cols, vals, *, r_groups: int,
                     m_groups: int, g: int, m: int):
    """Panel [g, m] of `pack_edge_panels` alone: (panel_cols, panel_rows,
    panel_vals, e_loc), each array (e_loc,) and the same bits as
    `pack_edge_panels(...)[i][g, m]`, e_loc the grid's (the fullest
    panel's count). One pass over the edges and a sort of the panel's own,
    where the grid sorts every edge: what a rank that keeps one panel
    needs."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if not rows.shape == cols.shape == vals.shape:
        raise ValueError("pack_local_panel: rows, cols and vals differ in "
                         "shape")
    gi = layout.row_group_of(rows, n_pad, r_groups)
    mi = layout.col_group_of(cols, n_pad, r_groups, m_groups)
    counts = np.bincount(gi * m_groups + mi, minlength=r_groups * m_groups)
    e_loc = max(int(counts.max()) if counts.size else 1, 1)
    mine = (gi == g) & (mi == m)
    r_loc = layout.local_row(rows[mine], n_pad, r_groups)
    c_loc = layout.local_col(cols[mine], n_pad, r_groups, m_groups)
    order = np.lexsort((c_loc, r_loc))     # stable, as the grid's sort
    pr = np.zeros(e_loc, dtype=np.int32)
    pc = np.zeros_like(pr)
    pv = np.zeros(e_loc, dtype=np.float32)
    _fill_panel(pr, pc, pv, r_loc[order], c_loc[order], vals[mine][order])
    return pc, pr, pv, e_loc


def pack_compressed_panels(pc: np.ndarray, pr: np.ndarray, pv: np.ndarray,
                           *, chunk: int = CHUNK):
    """Delta-encode packed panels into the 6-byte/edge streaming format.

    Per CHUNK-edge chunk, endpoints are stored as uint16 offsets from the
    chunk's (min row, min col) base: packed = row_off << 16 | col_off
    (uint32), bases interleave [r0, c0, r1, c1, ...] (int32), values cast
    to bfloat16 (round to nearest even, the bits of the reference's
    `ml_dtypes` cast). Returns (packed, bases, vals_bf16): numpy uint32
    (R, M, e_pad), numpy int32 (R, M, 2·n_chunks) and a CPU
    `torch.bfloat16` tensor (R, M, e_pad); e_pad rounds e_loc up to a
    chunk multiple (padding repeats each panel's last edge, weight 0).

    Sub-tile re-basing: a delta must fit 16 bits, so when a chunk's row
    or column span exceeds 65535 (a dense row across a panel wider than
    2^16) the chunk splits into 2^k equal sub-tiles with a base each, k
    the smallest that fits (a 1-edge sub-tile always fits). e_pad stays a
    chunk multiple; only the bases grow. Consumers recover the sub-tile
    length as `2 * e_pad // bases.shape[-1]` (`_unpack_edges`).
    """
    r_groups, m_groups, e_loc = pc.shape
    e_pad = -(-e_loc // chunk) * chunk
    if e_pad != e_loc:
        reps = e_pad - e_loc
        pc = np.concatenate([pc, np.repeat(pc[..., -1:], reps, -1)], -1)
        pr = np.concatenate([pr, np.repeat(pr[..., -1:], reps, -1)], -1)
        pv = np.concatenate([pv, np.zeros(pc.shape[:2] + (reps,),
                                          pv.dtype)], -1)
    sub = chunk
    while True:
        n_sub = e_pad // sub
        rc = pr.reshape(r_groups, m_groups, n_sub, sub)
        cc = pc.reshape(r_groups, m_groups, n_sub, sub)
        base_r = rc.min(-1)
        base_c = cc.min(-1)
        off_r = (rc - base_r[..., None]).astype(np.int64)
        off_c = (cc - base_c[..., None]).astype(np.int64)
        if not off_r.size or max(off_r.max(), off_c.max()) <= 0xFFFF:
            break
        if sub == 1:
            raise AssertionError("1-edge sub-tile cannot overflow a 16-bit "
                                 "delta")
        # re-base at finer sub-tile granularity; an odd sub drops straight
        # to 1 so every sub in the sequence divides e_pad
        sub = sub // 2 if sub % 2 == 0 else 1
    packed = ((off_r.astype(np.uint32) << np.uint32(16))
              | off_c.astype(np.uint32)).reshape(r_groups, m_groups, e_pad)
    bases = np.stack([base_r, base_c], axis=-1).reshape(
        r_groups, m_groups, 2 * n_sub).astype(np.int32)
    vals = torch.from_numpy(np.ascontiguousarray(pv, np.float32)).to(
        torch.bfloat16)
    return packed, bases, vals


def _unpack_edges(packed: torch.Tensor, bases: torch.Tensor):
    """Inverse of pack_compressed_panels for one rank's (e_pad,) stream:
    packed holds the uint32 words (as int32 or int64), bases int32.
    Returns (rows, cols) int32. The sub-tile length comes from the shapes
    (the stream is self-describing), so re-based streams decode too."""
    n_sub = bases.shape[0] // 2
    sub = packed.shape[0] // n_sub
    b2 = bases.reshape(n_sub, 2).to(torch.int32)
    off = packed.reshape(n_sub, sub)
    pr = ((off >> 16) & 0xFFFF).to(torch.int32) + b2[:, :1]
    pc = (off & 0xFFFF).to(torch.int32) + b2[:, 1:]
    return pr.reshape(-1), pc.reshape(-1)


# ------------------------------------------------------- per-rank panels
class Panel:
    """One rank's edge panel as the solver's block image on its device: a
    `GraphOperator` over `pack_tiles` of the panel (64×64 blocks of at
    least 4 entries; sparser blocks go to the COO remainder), whose
    matmat runs the SpMM kernel with the image's work plan plus the COO
    path. Padding slots (weight 0) are dropped. The image pads the
    panel's rows and columns up to block multiples; `contract` pads X and
    slices Y back."""

    def __init__(self, pr, pc, pv, n_rows: int, n_cols: int, *, device):
        from repro_torch.core.operator import GraphOperator
        pr, pc, pv = (np.asarray(a) for a in (pr, pc, pv))
        live = pv != 0
        tm = pack_tiles(n_rows, n_cols, pr[live], pc[live], pv[live],
                        block_shape=PANEL_BLOCK,
                        min_block_nnz=PANEL_MIN_BLOCK_NNZ)
        self.n_rows, self.n_cols = n_rows, n_cols
        self.n_cols_pad = tm.shape[1]
        self.n_entries = int(live.sum())
        self.n_blocks = int(tm.nblocks)
        self.n_coo = int(tm.coo_vals.size)
        self.image_bytes = tm.nbytes_image()
        self.image = GraphOperator(tm, device=device)

    @property
    def coo_share(self) -> float:
        """The share of the panel's entries left to the COO remainder."""
        return self.n_coo / max(self.n_entries, 1)

    def contract(self, x_m: torch.Tensor) -> torch.Tensor:
        """Y_g = A_panel · X_m: (n_cols, b) → (n_rows, b) float32."""
        return self.image.matmat(self.pad(x_m))[:self.n_rows]

    def pad(self, x_m: torch.Tensor) -> torch.Tensor:
        """X's (n_cols, b) rows as the image's (n_cols_pad, b) float32
        operand: the padding rows zero."""
        if x_m.shape[0] != self.n_cols:
            raise ValueError(f"panel has {self.n_cols} columns, X "
                             f"{x_m.shape[0]} rows")
        x = x_m.float()
        if self.n_cols_pad != self.n_cols:
            x = torch.cat([x, x.new_zeros((self.n_cols_pad - self.n_cols,
                                           x.shape[1]))])
        return x


class CompressedPanel:
    """One rank's 6-byte/edge stream (uint32 endpoints as int32 words,
    int32 bases, bf16 values) on its device, contracted by the plain
    gather + `index_add_` with float32 products and sums."""

    def __init__(self, packed, bases, vals, n_rows: int, *, device):
        dev = torch.device(device)
        words = np.ascontiguousarray(packed, np.uint32).view(np.int32)
        self.packed = torch.from_numpy(words).to(dev)
        self.bases = torch.from_numpy(np.asarray(bases, np.int32)).to(dev)
        self.vals = torch.as_tensor(vals).to(dev)
        self.n_rows = n_rows
        self.stream_bytes = sum(t.numel() * t.element_size() for t in
                                (self.packed, self.bases, self.vals))

    @classmethod
    def meta(cls, e_pad: int, n_chunks: int, n_rows: int):
        """A stream of e_pad edges in n_chunks chunks on the meta device
        (shapes and types only), as the dry run traces it."""
        self = cls.__new__(cls)
        meta = torch.device("meta")
        self.packed = torch.empty(e_pad, dtype=torch.int32, device=meta)
        self.bases = torch.empty(2 * n_chunks, dtype=torch.int32,
                                 device=meta)
        self.vals = torch.empty(e_pad, dtype=torch.bfloat16, device=meta)
        self.n_rows = n_rows
        self.stream_bytes = e_pad * 6 + 8 * n_chunks
        return self

    def contract(self, x_m: torch.Tensor) -> torch.Tensor:
        pr, pc = _unpack_edges(self.packed, self.bases)
        return kops.coo_spmm(pr, pc, self.vals.float(), x_m, self.n_rows)


class MetaPanel:
    """A panel of e_loc edges on the meta device, as the dry run traces
    it: endpoint and value arrays of the reference's panel shapes,
    contracted as the reference's step contracts them (a gather of X's
    rows and a scatter-add, `kops.coo_spmm`). A `Panel` on the card runs
    the block kernel over the blocks dense enough for it and this path
    over the rest; which split a graph gets is known only from its
    edges."""

    def __init__(self, e_loc: int, n_rows: int):
        meta = torch.device("meta")
        self.rows = torch.empty(e_loc, dtype=torch.int32, device=meta)
        self.cols = torch.empty(e_loc, dtype=torch.int32, device=meta)
        self.vals = torch.empty(e_loc, dtype=torch.float32, device=meta)
        self.n_rows = n_rows

    def contract(self, x_m: torch.Tensor) -> torch.Tensor:
        return kops.coo_spmm(self.rows, self.cols, self.vals, x_m,
                             self.n_rows)


# ---------------------------------------------------------- local kernels
def _panel_spmm(panel, x_loc: torch.Tensor, *, mesh, n_pad: int, b: int
                ) -> torch.Tensor:
    """Per-rank SpMM body: y_loc = (A @ x)_shard.

    1. all-gather this column group's x rows over the row axes (the
       panel's column working set, n_pad/M rows),
    2. contract the local panel (float32 sums whatever the stream type),
    3. reduce-scatter partial output rows over the model axis so each
       rank ends holding exactly its own n_pad/(R·M) shard.
    """
    s = layout.shard_size(n_pad, *_groups(mesh))
    if tuple(x_loc.shape) != (s, b):
        raise ValueError(f"x shard is {tuple(x_loc.shape)}, expected "
                         f"({s}, {b})")
    x_m = mesh.all_gather(x_loc, "rows")
    return mesh.reduce_scatter(panel.contract(x_m), "model")


def _cgs2_cholqr2(w_loc: torch.Tensor, v_loc: torch.Tensor, mesh, *,
                  b: int, nb_v: int, pod_compressed: bool = False):
    """Classical Gram-Schmidt (2 passes) against V + CholQR (2 passes).

    w_loc: (s, b) float32 shard of A·x. v_loc: (nb_v, s, b) shard of the
    cached subspace (float32, or bf16 widened here). Returns (q_loc, h, r)
    with w = V·h + q·r; h accumulates both CGS passes, r composes both
    CholQR triangles. Every b×b / (nb_v·b)×b reduction sums over every
    rank (optionally int8-compressed across the pod axis), so h, r and
    the Cholesky factors are the same bits on every rank.
    """
    def allsum(z):
        if pod_compressed:
            z = mesh.all_reduce(z, "nonpod")
            return compressed_psum_pod(z.reshape(-1), mesh).reshape(z.shape)
        return mesh.all_reduce(z, "all")

    vf = v_loc.float()
    w = w_loc.contiguous()
    h = torch.zeros((nb_v, b, b), dtype=torch.float32, device=w.device)
    for _ in range(2):  # CGS2: the second pass scrubs f32 cancellation
        hi = allsum(torch.stack([kops.gram(vf[j], w)
                                 for j in range(nb_v)]))
        for j in range(nb_v):
            w = kops.tsgemm(vf[j], hi[j], alpha=-1.0, beta=1.0, c0=w)
        h = h + hi
    eye = torch.eye(b, dtype=torch.float32, device=w.device)
    r = eye
    q = w
    for _ in range(2):  # CholQR2
        ell = torch.linalg.cholesky(allsum(kops.gram(q, q)))
        # q ← q·L⁻ᵀ, the reference's triangular solve, as a tsgemm
        linv_t = torch.linalg.solve_triangular(ell, eye, upper=False).T
        q = kops.tsgemm(q, linv_t.contiguous())
        r = ell.T @ r
    return q, h.reshape(nb_v * b, b), r


# ------------------------------------------------------------------ count
def design_bytes(n_pad: int, r_groups: int, m_groups: int, *, b: int,
                 x_bytes: int, nb_v: int = 0,
                 pod_compressed: bool = False) -> Dict[str, int]:
    """The design's collective bytes on one rank (`comm.Mesh.bytes`'
    convention) of one SpMM at width b, X's values x_bytes each, and with
    nb_v of one fused step's four reductions: per SpMM n_pad/M·b values
    gathered and n_pad/R·b float32 reduced; CGS2 two (nb_v·b, b) and
    CholQR2 two (b, b) float32 sums (pod-compressed: each a sum over the
    other axes, a max and an int32 sum over pod)."""
    out = {"all_gather": n_pad // m_groups * b * x_bytes,
           "reduce_scatter": n_pad // r_groups * b * 4}
    if nb_v:
        words = 2 * nb_v * b * b + 2 * b * b
        out["all_reduce"] = (2 * words * 4 + 4 * 4 if pod_compressed
                             else words * 4)
    return out


# ------------------------------------------------------------------ build
def build_dspmm(mesh, *, n_pad: int, e_loc: int, b: int):
    """Per-rank y = A @ x over packed panels: fn(panel, x_loc) -> y_loc.

    Every rank calls fn with its `Panel` and its (n_pad/(R·M), b) shard
    of x, in the same order; y_loc is its shard of y, float32. `e_loc` is
    the panel contract, carried by the shapes.
    """
    del e_loc

    def fn(panel, x_loc):
        return _panel_spmm(panel, x_loc, mesh=mesh, n_pad=n_pad, b=b)
    return fn


def build_eigen_step(mesh, *, n_pad: int, e_loc: int, b: int, nb_v: int,
                     pod_compressed: bool = False):
    """Fused Krylov expansion: fn(panel, vstack_loc, x_loc) -> (q_loc, h, r).

    vstack_loc: (nb_v, s, b), this rank's rows of the cached subspace V as
    stacked blocks (V[:, j·b+k] = vstack[j, :, k]). Invariants (tested):
      q_newᵀ q_new = I,  Vᵀ q_new = 0,  A·x = V·h + q_new·r.
    h (nb_v·b, b) and r (b, b) are replicated: every rank returns them.
    """
    del e_loc

    def fn(panel, v_loc, x_loc):
        w = _panel_spmm(panel, x_loc, mesh=mesh, n_pad=n_pad, b=b)
        return _cgs2_cholqr2(w, v_loc, mesh, b=b, nb_v=nb_v,
                             pod_compressed=pod_compressed)
    return fn


def build_eigen_step_compressed(mesh, *, n_pad: int, e_loc: int, b: int,
                                nb_v: int, chunk: int = CHUNK,
                                pod_compressed: bool = False):
    """Compressed-stream expansion step (6 bytes/edge, bf16 vectors).

    Returns (fn, n_chunks, e_pad); fn(cpanel, vstack_bf16_loc, x_bf16_loc)
    -> (q_loc, h, r) in float32, with cpanel this rank's
    `CompressedPanel`: `build_eigen_step`'s fn, which contracts whichever
    panel it is handed. Matches the baseline step to bf16 input-rounding
    tolerance (accumulation stays float32). `chunk` only sizes n_chunks
    and e_pad; the unpack is shape-driven.
    """
    e_pad = -(-e_loc // chunk) * chunk
    fn = build_eigen_step(mesh, n_pad=n_pad, e_loc=e_loc, b=b, nb_v=nb_v,
                          pod_compressed=pod_compressed)
    return fn, e_pad // chunk, e_pad


# ---------------------------------------------- the reference's bridge
def panel_to_blocks(pr, pc, pv, n_rows: int, n_cols: int, *, bm: int,
                    bn: int):
    """Re-tile one packed panel into the block-sparse stream that
    `spmm_blocksparse` consumes.

    Returns (blocks, block_cols, block_rows): dense (bm, bn) images of the
    non-empty blocks in block-row-major order (block_rows non-decreasing).
    """
    pr = np.asarray(pr, np.int64)
    pc = np.asarray(pc, np.int64)
    pv = np.asarray(pv, np.float32)
    live = pv != 0
    pr, pc, pv = pr[live], pc[live], pv[live]
    if n_rows % bm or n_cols % bn:
        raise ValueError(f"panel ({n_rows}, {n_cols}) is not a multiple of "
                         f"the block ({bm}, {bn})")
    br, bc = pr // bm, pc // bn
    key = br * (n_cols // bn) + bc
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((max(len(uniq), 1), bm, bn), np.float32)
    np.add.at(blocks, (inv, pr % bm, pc % bn), pv)
    block_rows = (uniq // (n_cols // bn)).astype(np.int32)
    block_cols = (uniq % (n_cols // bn)).astype(np.int32)
    if not len(uniq):
        block_rows = np.zeros(1, np.int32)
        block_cols = np.zeros(1, np.int32)
    return blocks, block_cols, block_rows


def panel_spmm_blocksparse(pr, pc, pv, x_panel, n_rows: int, *, bm: int = 8,
                           bn: int = 8) -> torch.Tensor:
    """Panel contraction through the block-sparse tile kernel.

    x_panel: (n_cols, k) tensor, the panel's column working set. The
    reference's bridge to its Pallas kernel; here `kops.spmm_blocks`
    (`csrc/spmm_tile.cu` on a CUDA tensor, which takes the default 8×8
    float32 blocks) over the CSR row_ptr of `panel_to_blocks`' block rows.
    Rows of empty block rows come out zero.
    """
    x = torch.as_tensor(x_panel, dtype=torch.float32)
    n_cols = x.shape[0]
    blocks, bcols, brows = panel_to_blocks(pr, pc, pv, n_rows, n_cols,
                                           bm=bm, bn=bn)
    row_ptr = np.zeros(n_rows // bm + 1, np.int32)
    np.add.at(row_ptr, brows.astype(np.int64) + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)
    dev = x.device
    return kops.spmm_blocks(torch.from_numpy(blocks).to(dev),
                            torch.from_numpy(bcols).to(dev),
                            torch.from_numpy(row_ptr).to(dev), x)
