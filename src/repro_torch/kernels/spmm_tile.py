"""Block-sparse SpMM  Y = A @ X  on the card: wrapper over
`csrc/spmm_tile.cu` (replaces the Pallas `repro.kernels.spmm_tile`).

A is given as dense non-empty (bm×bn) blocks in block-row-major order, an
int32 block column per block and the int32 CSR `row_ptr` over block rows.
The kernel follows a work `plan` of the image: every block row longer
than `chunk` blocks is cut into contiguous chunks of near-equal length,
one CTA per work item, longest first; split rows get their chunks'
partials summed in chunk order by a second launch. Every output row is
written, zeros for empty block rows, and the result is bit-identical from
run to run. Its plain version is `spmm_ref.spmm_ref`.

Blocks may be float32 or bf16 (a bf16 image halves the bytes the kernel
reads); X and Y are float32, and every product and sum is float32.

A CTA streams its item's blocks and X slabs by bulk copy into a ring of
STAGES shared-memory stages and multiplies from register tiles (one
column group and up to MAX_ROWS rows a thread); `launch_config` is the
launch the kernel makes for a shape, `occupancy` what the card reports
for it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (F32_BF16, require_cuda,
                                        require_dtype, require_int32)

LAUNCHES = 0        # spmm_blocksparse calls that launched (chip_smoke reads it)
LAUNCHES_BF16 = 0   # those of them over bf16 blocks
LAUNCHES_BY_K: dict[int, int] = {}   # those of them by X's width k

N_SMS = 132   # an H100 SXM's SMs: the default chunk of a plan on the CPU
CHUNK_MIN, CHUNK_MAX = 16, 512


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """Work plan of one block-sparse image.

    row_ptr: the int32 CSR tensor the plan describes, on the plan's
             device; `spmm_blocksparse` takes the plan with this tensor
             only (see `describes`).
    items:   (n_items, 4) int32 rows of block row, lo, hi (a contiguous
             range of blocks in CSR order) and partial slot, or -1 when
             the item is its whole row and writes Y directly; longest
             first.
    splits:  (n_split, 3) int32 rows of block row, first slot, chunks, for
             every split row; a row's slots are consecutive, in chunk
             order.
    """
    row_ptr: torch.Tensor
    items: torch.Tensor
    splits: torch.Tensor
    n_block_rows: int
    n_blocks: int
    n_partials: int
    chunk: int

    @property
    def heaviest(self) -> int:
        """Blocks in the longest work item (0 for an empty image)."""
        if self.items.shape[0] == 0:
            return 0
        first = self.items[0].tolist()
        return first[2] - first[1]

    def describes(self, row_ptr: torch.Tensor) -> bool:
        """Whether `row_ptr` is the tensor this plan was built from: the
        same memory, shape and device. The plan holds that tensor, so no
        other can take its memory; an edit in place is not seen."""
        mine = self.row_ptr
        return mine is row_ptr or (
            mine.device == row_ptr.device and mine.shape == row_ptr.shape
            and mine.data_ptr() == row_ptr.data_ptr())


def sm_count(device) -> int:
    """The SMs of a CUDA device; N_SMS for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return N_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def default_chunk(n_blocks: int, n_sms: int = N_SMS) -> int:
    """An eighth of the per-SM share of blocks on a card of `n_sms` SMs,
    within [CHUNK_MIN, CHUNK_MAX]: a chunk stays far below what one SM has
    to walk, and a row is not split into pieces whose partials cost more
    than they save. For the 784,953 blocks of the 2^20-vertex R-MAT image
    on an H100 SXM it is 512."""
    return int(min(CHUNK_MAX, max(CHUNK_MIN, n_blocks // (8 * n_sms))))


def plan(row_ptr, *, chunk: int | None = None, device=None) -> Plan:
    """The work plan of the CSR `row_ptr` over block rows (numpy, or a
    tensor, which costs one copy to the host when it lies on the card).
    The plan's tensors go to `device`, by default row_ptr's (the CPU for
    numpy); its `row_ptr` is row_ptr on that device, the given tensor
    itself when it lies there. Every block row longer than `chunk` blocks
    (default `default_chunk` for the SMs of a CUDA device, or N_SMS)
    becomes ⌈len/chunk⌉ contiguous chunks whose lengths differ by at most
    one; every other row, empty ones included, is one item. Items are
    ordered longest first, ties in CSR order."""
    if isinstance(row_ptr, torch.Tensor):
        device = torch.device(row_ptr.device if device is None else device)
        ptr_t = row_ptr.to(device=device, dtype=torch.int32)
        ptr = row_ptr.cpu().numpy().astype(np.int64)
    else:
        device = torch.device("cpu" if device is None else device)
        ptr = np.asarray(row_ptr, dtype=np.int64)
        ptr_t = torch.from_numpy(ptr.astype(np.int32)).to(device)
    if ptr.ndim != 1 or ptr.size == 0:
        raise ValueError("plan: row_ptr must be (n_block_rows + 1,)")
    counts = np.diff(ptr)
    n_blocks = int(ptr[-1])
    if chunk is None:
        chunk = default_chunk(n_blocks, sm_count(device))
    if chunk < 1:
        raise ValueError(f"plan: chunk must be >= 1, got {chunk}")
    pieces = np.maximum(1, -(-counts // chunk))
    row = np.repeat(np.arange(counts.size), pieces)
    j = np.arange(row.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    n, length, start = pieces[row], counts[row], ptr[row]
    lo = start + length * j // n
    hi = start + length * (j + 1) // n
    split = pieces > 1
    split_pieces = np.where(split, pieces, 0)
    slot0 = np.cumsum(split_pieces) - split_pieces
    slot = np.where(split[row], slot0[row] + j, -1)
    order = np.argsort(lo - hi, kind="stable")          # longest first
    items = np.stack([row, lo, hi, slot], axis=1)[order].astype(np.int32)
    splits = np.stack([np.flatnonzero(split), slot0[split], pieces[split]],
                      axis=1).astype(np.int32)
    return Plan(row_ptr=ptr_t, items=torch.from_numpy(items).to(device),
                splits=torch.from_numpy(splits).to(device),
                n_block_rows=counts.size, n_blocks=n_blocks,
                n_partials=int(split_pieces.sum()), chunk=int(chunk))


_plan = plan   # `spmm_blocksparse` takes a `plan` argument of the same name

# The kernel's launch shape (csrc/spmm_tile.cu: kStages, kMaxRows, ...).
WIDTHS = (1, 2, 4, 8, 16)   # X widths the kernel is built for
STAGES = 4                  # the ring's stages
MAX_ROWS = 4                # block rows a thread owns in its column group
MIN_THREADS, MAX_THREADS = 32, 512
BAR_BYTES, X_PAD, MAX_SMEM = 128, 16, 232448


def kernel_width(k: int) -> int:
    """The X width the kernel runs for k columns: k if it is one of
    WIDTHS, else the next of them (the wrapper pads X with zero columns);
    wider than 16, X runs in slabs of 16."""
    return next((w for w in WIDTHS if w >= k), WIDTHS[-1])


def launch_config(dtype: torch.dtype, bm: int, bn: int, k: int) -> dict:
    """The launch `csrc/spmm_tile.cu`'s `shape_of` makes for (bm, bn)
    blocks of `dtype` against an X of width k (one of WIDTHS): the column
    group's width, the groups and their power-of-two padding, the CTA's
    threads (the fewest, from 32 to 512, that give no thread more than
    MAX_ROWS rows), the bytes of a block, of a stage and of the CTA's
    shared memory. ValueError for a shape the kernel does not take."""
    elem = torch.empty((), dtype=dtype).element_size()
    gw = 8 if elem == 2 or bn % 8 == 0 else 4
    if bm < 1 or bn < 1 or k not in WIDTHS or bn % gw:
        raise ValueError(f"spmm_blocksparse: no kernel for {dtype} blocks "
                         f"({bm}, {bn}) at k={k}")
    groups = bn // gw
    gpad = 1 << (groups - 1).bit_length()
    threads = MIN_THREADS
    while threads <= MAX_THREADS and (gpad > threads or
                                      bm > MAX_ROWS * (threads // gpad)):
        threads *= 2
    a_bytes = bm * bn * elem
    stage = a_bytes + groups * (gw * k * 4 + X_PAD)
    smem = BAR_BYTES + max(STAGES * stage, bm * groups * k * 4)
    if threads > MAX_THREADS or smem > MAX_SMEM:
        raise ValueError(f"spmm_blocksparse: no kernel for {dtype} blocks "
                         f"({bm}, {bn}) at k={k}: {threads} threads, "
                         f"{smem} bytes of shared memory")
    return {"group_width": gw, "groups": groups, "groups_padded": gpad,
            "threads": threads, "stages": STAGES, "block_bytes": a_bytes,
            "stage_bytes": stage, "smem_bytes": smem}


def occupancy(dtype: torch.dtype, bm: int, bn: int, k: int,
              device=None) -> dict:
    """What the card reports for the kernel at this shape (k one of
    WIDTHS): threads, stages, shared bytes a CTA, CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the group's width,
    registers and local (spilled) bytes a thread, bytes a stage."""
    device = torch.device("cuda" if device is None else device)
    out = (ctypes.c_int * 8)()
    err = _build.lib().repro_spmm_blocksparse_config(
        int(dtype == torch.bfloat16), bm, bn, k,
        device.index if device.index is not None else
        torch.cuda.current_device(), out)
    _build.check(err, "spmm_blocksparse config")
    keys = ("threads", "stages", "smem_bytes", "ctas_per_sm",
            "group_width", "registers", "local_bytes", "stage_bytes")
    return dict(zip(keys, list(out)))


def _check_shapes(blocks, block_cols, row_ptr, x) -> None:
    """Types, shapes and alignment, before the device is looked at."""
    require_dtype("spmm_blocksparse", F32_BF16, blocks=blocks, x=x)
    if blocks.dim() != 3 or x.dim() != 2 or row_ptr.dim() != 1:
        raise ValueError("spmm_blocksparse: blocks (nb, bm, bn), x (n, k), "
                         "row_ptr (n_block_rows + 1,)")
    nb, bm, bn = blocks.shape
    k = x.shape[1]
    if block_cols.shape != (nb,):
        raise ValueError(f"spmm_blocksparse: block_cols {tuple(block_cols.shape)}"
                         f" for {nb} blocks")
    if x.shape[0] % bn:
        raise ValueError(f"spmm_blocksparse: x has {x.shape[0]} rows, not a "
                         f"multiple of bn={bn}")
    per_load = 16 // blocks.element_size()     # values in a 16-byte load
    if (bn % per_load or bm * bn > 4096 or bm * k > 2048 or bn * k > 1024
            or k == 0):
        raise ValueError(f"spmm_blocksparse: unsupported {blocks.dtype} block "
                         f"({bm}, {bn}) with k={k} (needs bn % {per_load} == "
                         f"0, bm*bn <= 4096, bm*k <= 2048, bn*k <= 1024)")
    launch_config(blocks.dtype, bm, bn, kernel_width(k))
    # the bulk copies move 16-byte units; a bf16 x is widened into a new
    # tensor, which is aligned
    if blocks.data_ptr() % 16:
        raise ValueError("spmm_blocksparse: blocks must be 16-byte aligned")
    if x.dtype == torch.float32 and x.data_ptr() % 16:
        raise ValueError("spmm_blocksparse: x must be 16-byte aligned")


def launch_with(library, blocks: torch.Tensor, block_cols: torch.Tensor,
                row_ptr: torch.Tensor, x: torch.Tensor, *,
                plan: Plan | None = None) -> torch.Tensor:
    """`spmm_blocksparse` through the kernel library that `library()`
    returns, once the inputs have passed their checks (`_build.lib` for
    the port's; `spmm_compare` passes another tree's build, whose C
    interface is the same). It counts nothing in LAUNCHES."""
    _check_shapes(blocks, block_cols, row_ptr, x)
    nb, bm, bn = blocks.shape
    k = x.shape[1]
    dev = require_cuda("spmm_blocksparse", blocks=blocks, x=x)
    require_int32("spmm_blocksparse", dev, block_cols=block_cols,
                  row_ptr=row_ptr)
    x = x.float()
    n_block_rows = row_ptr.shape[0] - 1
    if plan is None:
        plan = _plan(row_ptr)
    elif not plan.describes(row_ptr):
        raise ValueError("spmm_blocksparse: the plan was built from another "
                         "row_ptr tensor; pass plan(row_ptr) of this one")
    if plan.n_blocks != nb:
        raise ValueError(f"spmm_blocksparse: row_ptr covers {plan.n_blocks} "
                         f"blocks, blocks holds {nb}")
    require_int32("spmm_blocksparse", dev, plan_items=plan.items,
                  plan_splits=plan.splits)
    if plan.items.data_ptr() % 16:
        raise ValueError("spmm_blocksparse: plan.items must be 16-byte "
                         "aligned (read as int4)")
    y = torch.empty((n_block_rows * bm, k), dtype=torch.float32, device=dev)
    if n_block_rows == 0:
        return y
    device, stream = _build.device_and_stream(x)
    launch = (library().repro_spmm_blocksparse_bf16
              if blocks.dtype == torch.bfloat16
              else library().repro_spmm_blocksparse_f32)
    for c0 in range(0, k, WIDTHS[-1]):     # one slab unless k > 16
        w = min(k - c0, WIDTHS[-1])
        kw = kernel_width(w)
        if kw == k:
            xs, ys = x, y
        else:                              # zero columns up to kw
            xs = torch.zeros((x.shape[0], kw), dtype=torch.float32,
                             device=dev)
            xs[:, :w] = x[:, c0:c0 + w]
            ys = torch.empty((n_block_rows * bm, kw), dtype=torch.float32,
                             device=dev)
        if not _build.aligned16(ys):
            raise ValueError("spmm_blocksparse: y must be 16-byte aligned")
        partials = torch.empty((plan.n_partials, bm * kw),
                               dtype=torch.float32, device=dev)
        err = launch(
            blocks.data_ptr(), block_cols.data_ptr(), plan.items.data_ptr(),
            plan.items.shape[0], plan.splits.data_ptr(),
            plan.splits.shape[0], xs.data_ptr(), ys.data_ptr(),
            partials.data_ptr(), bm, bn, kw, device, stream)
        _build.check(err, "spmm_blocksparse")
        if ys is not y:
            y[:, c0:c0 + w] = ys[:, :w]
    return y


def spmm_blocksparse(blocks: torch.Tensor, block_cols: torch.Tensor,
                     row_ptr: torch.Tensor, x: torch.Tensor, *,
                     plan: Plan | None = None) -> torch.Tensor:
    """Y = A @ X for a block-sparse A.

    blocks:     (nb, bm, bn) float32 or bfloat16 (then bn % 8 == 0),
                16-byte aligned
    block_cols: (nb,) int32
    row_ptr:    (n_block_rows + 1,) int32
    x:          (n_block_cols*bn, k) float32, 16-byte aligned, or
                bfloat16, which is widened to float32 once here (exactly)
    plan:       the work plan of this row_ptr tensor (`plan(row_ptr)`),
                refused for any other; without one the wrapper builds it
                from row_ptr (a copy to the host)
    returns     (n_block_rows*bm, k) float32

    The kernel runs X widths of WIDTHS: another k is padded with zero
    columns to the next (a copy of X), and k > 16 runs in slabs of 16
    (one kernel launch each). Types, shapes and alignment are checked
    before the device, so a refusal reads the same on any device. One
    call is one count in LAUNCHES (and in LAUNCHES_BF16 for bf16 blocks,
    and in LAUNCHES_BY_K[k]), though a plan with split rows launches a
    second, combining kernel.
    """
    global LAUNCHES, LAUNCHES_BF16
    y = launch_with(_build.lib, blocks, block_cols, row_ptr, x, plan=plan)
    if row_ptr.shape[0] > 1:
        k = x.shape[1]
        LAUNCHES += 1
        LAUNCHES_BF16 += blocks.dtype == torch.bfloat16
        LAUNCHES_BY_K[k] = LAUNCHES_BY_K.get(k, 0) + 1
    return y
