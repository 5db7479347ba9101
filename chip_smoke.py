#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one H100 and check it.

    python3 chip_smoke.py

Needs one CUDA card of capability (9, 0), `nvcc` and the repository's
`src/` beside this file; exits non-zero without printing a result
otherwise. Phases, each of which fails the run:

  1. card: name and power limit (nvidia-smi), capability (9, 0);
  2. build: the CUDA kernels from src/repro_torch/kernels/csrc,
     compiled in parallel into src/repro_torch/kernels/build/;
  3. graph: the n = 2^20 R-MAT image, `rmat_graph(2**20, 2**23, seed=1,
     symmetric=True)` → normalized adjacency → 64×64 blocks with at least
     4 entries, uploaded to the card in a GraphOperator;
  4. kernels: each kernel at the shapes the solve gives it, held against
     its plain PyTorch version on the same inputs, timed beside the plain
     version, one PyTorch library call and the card's bound; the SpMM
     with the operator's work plan (printed: work items, split rows,
     heaviest chunk), run-to-run bit identity, and its heaviest work item
     timed alone; gram and tsgemm bit-identical run to run, with their
     device kernels per call counted by the profiler (one each);
  5. end to end: `solve(op, 8, method="krylov_schur", block_size=4,
     num_blocks=8, tol=1e-5, max_iters=100)` on a CUDA TieredStore, with
     the launch counters zeroed just before and read just after; it must
     converge with true residuals ≤ 1e-4·max(1, |θ|) and every kernel
     must have launched;
  6. small input, before 5: the same solver on a 1,200-vertex graph
     against numpy's dense eigvalsh, rtol 1e-5;
  7. breakdown: a short profiled solve (device time and launches by
     kernel and copy, ms per launch, host spans for store.get /
     store.demote / operator.matmat);
  8. the bf16 image: the operator's blocks cast to bf16 on the card
     (`GraphOperator.astype`, 6.43 GB); the bf16 SpMM against its plain
     version, bit-identical run to run and timed as in 4; then the solve
     of 5 over it, counters zeroed just before and read just after (every
     SpMM launch must be a bf16 one), converged with true residuals
     ≤ 1e-4 against the bf16 operator and eigenvalues within Weyl's bound
     (2^-8 · max row sum of the blocks, plus the residuals) of the
     float32 solve's; its profiled breakdown; then the cast is freed;
  9. SAFS subspace: the solve of 5 again, with the subspace in SAFS page
     files (`TieredStore(backend="safs")` under a new temporary
     directory) and the image resident on the card, counters zeroed just
     before and read just after: converged with true residuals ≤ 1e-4,
     every solver kernel launched, logical IOStats equal to the RAM-tier
     solve's to the byte; its wall beside the RAM solve's, the backend's
     `stats_dict()`, the page path's rates (host spans) and the page
     root's filesystem; then one scrub pass, which must find no corrupt
     page; then the 2^20 image is freed;
 10. SAFS streamed image: `rmat_graph(2**16, 2**19, seed=1,
     symmetric=True)` packed as in 3, spilled by
     `GraphOperator(stream_image=True)` into a SAFS store as block-row
     spans; one streamed matmat equals the resident operator's bit for
     bit (under deterministic algorithms, so the COO part's `index_add_`
     sums in a fixed order); matmat times streamed and resident; the
     solve of 5 over the streamed image, counters zeroed just before and
     read just after: converged with true residuals ≤ 1e-4 and one SpMM
     launch per non-empty span per matmat; then the image is deleted and
     the directory removed;
 11. flash attention, after the graph image is freed: the kernel against
     its plain version (float32 arithmetic on the same bf16 inputs) at the
     yi-9b prefill shapes (B 4, S 2048, H 32, Hkv 4, d 128, causal) and at
     a ragged non-causal shape (Sq 96, Sk 160, d 64), run-to-run bit
     identity, timed beside the plain version, PyTorch's
     scaled_dot_product_attention and the card's bound, with its TFLOP/s
     and the PV design the bf16 kernel ships (P split into bf16 hi + lo);
 12. yi-9b serving at full width and all 48 layers in bf16, weights drawn
     on the card by `init_model` from a seed: 4 requests of 2,048 prompt
     tokens through `prefill_with_cache(..., cache_len=2080)`, then 32
     greedy `decode_step`s, with the launch counters zeroed just before
     and read just after (48 flash launches per prefill); then one
     `logits_fn` over prompt plus generated tokens, whose logits at the
     generated positions must agree with the decode logits;
 13. serve breakdown: one profiled prefill and 4 profiled decode steps
     (device time by kind, idle share, the largest host ops).

Then one JSON line of kernels, the card line, and the final result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense

N_LOG2, NNZ_LOG2, GRAPH_SEED = 20, 23, 1
BLOCK, MIN_BLOCK_NNZ = (64, 64), 4
NEV, BLOCK_SIZE, NUM_BLOCKS, TOL, MAX_ITERS = 8, 4, 8, 1e-5, 100
RESID_TOL = 1e-4
KERNEL_TOL = 1e-5   # |kernel − plain| ≤ KERNEL_TOL · Σ|terms|, per element
REPS = 10
# the streamed-image graph: rmat_graph(2**k, 2**(k+3)); k = 16 keeps the
# phase near a minute on the card (every matmat pages the whole image
# through the SAFS page path, 4 KiB at a time)
STREAM_LOG2 = 16

# flash attention at yi-9b's prefill shapes (B, H, Hkv, S, d), bf16
FLASH_SERVE = (4, 32, 4, 2048, 128)
# one bf16 rounding of the output is half an ulp, 2^-9 to 2^-8 of the
# value (2^-8 only just above a power of two); the f32 arithmetic of
# kernel and plain version differ by ~1e-6
FLASH_TOL = 2.0 ** -8          # of the output's largest magnitude

# yi-9b serving: prompt tokens per request, requests, decode steps, seed
SERVE_PROMPT, SERVE_BATCH, SERVE_DECODE, SERVE_SEED = 2048, 4, 32, 0
# decode (one query against the cache, weights rounded to bf16, GEMMs of
# 4 rows) and the full forward (flash, weights kept f32, GEMMs of 8,320
# rows) round differently at ~10 places in each of 48 layers; as a random
# walk of bf16 roundings that is about sqrt(480) * 2^-9 = 0.043 of the
# logits' norm, and twice that is the limit
SERVE_TOL = 0.1                # max over positions of ‖Δ‖₂ / ‖logits‖₂


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing

class Timer:
    """Median of CUDA-event times over REPS launches, each launched after
    a 256 MB write that evicts the 50 MB L2 cache, as the solve's inputs
    arrive from a copy or an earlier kernel. That write leaves L2 full of
    dirty lines, which the timed launch writes back as it reads; with
    `clean=True` the buffer is read back before each launch, so L2 holds
    clean lines and the launch pays for its own bytes only."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=device)

    def ms(self, fn, reps: int = REPS, clean: bool = False) -> float:
        torch = self.torch
        fn()                                 # warm up
        times = []
        for _ in range(reps):
            self.flush.zero_()
            if clean:
                self.flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S
             ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want, scale) -> float:
    """max |got − want| / Σ|terms| elementwise (0 where both sums are 0)."""
    diff = (got.double() - want.double()).abs()
    scale = scale.double()
    ok = scale > 0
    if bool((diff[~ok] > 0).any()):
        return float("inf")
    return float((diff[ok] / scale[ok]).max()) if bool(ok.any()) else 0.0


# ------------------------------------------------------------------ phases

def card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {line} | capability {cap} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if tuple(cap) != (9, 0):
        fail(f"capability {cap} is not (9, 0): the kernels are sm_90a")
    return line


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    dt = time.perf_counter() - t0
    log(f"build: {path.name} in {dt:.2f} s (nvcc {_build.nvcc_path()})")
    return dt


def make_graph(n_log2: int, nnz_log2: int):
    from repro_torch.graphs import normalized_adjacency, pack_tiles
    from repro_torch.graphs import rmat_graph
    n = 2 ** n_log2
    t0 = time.perf_counter()
    r, c, v = rmat_graph(n, 2 ** nnz_log2, seed=GRAPH_SEED, symmetric=True)
    r, c, v = normalized_adjacency(n, r, c, v)
    t1 = time.perf_counter()
    tm = pack_tiles(n, n, r, c, v, block_shape=BLOCK,
                    min_block_nnz=MIN_BLOCK_NNZ)
    t2 = time.perf_counter()
    per_row = np.diff(tm.row_ptr)
    isolated = n - np.unique(r).size
    log(f"graph: n={n} nnz={r.size} | dense blocks {tm.nblocks} "
        f"({tm.blocks.nbytes / 1e9:.2f} GB, "
        f"{1 - tm.coo_vals.size / r.size:.3f} of nnz, mean fill "
        f"{(r.size - tm.coo_vals.size) / max(tm.blocks.size, 1):.5f}) | "
        f"COO {tm.coo_vals.size} entries ({tm.coo_vals.size * 12 / 1e6:.1f}"
        f" MB) | blocks per block row mean {per_row.mean():.1f} max "
        f"{per_row.max()} | isolated vertices {isolated} | generate "
        f"{t1 - t0:.1f} s, pack {t2 - t1:.1f} s")
    return tm, (r, c, v)


def kernels_per_call(torch, fn, calls: int = 4) -> float:
    """Device kernels that one call of fn launches, counted by the
    profiler over `calls` calls (copies and fills excluded)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(evt.count for evt in prof.key_averages()
            if "CUDA" in str(getattr(evt, "device_type", ""))
            and not evt.key.startswith(("Memcpy", "Memset")))
    return n / calls


def spmm_phase(torch, op, timer, x):
    """The SpMM kernel over the operator's image, float32 or bf16, at the
    solve's shapes against its plain version (float32 arithmetic on the
    same blocks)."""
    from repro_torch.kernels import ops, spmm_tile
    blocks, cols, ptr, plan = op._blocks, op._block_cols, op._row_ptr, \
        op._plan
    n = op.n
    bf16 = blocks.dtype == torch.bfloat16
    name = "spmm_blocksparse_bf16" if bf16 else "spmm_blocksparse"
    y = ops.spmm_blocks(blocks, cols, ptr, x, plan=plan)
    if not torch.equal(y, ops.spmm_blocks(blocks, cols, ptr, x, plan=plan)):
        fail(f"{name} is not bit-identical from run to run")
    y_ref = ops.spmm_blocks(blocks, cols, ptr, x, impl="ref")
    # Σ|terms| per output; the normalized adjacency has no negative entry,
    # so the image itself serves and no |blocks| copy is made
    abs_blocks = blocks if float(blocks.min()) >= 0 else blocks.abs()
    scale = ops.spmm_blocks(abs_blocks, cols, ptr, x.abs(), impl="ref")
    err = rel_err(y, y_ref, scale)
    abs_err = float((y - y_ref).abs().max())
    del y_ref, scale, abs_blocks
    ms = timer.ms(lambda: ops.spmm_blocks(blocks, cols, ptr, x, plan=plan))
    plain = timer.ms(lambda: ops.spmm_blocks(blocks, cols, ptr, x,
                                             impl="ref"), reps=3)
    nb, bm, bn = blocks.shape
    nbytes = (blocks.numel() * blocks.element_size() + cols.numel() * 4
              + ptr.numel() * 4 + x.numel() * 4 + y.numel() * 4)
    bms, by = bound_ms(nbytes, 2 * nb * bm * bn * BLOCK_SIZE)
    lib_ms, lib_note, bsr = None, "torch.sparse BSR @ dense", None
    try:
        with warnings.catch_warnings():   # "BSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            bsr = torch.sparse_bsr_tensor(ptr, cols, blocks, size=(n, n),
                                          check_invariants=False)
        lib_ms = timer.ms(lambda: bsr @ x, reps=3)
    except (RuntimeError, NotImplementedError) as e:  # yardstick only
        lib_note = (f"BSR product on these inputs unavailable: "
                    f"{str(e).splitlines()[0][:120]}")
        if bf16 and bsr is not None:       # bf16 X: other inputs, noted
            xb = x.bfloat16()
            try:
                lib_note += (f"; with X rounded to bf16 "
                             f"{timer.ms(lambda: bsr @ xb, reps=3):.3f} ms")
            except (RuntimeError, NotImplementedError) as e2:
                lib_note += (f"; with bf16 X also unavailable: "
                             f"{str(e2).splitlines()[0][:120]}")
    del bsr
    # the heaviest work item alone (the plan's first), writing Y directly:
    # what is left of the skew that one block row used to set
    row, lo, hi, _ = plan.items[0].tolist()
    alone = dataclasses.replace(
        plan, splits=plan.splits[:0],
        items=torch.tensor([[row, lo, hi, -1]], dtype=torch.int32,
                           device=op.device), n_partials=0)
    heavy_ms = timer.ms(lambda: spmm_tile.spmm_blocksparse(
        blocks, cols, ptr, x, plan=alone))
    per_row = (ptr[1:] - ptr[:-1]).cpu()
    sms = torch.cuda.get_device_properties(op.device).multi_processor_count
    if not bf16:
        log(f"kernel spmm_blocksparse: plan chunk {plan.chunk} | "
            f"{plan.items.shape[0]} work items for {plan.n_block_rows} block"
            f" rows, {plan.splits.shape[0]} rows split into "
            f"{plan.n_partials} chunks | heaviest block row "
            f"{int(per_row.max())} blocks, heaviest work item "
            f"{plan.heaviest} blocks (per-SM share {nb / sms:.0f})")
    log(f"kernel {name}: blocks {tuple(blocks.shape)} "
        f"{str(blocks.dtype).removeprefix('torch.')} "
        f"({nb * bm * bn * blocks.element_size() / 1e9:.2f} GB) x "
        f"{tuple(x.shape)} | rel err {err:.3e} (tol {KERNEL_TOL:g} of "
        f"Σ|terms|), max abs err {abs_err:.3e}, bit-identical run to run | "
        f"{ms:.3f} ms, plain {plain:.3f} ms, library {lib_ms} ms "
        f"({lib_note}), bound {bms:.3f} ms ({by}) | heaviest work item "
        f"(block row {row}, blocks {lo}..{hi}) alone {heavy_ms:.3f} ms = "
        f"{heavy_ms / ms:.2f} of the launch")
    if not err <= KERNEL_TOL:
        fail(f"{name} disagrees with its plain version: {err}")
    count = ((lambda: spmm_tile.LAUNCHES_BF16) if bf16 else
             (lambda: spmm_tile.LAUNCHES - spmm_tile.LAUNCHES_BF16))
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spmm_tile.cu",
            "replaces": "src/repro/kernels/spmm_tile.py:50",
            "count": count, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def kernel_phase(torch, op, timer):
    """Each kernel at its main-path shapes against its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.kernels import tsgemm as tsgemm_mod
    dev = op.device
    n = op.n
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = [spmm_phase(torch, op, timer, randn(n, BLOCK_SIZE))]

    # --- gram: one launch per call, the last CTA sums the partials ---------
    a, b = randn(n, BLOCK_SIZE), randn(n, BLOCK_SIZE)
    g = ops.gram(a, b)
    if not all(torch.equal(g, ops.gram(a, b)) for _ in range(2)):
        fail("gram is not bit-identical from run to run")
    err = rel_err(g, ops.gram(a, b, impl="ref"), a.abs().T @ b.abs())
    abs_err = float((g - ops.gram(a, b, impl="ref")).abs().max())
    per_call = kernels_per_call(torch, lambda: ops.gram(a, b))
    ms = timer.ms(lambda: ops.gram(a, b))
    clean_ms = timer.ms(lambda: ops.gram(a, b), clean=True)
    word = torch.empty(1, device=dev)
    floor = timer.ms(lambda: word.zero_())   # a one-word fill: the floor
    plain = timer.ms(lambda: ops.gram(a, b, impl="ref"))
    lib_ms = timer.ms(lambda: torch.matmul(a.T, b))
    m = BLOCK_SIZE
    bms, by = bound_ms((2 * n * m + m * m) * 4, 2 * n * m * m)
    log(f"kernel gram: ({n}, {m})ᵀ({n}, {m}) | rel err {err:.3e} (tol "
        f"{KERNEL_TOL:g} of Σ|terms|), max abs err {abs_err:.3e}, "
        f"bit-identical run to run | device kernels per call {per_call:g} | "
        f"{ms:.4f} ms ({clean_ms:.4f} with L2 clean), plain {plain:.4f} ms, "
        f"library torch.matmul(a.T, b) {lib_ms:.4f} ms, bound {bms:.4f} ms "
        f"({by}) | a one-word fill under the same timer {floor:.4f} ms")
    if not err <= KERNEL_TOL:
        fail(f"gram disagrees with its plain version: {err}")
    if per_call != 1:
        fail(f"gram launched {per_call} device kernels per call, not 1")
    rows.append({"name": "gram", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/gram.cu",
                 "replaces": "src/repro/kernels/gram.py:34",
                 "count": lambda: gram_mod.LAUNCHES, "max_abs_err": abs_err,
                 "ms": ms, "plain_ms": plain, "bound_ms": bms,
                 "bound_by": by, "library_ms": lib_ms})

    # --- tsgemm: (4, 4) in CGS2 and compress, (4, 8) for the Ritz vectors -
    for width in (BLOCK_SIZE, NEV):
        small, c0 = randn(m, width), randn(n, width)
        c = ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=c0)
        if not torch.equal(c, ops.tsgemm(a, small, alpha=-1.0, beta=1.0,
                                         c0=c0)):
            fail(f"tsgemm ({m}, {width}) is not bit-identical from run to "
                 f"run")
        c_ref = ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=c0,
                           impl="ref")
        e = rel_err(c, c_ref, a.abs() @ small.abs() + c0.abs())
        if not e <= KERNEL_TOL:
            fail(f"tsgemm ({m}, {width}) disagrees with its plain version:"
                 f" {e}")
        if width == BLOCK_SIZE:
            err, abs_err = e, float((c - c_ref).abs().max())
    small, c0 = randn(m, m), randn(n, m)
    per_call = kernels_per_call(torch, lambda: ops.tsgemm(
        a, small, alpha=-1.0, beta=1.0, c0=c0))
    ms = timer.ms(lambda: ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=c0))
    clean_ms = timer.ms(lambda: ops.tsgemm(a, small, alpha=-1.0, beta=1.0,
                                           c0=c0), clean=True)
    plain = timer.ms(lambda: ops.tsgemm(a, small, alpha=-1.0, beta=1.0,
                                        c0=c0, impl="ref"))
    lib_ms = timer.ms(lambda: torch.addmm(c0, a, small, beta=1.0,
                                          alpha=-1.0))
    bms, by = bound_ms((n * m + m * m + 2 * n * m) * 4,
                       2 * n * m * m + 2 * n * m)
    log(f"kernel tsgemm: ({n}, {m})·({m}, {m}) + C0 | rel err {err:.3e} "
        f"(tol {KERNEL_TOL:g} of Σ|terms|; also checked at ({m}, {NEV})), "
        f"max abs err {abs_err:.3e}, bit-identical run to run | device "
        f"kernels per call {per_call:g} | {ms:.4f} ms ({clean_ms:.4f} with L2"
        f" clean), plain {plain:.4f} ms, library torch.addmm {lib_ms:.4f} ms,"
        f" bound {bms:.4f} ms ({by})")
    if per_call != 1:
        fail(f"tsgemm launched {per_call} device kernels per call, not 1")
    rows.append({"name": "tsgemm", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/tsgemm.cu",
                 "replaces": "src/repro/kernels/tsgemm.py:28",
                 "count": lambda: tsgemm_mod.LAUNCHES,
                 "max_abs_err": abs_err, "ms": ms, "plain_ms": plain,
                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    torch.cuda.synchronize()
    return rows


def zero_counters() -> None:
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import flashattn, gram, spmm_tile, tsgemm
    for mod in (spmm_tile, gram, tsgemm, flashattn):
        mod.LAUNCHES = 0
    spmm_tile.LAUNCHES_BF16 = 0


def read_counters(rows) -> dict:
    return {r["name"]: r["count"]() for r in rows}


def solve_main_path(torch, op, rows, label: str, launched, idle,
                    store=None, tracer=None):
    """A counted run: launch counters zeroed just before, read just
    after. Every row named in `launched` must have launched, none of
    `idle`. `store` defaults to a RAM-tier TieredStore on the card; a
    `tracer` records the solve's host spans. Returns the launches, the
    result, its true residuals and the solve's wall seconds."""
    from repro_torch.core import TieredStore, solve, true_residuals
    from repro_torch.obs import tracing
    if store is None:
        store = TieredStore(device=op.device)
    op.store = store
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (tracing(tracer) if tracer is not None
          else contextlib.nullcontext()):
        res = solve(op, NEV, method="krylov_schur", block_size=BLOCK_SIZE,
                    num_blocks=NUM_BLOCKS, tol=TOL, max_iters=MAX_ITERS,
                    store=store)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(rows)
    resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
    log(f"e2e ({label} image): solve wall {wall:.3f} s | converged "
        f"{res.converged} | restarts {res.n_restarts} | SpMM calls "
        f"{res.n_ops} | kernel launches {launches} | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"e2e ({label}): eigenvalues "
        f"{np.array2string(res.eigenvalues, precision=7)}")
    log(f"e2e ({label}): cheap residual bounds "
        f"{np.array2string(res.residuals)}")
    log(f"e2e ({label}): true residuals ‖Ax−θx‖/max(1,|θ|) "
        f"{np.array2string(resid)} (limit {RESID_TOL:g})")
    log(f"e2e ({label}): IOStats {json.dumps(res.io_stats)}")
    if not res.converged:
        fail(f"the {label} solve did not converge in {MAX_ITERS} restarts")
    vec = res.eigenvectors
    if tuple(vec.shape) != (op.n, NEV) or not bool(torch.isfinite(vec).all()):
        fail(f"eigenvectors {tuple(vec.shape)} not finite ({op.n}, {NEV})")
    if not np.all(resid <= RESID_TOL):
        fail(f"true residuals above {RESID_TOL}: {resid}")
    for name in launched:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {label} path")
    for name in idle:
        if launches[name] != 0:
            fail(f"kernel {name} launched {launches[name]} times on the "
                 f"{label} path")
    return launches, res, resid, wall


# ------------------------------------------------------------------ SAFS

def root_line(root: str) -> str:
    """The filesystem that holds `root` (the longest mount point over it
    in /proc/mounts) and its free space."""
    real = os.path.realpath(root)
    best = ("?", "?", "")
    with open("/proc/mounts") as fh:
        for line in fh:
            dev, mnt, fstype = line.split()[:3]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best[2]):
                best = (dev, fstype, mnt)
    st = os.statvfs(root)
    return (f"page root {root} on {best[1]} ({best[0]} at {best[2]}), "
            f"{st.f_bavail * st.f_frsize / 1e9:.1f} GB free")


def span_rates(tracer) -> dict:
    """Bytes over seconds of the host spans that carry the page path:
    store.get (a host-tier block assembled from pages and copied to the
    card), store.demote (a block copied to the host and split into
    pages) and safs.fill (a readahead worker's disk read), summed over
    the run."""
    out = {}
    for name in ("store.get", "store.demote", "safs.fill"):
        spans = [r for r in tracer.records()
                 if r["type"] == "span" and r["name"] == name]
        nbytes = sum(int(r["args"].get("bytes", 0)) for r in spans)
        secs = sum(r["dur"] for r in spans) / 1e6
        out[name] = {"spans": len(spans), "GB": nbytes / 1e9,
                     "s": secs, "GB/s": nbytes / secs / 1e9 if secs else None}
    return out


def safs_subspace_phase(torch, op, rows, res_ram, wall_ram) -> None:
    """The main solve with the subspace in SAFS page files on the card's
    host, the image resident on the card."""
    from repro_torch.core import TieredStore
    from repro_torch.obs import Tracer
    from repro_torch.safs import Scrubber
    root = tempfile.mkdtemp(prefix="safs_subspace_")
    try:
        log(f"safs: {root_line(root)}")
        store = TieredStore(backend="safs", backend_opts={"root": root},
                            device=op.device)
        tracer = Tracer()
        launches, res, _, wall = solve_main_path(
            torch, op, rows, "SAFS-subspace float32",
            launched=["spmm_blocksparse", "gram", "tsgemm"],
            idle=["spmm_blocksparse_bf16"], store=store, tracer=tracer)
        t0 = time.perf_counter()
        store.flush()
        flush_s = time.perf_counter() - t0
        snap = store.backend.stats_dict()
        phys, logical = snap["io"], res.io_stats
        log(f"safs subspace: solve wall {wall:.3f} s against {wall_ram:.3f}"
            f" s on the RAM tier | restarts {res.n_restarts} vs "
            f"{res_ram.n_restarts} | logical IOStats equal to the RAM "
            f"solve's: {logical == res_ram.io_stats} | physical read "
            f"{phys['host_bytes_read'] / 1e9:.3f} GB, written "
            f"{phys['host_bytes_written'] / 1e9:.3f} GB, page-cache hit "
            f"rate {phys['hit_rate']:.4f} | prefetch overlap "
            f"{snap['prefetch']['overlap_seconds']:.3f} s | final flush "
            f"{flush_s:.3f} s")
        log(f"safs subspace: page path {json.dumps(span_rates(tracer))}")
        log(f"safs subspace: stats_dict {json.dumps(snap)}")
        if logical != res_ram.io_stats:
            fail(f"SAFS solve's logical IOStats differ from the RAM "
                 f"solve's: {logical} vs {res_ram.io_stats}")
        t0 = time.perf_counter()
        scrub = Scrubber(store.backend).run_once()
        integrity = store.backend.stats_dict()["integrity"]
        log(f"safs subspace: scrub {scrub['files']} files, "
            f"{scrub['pages']} pages in {time.perf_counter() - t0:.3f} s, "
            f"corrupt {scrub['corrupt']} | integrity "
            f"{json.dumps(integrity)}")
        if scrub["corrupt"] or integrity["crc_failures"]:
            fail(f"the scrub found corrupt pages: {scrub['corrupt']}")
        store.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def safs_stream_phase(torch, dev, rows) -> None:
    """The image itself in SAFS page files: a streamed GraphOperator
    against the resident one, then the solve over it."""
    from repro_torch.core import GraphOperator, TieredStore
    from repro_torch.obs import Tracer, tracing
    tm, _ = make_graph(STREAM_LOG2, STREAM_LOG2 + 3)
    root = tempfile.mkdtemp(prefix="safs_image_")
    try:
        log(f"safs image: {root_line(root)}")
        store = TieredStore(backend="safs", backend_opts={"root": root},
                            device=dev)
        t0 = time.perf_counter()
        op = GraphOperator(tm, store=store, stream_image=True)
        store.flush()
        spill = time.perf_counter() - t0
        resident = GraphOperator(tm, device=dev)
        spans = sum(1 for c in op._spans if c.n_blocks)
        x = torch.randn((op.n, BLOCK_SIZE), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
        torch.use_deterministic_algorithms(True)
        try:
            y_s = op.matmat(x)
            y_r = resident.matmat(x)
        finally:
            torch.use_deterministic_algorithms(False)
        same = torch.equal(y_s, y_r)

        def timed(fn, reps=3):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            return statistics.median(times)

        tracer = Tracer()
        with tracing(tracer):
            t_s = timed(lambda: op.matmat(x))
        t_r = timed(lambda: resident.matmat(x))
        image = tm.nbytes_image()
        log(f"safs image: n={op.n}, image {image / 1e9:.3f} GB in "
            f"{len(op._spans)} spans ({spans} with blocks) spilled in "
            f"{spill:.2f} s | streamed matmat bit-identical to the "
            f"resident one: {same} (deterministic algorithms on) | matmat "
            f"{t_s * 1e3:.1f} ms streamed against {t_r * 1e3:.3f} ms "
            f"resident (median of 3) = {image / t_s / 1e9:.3f} GB/s of "
            f"image streamed | page path "
            f"{json.dumps(span_rates(tracer))}")
        if not same:
            fail("the streamed matmat differs from the resident one: max "
                 f"|diff| {float((y_s - y_r).abs().max())}")
        del resident, y_s, y_r
        launches, res, _, wall = solve_main_path(
            torch, op, rows, "streamed float32",
            launched=["spmm_blocksparse", "gram", "tsgemm"],
            idle=["spmm_blocksparse_bf16"], store=store)
        want = spans * res.n_ops
        log(f"safs image: solve wall {wall:.3f} s, {res.n_ops} matmats | "
            f"spmm_blocksparse launches {launches['spmm_blocksparse']} = "
            f"{spans} spans x {res.n_ops} matmats: "
            f"{launches['spmm_blocksparse'] == want} | backend io "
            f"{json.dumps(store.backend.stats_dict()['io'])}")
        if launches["spmm_blocksparse"] != want:
            fail(f"spmm_blocksparse launched {launches['spmm_blocksparse']}"
                 f" times, not {spans} spans x {res.n_ops} matmats")
        op.delete_image()
        left = [n for n in store.names() if n.startswith(op._name + "/")]
        if left:
            fail(f"delete_image left image entries: {left[:4]}")
        store.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def weyl_check(torch, op, res32, resid32, res16, resid16) -> None:
    """The bf16 solve against the float32 one. Rounding to bf16 moves each
    block entry by at most 2^-8 of itself, so ‖ΔA‖₂ ≤ 2^-8 ‖|A_blocks|‖₂
    ≤ 2^-8 · (largest row sum of |A_blocks|), and each bf16 eigenvalue
    lies within that plus its residual of an eigenvalue of the float32
    image (Weyl). The top of this spectrum is ±1, many times over (one
    per connected component), so the nearest of the float32 solve's
    eigenvalues (within its own residuals) stands for it."""
    from repro_torch.kernels import ops
    blocks = op._blocks if float(op._blocks.min()) >= 0 else op._blocks.abs()
    ones = torch.ones((op.n, 1), device=op.device)
    row_sum = float(ops.spmm_blocks(blocks, op._block_cols, op._row_ptr,
                                    ones, plan=op._plan).max())
    del blocks
    delta = 2.0 ** -8 * row_sum
    th32, th16 = res32.eigenvalues, res16.eigenvalues
    r32 = float(np.max(resid32 * np.maximum(1.0, np.abs(th32))))
    r16 = resid16 * np.maximum(1.0, np.abs(th16))
    dist = np.abs(th16[:, None] - th32[None, :]).min(axis=1)
    limit = delta + r16 + r32
    log(f"bf16 vs float32 image: eigenvalue shifts {np.array2string(dist)}"
        f" | Weyl limit {delta:.4e} (2^-8 x largest block row sum "
        f"{row_sum:.4f}) + residuals | restarts {res16.n_restarts} vs "
        f"{res32.n_restarts}, SpMM calls {res16.n_ops} vs {res32.n_ops}")
    if not np.all(dist <= limit):
        fail(f"bf16 eigenvalues beyond Weyl's bound: {dist} > {limit}")


def breakdown(torch, op, label: str, restarts: int = 3) -> None:
    """Device time and launches by kernel and copy, and host spans, over
    a short solve (the same expansion pattern as the main run, fewer
    restarts)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import TieredStore, solve
    from repro_torch.obs import Tracer, tracing
    store = TieredStore(device=op.device)
    op.store = store
    tracer = Tracer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with tracing(tracer):
            solve(op, NEV, block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
                  tol=0.0, max_iters=restarts, store=store)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats = {"spmm_blocksparse": 0.0, "gram": 0.0, "tsgemm": 0.0,
            "Memcpy HtoD": 0.0, "Memcpy DtoH": 0.0, "other": 0.0}
    counts = dict.fromkeys(cats, 0)
    others = []
    for evt in prof.key_averages():
        # device-side records only: an aten op's own entry repeats the
        # time of the kernels it launched
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        ms = float(evt.self_device_time_total) / 1e3
        key = next((k for k in cats if k != "other" and k in evt.key),
                   "other")
        cats[key] += ms
        counts[key] += evt.count
        if key == "other":
            others.append((ms, evt.count, evt.key[:60]))
    busy = sum(cats.values())
    host = {}
    for rec in tracer.records():
        if rec["type"] == "span":
            host[rec["name"]] = host.get(rec["name"], 0.0) + rec["dur"] / 1e3
    per_launch = {k: round(cats[k] / counts[k], 5)
                  for k in ("spmm_blocksparse", "gram", "tsgemm")
                  if counts[k]}
    log(f"breakdown ({label} image, {restarts} restarts, profiled): wall "
        f"{wall_ms:.1f} ms | device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall_ms:.3f} | device ms by kind "
        f"{json.dumps({k: round(v, 3) for k, v in cats.items()})}")
    log(f"breakdown ({label}): device launches by kind {json.dumps(counts)}"
        f" | in-solve ms per launch {json.dumps(per_launch)} (the combine "
        f"kernel of split SpMM rows counts as a spmm_blocksparse launch)")
    if cats["Memcpy HtoD"] > 0:
        log(f"breakdown ({label}): host tier → card "
            f"{store.stats.pass_bytes_read} subspace bytes in "
            f"{cats['Memcpy HtoD']:.3f} ms of H2D copies = "
            f"{store.stats.pass_bytes_read / cats['Memcpy HtoD'] / 1e6:.1f}"
            f" GB/s")
    log(f"breakdown ({label}): largest other device kernels (ms, count, "
        f"name): " + "; ".join(f"{ms:.3f}, {cnt}, {name}"
                               for ms, cnt, name in sorted(others,
                                                           reverse=True)[:6]))
    log(f"breakdown ({label}) host spans ms: "
        f"{json.dumps({k: round(v, 3) for k, v in sorted(host.items())})}")
    if busy <= 0:
        log("breakdown: the profiler reported no device time (not measured)")


def flash_phase(torch, timer, dev):
    """The flash kernel at yi-9b's prefill shapes and one ragged,
    non-causal shape, against its plain version in float32."""
    import torch.nn.functional as F
    from repro_torch.kernels import flashattn, ops
    gen = torch.Generator(device=dev).manual_seed(11)

    def qkv(b, h, hkv, sq, sk, d):
        return [torch.randn(shape, generator=gen, device=dev).bfloat16()
                for shape in ((b, h, sq, d), (b, hkv, sk, d),
                              (b, hkv, sk, d))]

    def err(got, q, k, v, causal):
        want = ops.flash_attention(q.float(), k.float(), v.float(),
                                   causal=causal, impl="ref")
        abs_err = float((got.float() - want).abs().max())
        return abs_err, abs_err / float(want.abs().max())

    q, k, v = qkv(1, 2, 2, 96, 160, 64)
    _, rel = err(ops.flash_attention(q, k, v, causal=False), q, k, v, False)
    log(f"kernel flash_attention: ragged (1, 2, 96, 64) x (1, 2, 160, 64) "
        f"bf16, not causal | rel err {rel:.3e} (tol {FLASH_TOL:g} of the "
        f"output's largest magnitude)")
    if not rel <= FLASH_TOL:
        fail(f"flash_attention (ragged) disagrees with its plain version: "
             f"{rel}")

    b, h, hkv, s, d = FLASH_SERVE
    q, k, v = qkv(b, h, hkv, s, s, d)
    out = ops.flash_attention(q, k, v, causal=True)
    if not torch.equal(out, ops.flash_attention(q, k, v, causal=True)):
        fail("flash_attention is not bit-identical from run to run")
    abs_err, rel = err(out, q, k, v, True)
    del out
    ms = timer.ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain = timer.ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                 impl="ref"), reps=3)
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = b * h * s * (s + 1) // 2            # (query, key) pairs kept
    nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * 2
    bms, by = bound_ms(nbytes, 4 * d * pairs, BF16_FLOPS_PER_S)
    log(f"kernel flash_attention: q {(b, h, s, d)} k/v {(b, hkv, s, d)} "
        f"bf16 causal | rel err {rel:.3e} (tol {FLASH_TOL:g} of the "
        f"output's largest magnitude), max abs err {abs_err:.3e}, "
        f"bit-identical run to run | {ms:.3f} ms = "
        f"{4 * d * pairs / ms / 1e9:.1f} TFLOP/s, plain {plain:.3f} ms, "
        f"library scaled_dot_product_attention {lib_ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by}, bf16 tensor-core peak) | PV design shipped: "
        f"{flashattn.PV_DESIGN}")
    if not rel <= FLASH_TOL:
        fail(f"flash_attention disagrees with its plain version: {rel}")
    torch.cuda.synchronize()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flashattn.cu",
            "replaces": "src/repro/kernels/flashattn.py:28",
            "count": lambda: flashattn.LAUNCHES, "max_abs_err": abs_err,
            "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def serve(torch, dev, rows, card_line: str):
    """yi-9b at full width and depth: prefill, greedy decode, and the
    full forward over the same tokens as the check. Returns the launch
    counts of the serving run (prefill and decode) by row name."""
    from repro_torch import configs
    from repro_torch.kernels import flashattn
    from repro_torch.models import transformer as tf
    cfg = configs.get("yi-9b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_model(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    # param_count leaves out the norm scales: two per layer and the last
    want = cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model
    log(f"serve: yi-9b {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, {n_params} parameters "
        f"(param_count {cfg.param_count()} + norm scales), "
        f"{cfg.param_dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    if n_params != want:
        fail(f"yi-9b has {n_params} parameters, not {want}")
    prompt = np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    prompt = torch.from_numpy(prompt).to(dev)
    cache_len = SERVE_PROMPT + SERVE_DECODE

    # warm-up at a short prompt: cuBLAS picks its kernels outside the
    # timed, counted run
    _, wc = tf.prefill_with_cache(params, cfg, prompt[:, :128],
                                  cache_len=130)
    tf.decode_step(params, cfg, wc, prompt[:, :1], 128)
    del wc
    torch.cuda.synchronize()

    zero_counters()
    t0 = time.perf_counter()
    logits, cache = tf.prefill_with_cache(params, cfg, prompt,
                                          cache_len=cache_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = flashattn.LAUNCHES
    tok = logits[:, -1:].argmax(-1).int()
    del logits
    generated, dec_logits = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SERVE_PROMPT, cache_len):
        generated.append(tok)
        out, cache = tf.decode_step(params, cfg, cache, tok, t)
        dec_logits.append(out[:, 0])
        tok = out.argmax(-1).int()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = read_counters(rows)
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: prefill {SERVE_BATCH} x {SERVE_PROMPT} tokens in "
        f"{t_prefill:.3f} s = {SERVE_BATCH * SERVE_PROMPT / t_prefill:.0f} "
        f"tokens/s | decode {SERVE_DECODE} steps of {SERVE_BATCH} tokens: "
        f"{t_decode / SERVE_DECODE * 1e3:.2f} ms/step = "
        f"{SERVE_BATCH * SERVE_DECODE / t_decode:.1f} tokens/s | peak "
        f"device memory {peak / 1e9:.2f} GB | kernel launches {launches} | "
        f"{card_line}")
    if after_prefill != cfg.n_layers or launches["flash_attention"] != \
            cfg.n_layers:
        fail(f"flash_attention launched {after_prefill} times in the "
             f"prefill and {launches['flash_attention']} in prefill and "
             f"decode, not {cfg.n_layers}")

    seq = torch.cat([prompt] + generated, dim=1)
    before = flashattn.LAUNCHES
    full = tf.logits_fn(params, cfg, seq)[:, SERVE_PROMPT:]
    torch.cuda.synchronize()
    if flashattn.LAUNCHES - before != cfg.n_layers:
        fail(f"the full forward launched flash_attention "
             f"{flashattn.LAUNCHES - before} times, not {cfg.n_layers}")
    dec = torch.stack(dec_logits, dim=1)
    if tuple(dec.shape) != (SERVE_BATCH, SERVE_DECODE, cfg.vocab_size) or \
            not bool(torch.isfinite(dec).all()) or \
            not bool(torch.isfinite(full).all()):
        fail(f"decode logits {tuple(dec.shape)} not finite "
             f"({SERVE_BATCH}, {SERVE_DECODE}, {cfg.vocab_size})")
    diff = dec - full
    rel = float((diff.norm(dim=-1) / full.norm(dim=-1)).max())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    log(f"serve: decode vs full forward over {seq.shape[1]} tokens at the "
        f"{SERVE_DECODE} generated positions: max ‖Δ‖/‖logits‖ {rel:.4f} "
        f"(limit {SERVE_TOL:g}), max |Δ| {float(diff.abs().max()):.4f} of "
        f"max |logits| {float(full.abs().max()):.3f}, greedy tokens agree "
        f"at {agree:.3f} of positions")
    if not rel <= SERVE_TOL:
        fail(f"decode logits disagree with the full forward: {rel}")
    del full, diff, dec, cache
    serve_breakdown(torch, tf, params, cfg, prompt)
    return launches


def _device_ms_by_kind(prof, kinds):
    """Device ms per kind (first kind whose name pattern matches a kernel
    name, else "other") and the largest "other" kernels."""
    cats = {k: 0.0 for k in kinds}
    cats["other"] = 0.0
    others = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        ms = float(evt.self_device_time_total) / 1e3
        key = next((k for k, pats in kinds.items()
                    if any(p in evt.key for p in pats)), "other")
        cats[key] += ms
        if key == "other":
            others.append((ms, evt.count, evt.key[:60]))
    return cats, sorted(others, reverse=True)[:5]


def serve_breakdown(torch, tf, params, cfg, prompt, steps: int = 4) -> None:
    """Device time by kind over one profiled prefill and a few decode
    steps, beside their wall time (the idle share says how far the host
    holds the card back)."""
    from torch.profiler import ProfilerActivity, profile
    kinds = {"flash_attention": ("flash_attention_kernel",
                                 "flash_wgmma_kernel"),
             "gemm": ("gemm", "Gemm", "nvjet", "sm90_xmma", "cutlass"),
             "memcpy": ("Memcpy", "Memset")}
    cache_len = prompt.shape[1] + steps
    for phase in ("prefill", "decode"):
        if phase == "decode":
            _, cache = tf.prefill_with_cache(params, cfg, prompt,
                                             cache_len=cache_len)
            tok = prompt[:, -1:]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                tf.prefill_with_cache(params, cfg, prompt,
                                      cache_len=cache_len)
            else:
                for t in range(prompt.shape[1], cache_len):
                    tf.decode_step(params, cfg, cache, tok, t)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        cats, others = _device_ms_by_kind(prof, kinds)
        busy = sum(cats.values())
        n = 1 if phase == "prefill" else steps
        log(f"serve breakdown ({phase}, profiled, {n} call(s)): wall "
            f"{wall / n:.2f} ms per call | device busy {busy / n:.2f} ms, "
            f"idle share {1 - busy / wall:.3f} | device ms per call by "
            f"kind {json.dumps({k: round(v / n, 3) for k, v in cats.items()})}"
            f" | largest other kernels (ms, count, name): "
            + "; ".join(f"{ms:.3f}, {cnt}, {name}"
                        for ms, cnt, name in others))
        host = sorted(((float(e.self_cpu_time_total) / 1e3, e.count,
                        e.key[:40]) for e in prof.key_averages()
                       if "CUDA" not in str(getattr(e, "device_type", ""))),
                      reverse=True)[:6]
        log(f"serve breakdown ({phase}): largest host ops (self ms, count, "
            f"name): " + "; ".join(f"{ms:.2f}, {cnt}, {name}"
                                   for ms, cnt, name in host))
        if phase == "decode":
            del cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def small_reference_check(torch, dev) -> None:
    from repro_torch.core import GraphOperator, TieredStore, solve
    from repro_torch.graphs import pack_tiles, rmat_spectral, to_dense
    n = 1200
    r, c, v = rmat_spectral(n, 10000, seed=5)
    tm = pack_tiles(n, n, r, c, v, block_shape=BLOCK,
                    min_block_nnz=MIN_BLOCK_NNZ)
    store = TieredStore(device=dev)
    res = solve(GraphOperator(tm, store=store), NEV, block_size=BLOCK_SIZE,
                tol=1e-6, max_iters=200, store=store)
    ev = np.linalg.eigvalsh(to_dense(n, r, c, v).astype(np.float64))
    ev = np.sort(ev[np.argsort(-np.abs(ev))][:NEV])
    err = float(np.max(np.abs(np.sort(res.eigenvalues) - ev) / np.abs(ev)))
    log(f"small input: n={n} converged {res.converged} | max rel err vs "
        f"dense eigvalsh {err:.3e} (tol 1e-5)")
    if not (res.converged and err <= 1e-5):
        fail("small-input spectrum disagrees with the dense reference")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.core import GraphOperator

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card(torch)
    build_s = build()
    dev = torch.device("cuda", 0)

    tm, _ = make_graph(N_LOG2, NNZ_LOG2)
    t0 = time.perf_counter()
    op = GraphOperator(tm, device=dev)
    torch.cuda.synchronize()
    log(f"upload: image to the card in {time.perf_counter() - t0:.2f} s")

    timer = Timer(torch, dev)
    rows = kernel_phase(torch, op, timer)   # spmm_blocksparse, gram, tsgemm
    solver_rows = [r["name"] for r in rows]

    small_reference_check(torch, dev)   # also warms cuBLAS / cuSOLVER
    launches, res32, resid32, wall32 = solve_main_path(
        torch, op, rows, "float32", launched=solver_rows, idle=())
    for r in rows:
        r["launches"] = launches[r["name"]]
    breakdown(torch, op, "float32")

    # the bf16 image: the uploaded blocks cast on the card, then freed
    t0 = time.perf_counter()
    op16 = op.astype(torch.bfloat16)
    torch.cuda.synchronize()
    log(f"bf16 image: blocks cast on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(8)
    rows.insert(1, spmm_phase(torch, op16, timer, torch.randn(
        (op.n, BLOCK_SIZE), generator=gen, device=dev)))
    launches, res16, resid16, _ = solve_main_path(
        torch, op16, rows, "bf16", launched=["spmm_blocksparse_bf16",
                                             "gram", "tsgemm"],
        idle=["spmm_blocksparse"])
    rows[1]["launches"] = launches["spmm_blocksparse_bf16"]
    weyl_check(torch, op, res32, resid32, res16, resid16)
    breakdown(torch, op16, "bf16")
    del op16
    safs_subspace_phase(torch, op, rows, res32, wall32)
    del op, tm                           # free the 12.86 GB image
    gc.collect()
    torch.cuda.empty_cache()
    safs_stream_phase(torch, dev, rows)

    rows.append(flash_phase(torch, timer, dev))
    launches = serve(torch, dev, rows, card_line)
    rows[-1]["launches"] = launches["flash_attention"]

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"total: {time.perf_counter() - t_start:.1f} s (build "
        f"{build_s:.1f} s)")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
