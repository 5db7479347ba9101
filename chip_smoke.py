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
     timed alone; every SpMM row (here, 8 and 14) also prints its share
     of the bound, its device kernels per call counted by the profiler
     (the ring kernel, plus the combine kernel when the plan splits rows:
     any other count fails) and the ring's launch as the card reports it
     (stages, shared bytes a CTA, CTAs an SM, registers); gram and tsgemm
     bit-identical run to run, with their device kernels per call
     counted by the profiler (one each);
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
 10. SAFS streamed image: `rmat_graph(2**15, 2**18, seed=1,
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
     then at hubert-xlarge's head dim 80 (q, k, v (2, 16, 2048, 80)),
     bf16 and float32, causal and not, each within FLASH_TOL (bf16) or
     FLASH_F32_TOL (float32) of the plain version, the bf16 non-causal
     one (hubert's prefill) timed the same way;
 12. yi-9b serving at full width and all 48 layers in bf16, weights drawn
     on the card by `init_model` from a seed: 4 requests of 2,048 prompt
     tokens through `prefill_with_cache(..., cache_len=2080)`, then 32
     greedy `decode_step`s, with the launch counters zeroed just before
     and read just after (48 flash launches per prefill); then one
     `logits_fn` over prompt plus generated tokens, whose logits at the
     generated positions must agree with the decode logits;
 13. serve breakdown: one profiled prefill and 4 profiled decode steps
     (device time by kind, idle share, the largest host ops).

The rest of the solver family, run after 9 (14-18) and after 10 (19);
every solve on a fresh RAM-tier store with the launch counters zeroed
just before and read just after, each solver kernel launched at least
once, and each width row's launches taken from the solve named here:
 14. widths (A): SpMM at k = 1, 2, 8 over the rmat-1M image, gram at
     (n, b)ᵀ(n, b) and tsgemm at (n, b)·(b, b) + C0 for b = 2, 8, and gram
     at LOBPCG's (n, 16)ᵀ(n, 16) and (n, 24)ᵀ(n, 24), n = 2^20: against
     the plain version, bit-identical run to run, one device kernel per
     call (gram, tsgemm), the kernel variant that ran printed, timed as
     in 4 beside the library call and the bound; each gram also as
     gram(A, A), exactly symmetric and bit-identical over three calls;
     each tsgemm bit-equal to the generic kernel on the same data 4 bytes
     off a 16-byte boundary;
 15. Lanczos (B): `solve(op, 8, method="lanczos", block_size=4)`; each
     Ritz value within its residual bound of one of phase 5's (less that
     one's bound); its IOStats beside Krylov–Schur's;
 16. LOBPCG (C): `solve(op, 8, method="lobpcg", tol=1e-5,
     max_iters=300)`: passes 3·it + 1 and pass bytes (10 + 14·(it − 1) +
     2)·n·b·4 exactly, less 4·n·b·4 per iteration whose P deflated
     (printed); converged or not (printed); its top eigenvalues within
     their true residuals of phase 5's positive ones (less their bounds);
     bytes per converged pair beside Krylov–Schur's; SpMM at k = 8, gram
     at 8, 16 and 24 columns, tsgemm at (8, 8); then a profiled LOBPCG of
     3 iterations: device ms and launches by kernel and variant (SpMM,
     the COO gather and index_add_, gram, tsgemm, H2D, D2H), the COO path
     event-bracketed, the idle share and the largest host spans;
 17. Chebyshev (D): `estimate_spectral_range` (SpMM at k = 1), a degree-10
     `ChebyshevFilterOperator` damping [lo, half the smallest of phase
     5's positive eigenvalues], Krylov–Schur on it for that many pairs:
     untransformed eigenvalues at rtol 1e-5 of phase 5's, true residuals
     ≤ 1e-4; one profiled application with the COO side path's share of
     device time (its kernels bracketed by CUDA events);
 18. SVD (E), after the symmetric image is freed: `rmat_graph(2**20,
     2**23, seed=1, symmetric=False)`, A and Aᵀ packed as in 3 (0/1
     entries), `NormalOperator.from_tiles`, `solve(a, 4, method="svd",
     block_size=2, at_op=at)`: converged, σ finite and descending,
     ‖A v − u σ‖/σ ≤ 1e-3 with v = Aᵀu/σ; SpMM, gram and tsgemm at 2;
 19. shift-invert (F), on the resident 2^15 graph of 10:
     `ShiftInvertOperator(op, σ, inner_solver="cg")` with σ 0.05 below
     `estimate_spectral_range`'s low end, `which="LM"`: untransformed
     eigenvalues at rtol 1e-5 of a `which="SA"` Krylov–Schur solve's, true
     residuals ≤ 1e-4, inner CG iterations printed.

Checkpoint/resume, tracing and the quickstart, after 17 on the rmat-1M
image (20-22) and after 19 (23); every solve with the launch counters
zeroed just before and read just after, each solver kernel launched:
 20. suspend and resume on the RAM tier, under deterministic algorithms
     (the COO side path's `index_add_` then sums in a fixed order; the
     CholQR's small cuBLAS products need `CUBLAS_WORKSPACE_CONFIG`, set
     below before CUDA starts): phase 5's solve uninterrupted, again with
     `CheckpointPolicy(every_restarts=1)`, then with a stand-in guard
     armed after restart 2, which must raise `SolveSuspended`, then
     `solve(..., resume=root)`: eigenvalues and eigenvectors bit-equal to
     the uninterrupted solve's, the same restarts, `resumed_step` the
     suspension's step, true residuals ≤ 1e-4; the same for phase 16's
     LOBPCG (`every_restarts=5`, the guard armed after iteration 10): θ
     and X bit-equal, the same iterations; bytes and seconds per snapshot
     (`ckpt.save` spans), the root's filesystem, the walls with and
     without snapshots;
 21. crash and resume on SAFS: phase 9's solve with a `FaultPlan` crash
     at the third `ckpt.save`, which must raise `CrashPoint` with state
     steps [1, 2] and step 3 among the page snapshots; a resume into a
     fresh page root from step 2, converged with true residuals ≤ 1e-4,
     each eigenvalue at rtol 1e-5 of the nearest of phase 5's (±1 are
     eigenvalues many times over), restarts at most one above
     phase 9's; then one bit flipped in a page file of the crashed store
     at rest, a scrub that must quarantine that page, and
     `repair_from_checkpoint` from the surviving snapshot, which must
     repair it (a second scrub clean, the integrity counters printed);
 22. traced solve: phase 5's solve with `trace=<path>` beside an untraced
     one: `repro_torch.obs.report.validate` must find no problem and
     `reconcile(...)["exact"]` must hold; the walls and the report's
     phase table printed;
 23. quickstart: `repro_torch.examples.quickstart` on the card (n = 5,000
     against scipy's eigsh), converged, its IOStats printed.

The shared-store layer and the paper's measurement ladders
(`repro_torch.benchmarks`), after 22 on the rmat-1M image (24-25) and
after 23 (26-28); each with the launch counters zeroed just before and
read just after, and every kernel it names launched:
 24. namespaces: phase 5's solve on a fresh RAM tier (solo), then in two
     namespaces of one CUDA TieredStore one after the other, then in two
     more from two threads at once, all under deterministic algorithms:
     each converged with true residuals ≤ 1e-4 and eigenvalues at rtol
     1e-5 of phase 5's, each namespace's IOStats split equal to the solo
     solve's to the byte, the splits summing to the store's counters
     exactly, `drop_namespace` freeing the namespace's device bytes and
     keeping its stats; SpMM, gram and tsgemm launched in the threads;
 25. SpMM ladder (bench_spmm, Fig. 6-8) over phase 3's graph: the coo
     and +hybrid rungs (the +blocking image, every entry in a 64×64
     block, is left out at 2^20 and its size printed), then the whole
     ladder over `rmat_graph(2**18, 2**21, seed=1, symmetric=True)`
     normalized; every rung at k = 1 and 4 within 1e-5 of Σ|terms| of
     its plain version (`bench_spmm.validate`), the SpMM kernel launched;
     the coo rung's time beside phase 4's SpMM kernel, the solver
     image's COO remainder alone and its whole matmat;
 26. TAS ladder (bench_tasops, Fig. 9-11) at n = 2^20, b = 4, m = 16,
     64, 256: `validate`, and io_bytes the same whole number of n·b·4
     blocks as a CPU run at n = 6,000 gives; gram and tsgemm launched;
 27. subspace passes (bench_subspace_io) at n = 2^20, b = 4, nb =
     SUBIO_NB, the e2e and SAFS parity solves at the reference's sizes:
     `validate`; SpMM, gram and tsgemm launched;
 28. SAFS ladder (bench_safs) at n = 2^20, b = 4, m = SAFS_BENCH_M, the
     read ladder over 8 files of 64 MiB beside the bare `preadv` floor,
     the temporary directory's filesystem printed; gram and tsgemm
     launched.

The eigensolver service (`repro_torch.serve`), after 28:
 29. serve: the eigensolver service over one SAFS store on the card.
     `build_service(backend="safs", device="cuda")` under a new temporary
     directory (page root and checkpoint root), a 512 MiB device budget
     with a 64 MiB `min_share`, phase 9's 64 MiB page cache, two
     sessions at a time; the launch counters zeroed just before the jobs
     are submitted and read just after `drain()`. Jobs, as the serve
     launcher's demo submits them (the background first, the rush job
     once a running job has reported a step): bg-embed (eigsh over phase
     3's graph, nev 8, block 4, 8 blocks, tol 1e-5, priority 1),
     bg-lobpcg (`rmat_graph(2**18, 2**21, seed=1)`, nev 4, block 8, tol
     1e-5, priority 0), bg-cluster (a 2^16-vertex planted partition of 4
     classes, seed 0, tol 1e-6, priority 0) and rush (`rmat_graph(2**16,
     2**19, seed=1)`, nev 4, priority 5). Gates: `validate_report` finds
     nothing (every job DONE, per-namespace physical bytes summing to the
     backend's exactly), the report is JSON-clean, at least one
     preemption and every preempted job resumed with a `resumed_step`,
     rush waiting less than bg-cluster, every job converged; after
     `drain()` and the counters' read, each job's SpMM at every width the
     phase launched it at, and gram and tsgemm at every shape, held
     against their plain versions on the job's own image and
     eigenvectors (KERNEL_TOL of Σ|terms|), and its true residuals ≤
     1e-4·max(1, |θ|) through the kernel and through the plain SpMM,
     their gap within KERNEL_TOL of ‖A|V|‖; eigenvalues at rtol 1e-5 of
     a private serial `SolveSession` of the same spec on a CUDA RAM-tier
     store
     (bg-embed's runs after phase 25 over phase 3's image, which is the
     job's graph, and the served job's image must have its blocks and
     COO entries), purity > 0.9, SpMM, gram and tsgemm launched, no
     session operator referenced after `drain()` and allocated device
     memory back within the smallest R-MAT image of where it was. Then a
     `PagedKVCache(session_id="kv")` on the same store at yi-9b's KV
     geometry (4 KV heads, head_dim 128, pages of 128, bf16, 8 hot
     pages): 4,096 tokens, 24 pages on the host tier, one 32-head attend
     within 2^-8 of dense attention, its host reads in its namespace's
     IOStats, `close()` leaving the solver namespaces as they were; and
     `repro_torch.launch.serve.main(["--demo", "--device", "cuda", ...])`,
     which must return 0 with a preemption. Printed: the per-job table
     (wall, queue wait, preemptions, resumes, sha, the arbiter's
     allotments), the wall and the problem builds in it, the preemption
     latency from flag to `SolveSuspended`, physical bytes per
     namespace and peak device memory.

The sharded layer (`repro_torch.dist`), after 25 on phase 3's graph:
 30. 30a, one rank over NCCL: a one-rank world, `DistOperator` on a
     (1, 1, 1) mesh over phase 3's graph (its panel packed as the
     solver's image), phase 5's solve over it through eigsh's fused
     expansion with the launch counters zeroed just before and read just
     after: converged, eigenvalues within rtol 1e-5 of phase 5's, true
     residuals ≤ 1e-4, fused steps taken, SpMM, gram and tsgemm launched,
     every collective's bytes equal to the design's count; its wall
     beside phase 5's and a profiled breakdown as in 7; then, in that
     world, the one-rank run of
     `rmat_graph(2**18, 2**21, seed=1, symmetric=True)` normalized.
     30b, eight ranks sharing the card over gloo (a (2, 2, 2) mesh,
     `dist.spawn` of `examples.dist_eigen_e2e.run_ranks`, payloads staged
     through pinned host memory): the same solve of that graph from the
     same natural-space start block, eigenvalues within rtol 1e-5 of the
     one-rank run's, the pod-compressed run over 3 restarts (last
     deviation < 2e-2 and not above twice the smallest after the first)
     and the compressed stream (within 5e-3); every rank's kernel
     launches (SpMM, gram and tsgemm each > 0), collective bytes equal to
     the design's count, host-staged bytes, peak device memory and the
     share of its entries left to the COO remainder; after its solve each
     rank holds its SpMM (panel image, padded columns), gram and tsgemm
     (at (n_pad/8, 4)) and their plain versions against float64 products
     within serve_kernel_check's limits; a rank that fails or hangs fails
     the phase at the world's timeout.

The other LM families, after 13:
 31. lm-families: one model of each of the other nine architectures at
     its published widths in bf16, weights drawn on the card from a seed
     (depth cut only where the card or the time limit forces it, as
     LM_FAMILIES says, each cut logged), each freed before the next.
     Each decoder serves its prompt through `prefill_with_cache` and
     greedy `decode_step`s, hubert (an encoder) runs one forward over
     frames; the launch counters are zeroed just before and read just
     after. Gates: the parameter count equals `param_count()` plus the
     leaves it leaves out (`uncounted_params`); finite logits; flash
     launched once per self-attention layer of kind "attn" in the
     prefill or forward (causal, or not for hubert; swa, cross, SSM and
     RG-LRU layers are plain PyTorch) and never in decode; the decode
     logits against a full forward over the same tokens at the
     generated positions, max ‖Δ‖₂/‖logits‖₂ ≤ SERVE_TOL (a forward of
     plain attention runs on whole Q_CHUNKs: the tokens past the
     generated ones are filler, which causal layers do not let the
     compared positions see). For the MoE models that gate runs on a
     short prompt at capacity_factor = n_experts / top_k (nothing
     dropped), positions where a layer routed a token to other experts
     in the two runs left out, and only where the router's margin at
     the k-th place was below MOE_TIE_MARGIN in a run (a rounding, not a
     fault); the served run at the config's 1.25 logs how many routings
     it dropped. Logged per model: weight draw seconds, prefill seconds
     and tokens/s, decode ms/step, peak device memory; for grok a timed
     split of one MoE layer's prefill into routing, dispatch, expert
     GEMMs and combine.

Training, after 31:
 32. train. 32a, the flash backward (`csrc/flashattn_bwd.cu`: bf16 on
     wgmma + TMA, float32 on the CUDA cores) against its plain version
     on the same inputs and against the float64 gradient of the exact
     forward (FLASH_BWD_TOL), bit-identical run to run, at qwen2-1.5b's
     training layer, yi-9b's prefill shape, hubert's d = 80 and a
     float32 shape; the forward's LSE against the plain one and its O
     unchanged by storing LSE; the qwen2 and float32 shapes timed with
     L2 flushed beside the plain backward, SDPA's backward (the library
     row), the bound (5 products) and the design's floor (7: dQ
     recomputes S and dP, so that no sum needs an atomic), each logged
     with its device kernels per call and device ms by kernel; the
     float32 forward at the float32 shape timed the same way beside its
     plain version, SDPA's forward and its bound (2 products). 32b,
     qwen2-1.5b cut to 2 layers at
     full widths in float32 with remat: every leaf's gradient over one
     sequence of 1,024 tokens on the card (kernels) against the host
     CPU's (plain versions), and the flash launches (2 forward per layer
     under remat, 1 backward). 32c, `train.trainer.train` on qwen2-1.5b
     at its published size (bf16 weights, float32 AdamW moments, remat)
     for 6 steps on the synthetic pipeline at 4 x 4,096 tokens in 2
     microbatches, the counters zeroed just before and read after each
     step: finite losses and grad norms, step 0's loss against `loss_fn`
     without grad on the same weights and batch, flash launches per step
     exactly layers x microbatches x 2 forward and layers x microbatches
     backward; logged: the loss trajectory, median step seconds and
     tokens/s, peak device memory, model flops per step and their share
     of the bf16 peak, the final checkpoint (on /dev/shm when it has
     room) with its bytes and seconds, and one more step profiled by
     kind (GEMMs, flash forward, flash backward with its kernels per
     call, optimizer, elementwise) with its idle share, each flash
     forward call marked so that the log names any whose kernel record
     the profile lost. 32d, at 2 layers under deterministic
     algorithms: [train 4] against [train 2, restore, train 2], every
     leaf of (params, AdamWState) bit for bit.

The curvature spectrum, after 32:
 33. curvature. qwen2-1.5b at its published widths cut to 2 layers, in
     float32 (a Hessian in bf16 is noise), remat on as published (a
     double backward recomputes each layer), weights drawn on the card
     from a seed, one batch of 2 x 128 tokens:
     `examples.curvature_spectrum.hessian_operator` (`HvpOperator`, about
     3.3e8 coordinates, n_logical printed) and `eigsh(op, 4,
     block_size=2, tol=1e-3, which="LA")` on the card, the subspace on
     the RAM tier as in every solve (the newest block on the card). One
     HVP column against the same column on the host CPU (plain versions)
     within CURV_HVP_TOL of max |Hv|, and against the same column with
     remat off on the card (same tolerance; bit equality printed);
     symmetry |uᵀHv − vᵀHu| against ‖u‖‖Hv‖;
     the solve converged, every Ritz pair's true residual within
     CURV_RESID_TOL; the float32 flash forward and backward, gram and
     tsgemm launched in the solve (counters zeroed just before, read
     just after), the plain second-order route's calls counted
     (`flashattn.GRAD2_CALLS`). Logged with the card line: ms per HVP
     column, the solve's wall time and restarts, its host spans (matmat,
     store.get, store.demote) and host-tier bytes, peak device memory.

Sharded training (`repro_torch.train.sharded`), after 33:
 34. sharded train. qwen2-1.5b at its published widths cut to 2 layers,
     float32 (so that the comparison can be tight), remat on as
     published, a global batch of 2 x 1,024 tokens, 3 steps, weights
     from one seed: (a) the unsharded `train()`; (b) `train(mesh=)` in a
     one-rank NCCL world on a (1, 1, 1) mesh, in this process; (c) four
     gloo ranks sharing the card on a (1, 2, 2) mesh (`dist.spawn`, each
     rank its own CUDA context, every collective staged through pinned
     host memory). Gates: (b)'s losses and grad norms within rtol 1e-6 of
     (a)'s, both under deterministic algorithms (bit equality printed:
     the embedding's backward adds with atomics otherwise); (c)'s within
     rtol 1e-4 and its final parameters (from the checkpoints, which
     every run writes in the unsharded format) within 2·lr·steps + 1e-5
     of (a)'s; every rank's
     parameter and moment bytes equal to the specs' count; each step's
     collective bytes equal to `Sharding.analytic_bytes`; staged bytes
     nonzero on every gloo rank; the float32 flash forward and backward
     launched exactly layers x 2 and layers times a step on every rank
     of every run (remat's recompute, as in 32b), each process's
     counters zeroed just before its run and read just after. Printed:
     each run's step seconds (for (c), ranks sharing one card over
     staged gloo: not a speed figure for training on several cards),
     peak device memory per rank, collective bytes by kind, and the
     phase's wall time.

The dry run (`repro_torch.launch.dryrun`), after 34:
 35. dry run against the card. (a) Phase 34(c)'s program traced on a
     `DryMesh` for each of its four ranks: each rank's traced step
     collective bytes by kind must equal what that gloo rank's
     `Mesh.bytes` counted in each of 34(c)'s steps (staging aside), and
     its arguments' parameter and moment bytes what it held. (b) The dry
     run of 32c's step (qwen2-1.5b at published size, 4 x 4,096 tokens,
     2 microbatches, one rank): its predicted peak (arguments + temp)
     and traced FLOPs printed beside 32c's measured peak device memory
     and model flops, with no gate (the caching allocator is not
     modelled). (c) In a one-rank NCCL world, the sharded prefill and 2
     decode steps of 34's 2-layer model (`train.sharded.serve_rows`)
     bit-equal to the unsharded ones under deterministic algorithms,
     the float32 flash forward launched 2 x layers times (counters
     zeroed just before, read just after). (d) `--all --both-meshes`
     run in a subprocess, one process a core: every reference cell's
     record, none an error, each with 256 or 512 devices, collective
     bytes and a step-time bound above 0 and traced collective bytes
     equal to the design's where it has one; its wall printed.

Then one JSON line of kernels (the four PR-15 rows, the nine width rows
of 14, flash attention at yi-9b's shape and at hubert's head dim 80, the
flash backward at qwen2's training layer (its launches 32c's) and in
float32 (its launches 32b's), the float32 forward at 32b's shape (its
launches 32b's); each row's `serve_launches` the launches
at its width in phase 29, its `dist_launches` those in phase 30a, its
`shard_launches` those of phase 34's runs, every rank's), the card
line, and the final result line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# deterministic algorithms (phases 10 and 20) refuse cuBLAS calls unless
# this is set before cuBLAS makes its first handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# the streamed-image graph: rmat_graph(2**k, 2**(k+3)); every matmat pages
# the whole image through the SAFS page path, 4 KiB at a time, so the
# solve's time follows the image's size: at k = 16 it took 101.7-145.7 s
# on the card, k = 15 keeps the phase near a minute
STREAM_LOG2 = 15

# the rest of the solver family (phases 14-19): the widths it gives the
# kernels, LOBPCG's tolerance and iteration cap, the Chebyshev filter's
# degree, the SVD's singular triplets and block, and shift-invert's gap
# below the estimated spectrum and inner CG (float32 CG's recursive
# residual reaches 1e-7; the Rayleigh quotients of the untransform are
# accurate to its square)
FAMILY_SPMM_K, FAMILY_B = (1, 2, 8), (2, 8)
LOBPCG_TOL, LOBPCG_MAX = 1e-5, 300
CHEB_DEGREE = 10
SVD_NSV, SVD_BLOCK, SVD_RESID_TOL = 4, 2, 1e-3
SI_GAP, SI_CG_TOL, SI_CG_MAXITER = 0.05, 1e-7, 400

# the ladders' subspace widths at n = 2^20 (phases 27-28), cut from the
# reference's nb = 16 and m = 64 to keep the new phases near two minutes:
# both page the subspace through Python at 0.1-0.9 GB/s
SUBIO_NB, SAFS_BENCH_M = 8, 32

# the eigensolver service (phase 29): one SAFS store, a device budget and
# a floor per session sized to the jobs (one (2^20, 4) float32 block is
# 16 MiB; the reference's defaults, 32 MiB and 1 MiB, were made for n ≈
# 1,200), phase 9's page cache, two sessions at a time
SERVE_BUDGET, SERVE_MIN_SHARE, SERVE_CACHE = 512 << 20, 64 << 20, 64 << 20
SERVE_MAX_CONCURRENT = 2
# the background jobs, submitted first (bg-embed is phase 5's graph and
# block, with the job's seed and `which`), then the rush job once a
# running job has reported a step, as the serve launcher's demo does
SERVE_JOBS = (
    dict(job_id="bg-embed", kind="eigsh", n=2 ** N_LOG2,
         nnz=2 ** NNZ_LOG2, seed=GRAPH_SEED, nev=NEV, block_size=BLOCK_SIZE,
         options={"num_blocks": NUM_BLOCKS}, tol=TOL, max_iters=MAX_ITERS,
         priority=1),
    dict(job_id="bg-lobpcg", kind="lobpcg", n=2 ** 18, nnz=2 ** 21, seed=1,
         nev=4, block_size=8, tol=1e-5, max_iters=300, priority=0),
    dict(job_id="bg-cluster", kind="cluster", n=2 ** 16, k_classes=4,
         seed=0, nev=4, block_size=4, tol=1e-6, max_iters=80, priority=0),
)
SERVE_RUSH = dict(job_id="rush", kind="eigsh", n=2 ** 16, nnz=2 ** 19,
                  seed=1, nev=4, block_size=4, tol=1e-5, max_iters=60,
                  priority=5)
SERVE_PURITY = 0.9
# the paged KV cache on the service's store, at yi-9b's KV geometry: 4,096
# tokens fill 32 pages, of which the 24 oldest spill to the host tier
KV_GEOM = dict(page_size=128, n_kv_heads=4, head_dim=128, hot_pages=8,
               dtype="bfloat16")
KV_TOKENS, KV_QUERY_HEADS = 4096, 32

# the sharded layer (phase 30): 30b's world of DIST_SHAPE ranks sharing
# the card over gloo, on rmat_graph(2**DIST_LOG2, 2**DIST_NNZ_LOG2, seed=1,
# symmetric=True) normalized, every solve of it from the natural-space
# block of DIST_X0_SEED; the reference's pod_compressed and compressed
# gates (tests/test_distributed.py:127-137) over DIST_POD_RESTARTS
# restarts; every world bounded by DIST_TIMEOUT seconds
DIST_SHAPE, DIST_LOG2, DIST_NNZ_LOG2, DIST_X0_SEED = (2, 2, 2), 18, 21, 0
DIST_POD_RESTARTS, DIST_POD_TOL, DIST_COMP_TOL = 3, 2e-2, 5e-3
DIST_TIMEOUT = 600

# flash attention at yi-9b's prefill shapes (B, H, Hkv, S, d), bf16
FLASH_SERVE = (4, 32, 4, 2048, 128)
# one bf16 rounding of the output is half an ulp, 2^-9 to 2^-8 of the
# value (2^-8 only just above a power of two); the f32 arithmetic of
# kernel and plain version differ by ~1e-6
FLASH_TOL = 2.0 ** -8          # of the output's largest magnitude
# float32 inputs: kernel and plain version differ only in the order of
# their float32 sums and in exp2 against exp (tests/test_torch_gpu.py's
# float32 limit)
FLASH_F32_TOL = 2e-5           # of the output's largest magnitude

# yi-9b serving: prompt tokens per request, requests, decode steps, seed
SERVE_PROMPT, SERVE_BATCH, SERVE_DECODE, SERVE_SEED = 2048, 4, 32, 0
# decode (one query against the cache, weights rounded to bf16, GEMMs of
# 4 rows) and the full forward (flash, weights kept f32, GEMMs of 8,320
# rows) round differently at ~10 places in each of 48 layers; as a random
# walk of bf16 roundings that is about sqrt(480) * 2^-9 = 0.043 of the
# logits' norm, and twice that is the limit
SERVE_TOL = 0.1                # max over positions of ‖Δ‖₂ / ‖logits‖₂

# flash at hubert-xlarge's prefill shape (B, H, Hkv, S, d)
FLASH_HUBERT = (2, 16, 16, 2048, 80)

# the other LM families (phase 31): (config, layers on the card or None
# for all, requests, prompt tokens, decode steps). Widths are the
# published ones; depth is cut where the bf16 weights would not fit the
# card's 80 GB beside the activations, or would take the phase past its
# ~150 s: mistral-large 4 of 88 layers (12.7 GB), grok-1 2 of 64 (23
# GB), arctic 1 of 35 (28 GB: 128 experts of 3 x 7168 x 4864),
# llama-3.2-vision one pattern of 5 (4 self + 1 cross, 12.8 GB).
# danube's 5,120 and recurrentgemma's 3,072 prompts pass their windows
# (4,096 and 2,048) and are whole Q_CHUNKs of the plain attention;
# hubert is an encoder (no decode).
LM_FAMILIES = (
    ("qwen2-1.5b", None, 2, 2048, 16),
    ("h2o-danube-3-4b", None, 1, 5120, 16),
    ("mistral-large-123b", 4, 1, 2048, 8),
    ("grok-1-314b", 2, 2, 1024, 8),
    ("arctic-480b", 1, 1, 1024, 8),
    ("llama-3.2-vision-90b", 5, 1, 1024, 8),
    ("recurrentgemma-2b", None, 1, 3072, 16),
    ("mamba2-780m", None, 2, 2048, 16),
    ("hubert-xlarge", None, 2, 2048, 0),
)
LM_SEED = 0
# the MoE gate's short run (nothing dropped): prompt tokens, decode steps
MOE_GATE_PROMPT, MOE_GATE_DECODE = 256, 8
# a token routed to other experts by decode and by the full forward is
# left out of the MoE gate only where its router-logit gap between the
# k-th and (k+1)-th expert was below this in one of the runs: the two
# runs' bf16 residual streams differ by ~2^-8 relative, which moves
# unit-variance router logits by ~0.004
MOE_TIE_MARGIN = 0.05

# training (phase 32). 32a: the flash backward at (name, (B, H, Hkv, S,
# d), dtype, causal); the first row is qwen2-1.5b's training layer, the
# last the float32 shape of 32b's layer
FLASH_BWD_SHAPES = (
    ("qwen2 training layer", (2, 12, 2, 4096, 128), "bfloat16", True),
    ("yi-9b prefill", (4, 32, 4, 2048, 128), "bfloat16", True),
    ("hubert d = 80", (2, 16, 16, 2048, 80), "bfloat16", False),
    ("qwen2 layer float32", (1, 12, 2, 1024, 128), "float32", True),
)
# the backward against its plain version on the same inputs (the
# kernel's O and LSE) and against the float64 gradient of the exact
# forward, of the gradient's largest magnitude: float32 1e-5 both (sums
# in another order); bf16 2^-7 against the plain version (the gradients
# are rounded once to bf16 from float32 sums: 2^-9 to 2^-8 of a value;
# the tensor-core route also rounds P and dS to bf16 for their products,
# which a CPU model of it, tests/test_torch_flash_bwd.py, puts at 2e-3
# to 4e-3 in all) and 2^-6 against float64 (D = rowsum(dO∘O) takes the
# bf16 O, whose rounding the difference dP − D can bring near the size
# of dS)
FLASH_BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -6)}
# the forward's LSE against the plain one, absolute (log units; float32
# sums of ~10^3 terms)
FLASH_LSE_TOL = 1e-4
# 32b: qwen2-1.5b cut to GRAD_LAYERS layers at full widths in float32, one
# sequence of GRAD_TOKENS: each leaf's gradient on the card (kernels)
# against the CPU's (plain versions), ‖Δ‖_F / ‖g_cpu‖_F ≤ GRAD_TOL (both
# float32, sums in another order; the CPU tests see 6e-6 between the
# packages' CPU paths)
GRAD_LAYERS, GRAD_TOKENS, GRAD_TOL = 2, 1024, 1e-4
# 32c: the trainer at full size: train_4k's sequence length, a global
# batch of 4 in 2 microbatches, TRAIN_STEPS steps
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = "qwen2-1.5b", 4096, 4, 2
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP, TRAIN_SEED = 6, 3e-4, 2, 0
# step 0's loss against loss_fn without grad on the same weights and
# batch: one bf16 rounding of the loss's inputs (the two runs do the
# same operations; the bound is the bf16 tolerance)
TRAIN_LOSS_TOL = 2.0 ** -8
# 32d: [train 4] against [train 2, restore, train 2] at RESUME_LAYERS
RESUME_LAYERS = 2
# 33: the curvature spectrum of qwen2-1.5b at its published widths, cut
# to CURV_LAYERS layers, float32, remat off, on one batch of CURV_BATCH
# tokens: eigsh(nev 4, block 2, tol 1e-3, which "LA") over HvpOperator.
# One Hessian-vector column on the card against the CPU's (plain
# versions), max |Δ| ≤ CURV_HVP_TOL · max |Hv| (both float32, sums in
# another order); |uᵀHv − vᵀHu| ≤ CURV_SYM_TOL · ‖u‖‖Hv‖; the Ritz pairs'
# true residuals ‖Hx − θx‖ / max(1, |θ|) ≤ CURV_RESID_TOL (10× the
# solve's tol, as phase 5's RESID_TOL is 10× its tol). CURV_RESTARTS is
# eigsh's default: the example's 40 left 2 to spare on the card (38)
CURV_LAYERS, CURV_BATCH, CURV_SEED = 2, (2, 128), 0
CURV_NEV, CURV_BLOCK, CURV_TOL, CURV_RESTARTS = 4, 2, 1e-3, 60
CURV_HVP_TOL, CURV_SYM_TOL, CURV_RESID_TOL = 1e-4, 1e-4, 1e-2
CURV_REPS = 3
# 34: sharded training: qwen2-1.5b at its published widths cut to
# SHARD_LAYERS layers, float32, remat on, SHARD_BATCH sequences of
# SHARD_SEQ tokens a step in one microbatch, SHARD_STEPS steps; (c) on
# SHARD_SHAPE gloo ranks sharing the card. (b), one NCCL rank, within
# SHARD_ONE_RTOL of (a) (the same operations in the same order: a
# difference is a fault); (c) within SHARD_RTOL, its parameters within
# 2·lr·steps + 1e-5 (tests/test_torch_train.py's tolerances: float32
# sums in another order; Adam moves a parameter by about lr a step, and
# a gradient element at rounding level may change sign)
SHARD_LAYERS, SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 2, 2, 1024, 3
SHARD_SHAPE, SHARD_LR, SHARD_WARMUP = (1, 2, 2), 3e-4, 2
SHARD_ONE_RTOL, SHARD_RTOL = 1e-6, 1e-4


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


def kernels_per_call(torch, fn, calls: int = 4, windows: int = 3,
                     launched=None) -> float:
    """Device kernels that one call of fn launches, counted by the
    profiler over `calls` calls (copies and fills excluded). Fills open
    and close the window: after earlier profiler sessions the first
    kernels of a window can go unrecorded (seen in this script's runs,
    where the same calls counted alone give one kernel per call), so
    three fills and a synchronize come before the calls and take that
    place. A window can also come back with none of
    fn's kernels (seen once in this script's runs, for calls that launched:
    the wrappers count every launch and their results are checked), or
    with a count that is not a whole number a call (a record lost inside
    the window: seen in this script's runs, 7 kernels for 4 calls of a
    2-kernel SpMM), so such a window is logged and profiled again, up to
    `windows` times; the last window's count is returned as it is.
    `launched`, where given, reads the wrapper's own count of the device
    kernels it launched; the last window's profiler count must equal
    that count's growth over the window's calls, so a retry cannot hide a
    launch that did not happen. CPU and CUDA activities, as
    kernel_split's: CUDA-only windows lost a record in each of three
    windows of one run (7, 7 and 5 kernels for 4 calls of the 2-kernel
    SpMM at k = 1)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    word = torch.empty(1, device="cuda")
    for window in range(1, windows + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                word.fill_(1.0)
            torch.cuda.synchronize()
            before = launched() if launched else None
            for _ in range(calls):
                fn()
            by_wrapper = launched() - before if launched else None
            word.fill_(1.0)
            torch.cuda.synchronize()
        counts = {evt.key[:60]: evt.count for evt in prof.key_averages()
                  if "CUDA" in str(getattr(evt, "device_type", ""))
                  and not evt.key.startswith(("Memcpy", "Memset"))
                  and "FillFunctor" not in evt.key}
        n = sum(counts.values())
        if n and n % calls == 0:
            break
        log(f"kernels_per_call: profile window {window} of {windows} "
            f"recorded {n} kernels for the {calls} calls (the wrapper "
            f"counted {by_wrapper}): {counts}")
    if launched and n != by_wrapper:
        fail(f"kernels_per_call: the profiler recorded {n} device kernels "
             f"for {calls} calls, the wrapper counted {by_wrapper}: "
             f"{counts}")
    return n / calls


def spmm_phase(torch, op, timer, x, width_row: bool = False):
    """The SpMM kernel over the operator's image, float32 or bf16, at the
    solve's shapes against its plain version (float32 arithmetic on the
    same blocks). A `width_row` is the float32 kernel at X's width k
    (`spmm_blocksparse_k<k>`), counted by LAUNCHES_BY_K, without the plan
    and heaviest-item report."""
    from repro_torch.kernels import ops, spmm_tile
    blocks, cols, ptr, plan = op._blocks, op._block_cols, op._row_ptr, \
        op._plan
    n = op.n
    k = x.shape[1]
    bf16 = blocks.dtype == torch.bfloat16
    name = "spmm_blocksparse_bf16" if bf16 else "spmm_blocksparse"
    if width_row:
        name = f"spmm_blocksparse_k{k}"
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
    bms, by = bound_ms(nbytes, 2 * nb * bm * bn * k)
    # device kernels a call: the ring kernel, and the combine kernel when
    # the plan splits rows; and the ring's launch as the card reports it
    per_call = kernels_per_call(torch, lambda: ops.spmm_blocks(
        blocks, cols, ptr, x, plan=plan),
        launched=lambda: spmm_tile.DEVICE_KERNELS)
    want_per_call = 1 + (plan.splits.shape[0] > 0)
    ring = spmm_tile.occupancy(blocks.dtype, bm, bn,
                               spmm_tile.kernel_width(k), op.device)
    ring_note = (f"share of bound {bms / ms:.3f} | device kernels per call "
                 f"{per_call:g} | ring: {ring['stages']} stages of "
                 f"{ring['stage_bytes']} B, {ring['smem_bytes']} B shared "
                 f"a CTA of {ring['threads']} threads, {ring['ctas_per_sm']}"
                 f" CTAs an SM, {ring['registers']} registers a thread, "
                 f"{ring['local_bytes']} B local")
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
    if width_row:
        log(f"kernel {name}: blocks {tuple(blocks.shape)} float32 x "
            f"{tuple(x.shape)} | rel err {err:.3e} (tol {KERNEL_TOL:g} of "
            f"Σ|terms|), max abs err {abs_err:.3e}, bit-identical run to "
            f"run | {ms:.3f} ms, plain {plain:.3f} ms, library {lib_ms} ms "
            f"({lib_note}), bound {bms:.3f} ms ({by}) | {ring_note}")
        if not err <= KERNEL_TOL:
            fail(f"{name} disagrees with its plain version: {err}")
        if per_call != want_per_call:
            fail(f"{name} launched {per_call} device kernels per call, not "
                 f"{want_per_call}")
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/spmm_tile.cu",
                "replaces": "src/repro/kernels/spmm_tile.py:50",
                "count": lambda: spmm_tile.LAUNCHES_BY_K.get(k, 0),
                "max_abs_err": abs_err, "ms": ms, "plain_ms": plain,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
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
        f"{heavy_ms / ms:.2f} of the launch | {ring_note}")
    if not err <= KERNEL_TOL:
        fail(f"{name} disagrees with its plain version: {err}")
    if per_call != want_per_call:
        fail(f"{name} launched {per_call} device kernels per call, not "
             f"{want_per_call}")
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
    flashattn.LAUNCHES_BY_D.clear()
    flashattn.BWD_LAUNCHES = 0
    flashattn.BWD_LAUNCHES_BY_D.clear()
    spmm_tile.LAUNCHES_BF16 = 0
    spmm_tile.LAUNCHES_BY_K.clear()
    gram.LAUNCHES_BY_SHAPE.clear()
    tsgemm.LAUNCHES_BY_SHAPE.clear()
    gram.LAUNCHES_BY_VARIANT.clear()
    tsgemm.LAUNCHES_BY_VARIANT.clear()


def launches_by_width() -> dict:
    """The solver kernels' launches since the counters were zeroed, by
    width: SpMM by X's k, gram by G's and tsgemm by B's shape."""
    from repro_torch.kernels import gram, spmm_tile, tsgemm
    return {"spmm_blocksparse": {f"k{k}": v for k, v in
                                 sorted(spmm_tile.LAUNCHES_BY_K.items())},
            "gram": {f"{m}x{b}": v for (m, b), v in
                     sorted(gram.LAUNCHES_BY_SHAPE.items())},
            "tsgemm": {f"{m}x{b}": v for (m, b), v in
                       sorted(tsgemm.LAUNCHES_BY_SHAPE.items())}}


def launches_by_variant() -> dict:
    """gram's and tsgemm's launches since the counters were zeroed, by the
    kernel variant that ran (gram.variant, tsgemm.variant)."""
    from repro_torch.kernels import gram, tsgemm
    return {"gram": dict(sorted(gram.LAUNCHES_BY_VARIANT.items())),
            "tsgemm": dict(sorted(tsgemm.LAUNCHES_BY_VARIANT.items()))}


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


def safs_subspace_phase(torch, op, rows, res_ram, wall_ram):
    """The main solve with the subspace in SAFS page files on the card's
    host, the image resident on the card. Returns its result."""
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
    return res


def safs_stream_phase(torch, dev, rows):
    """The image itself in SAFS page files: a streamed GraphOperator
    against the resident one, then the solve over it. Returns the
    TiledMatrix (phase 19 solves it again, resident)."""
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
    return tm


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


# ------------------------------------------------------------------ family

def ran_variant(mod, fn):
    """fn() and the one kernel variant of `mod` (gram, tsgemm) it ran."""
    before = dict(mod.LAUNCHES_BY_VARIANT)
    out = fn()
    ran = [k for k, v in mod.LAUNCHES_BY_VARIANT.items()
           if v != before.get(k, 0)]
    if len(ran) != 1:
        fail(f"one call ran the variants {ran}, not one")
    return out, ran[0]


def dense_width_row(torch, timer, dev, kind: str, m: int, b: int,
                    n: int = 2 ** 20):
    """gram (n, m)ᵀ(n, b) or tsgemm (n, m)·(m, b) + C0 at a width the rest
    of the solver family gives it, against its plain version: one device
    kernel per call, bit-identical over three calls, the variant that ran,
    timed flushed and clean beside the library call and the bound. gram
    also as gram(A, A): exactly symmetric and bit-identical over three
    calls. tsgemm also bit-equal to the generic kernel, which takes the
    same data 4 bytes off a 16-byte boundary."""
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import tsgemm as tsgemm_mod
    gen = torch.Generator(device=dev).manual_seed(100 + 10 * m + b)
    a = torch.randn((n, m), generator=gen, device=dev)
    if kind == "gram":
        mod, lib_name = gram_mod, "torch.matmul(a.T, b)"
        shape = f"({n}, {m})ᵀ({n}, {b})"
        rhs = torch.randn((n, b), generator=gen, device=dev)
        scale = a.abs().T @ rhs.abs()
        nbytes, flops = (n * m + n * b + m * b) * 4, 2 * n * m * b

        def call(impl="auto"):
            return ops.gram(a, rhs, impl=impl)

        def lib_call():
            return torch.matmul(a.T, rhs)
    else:
        mod, lib_name = tsgemm_mod, "torch.addmm"
        shape = f"({n}, {m})·({m}, {b}) + C0"
        small = torch.randn((m, b), generator=gen, device=dev)
        c0 = torch.randn((n, b), generator=gen, device=dev)
        scale = a.abs() @ small.abs() + c0.abs()
        nbytes = (n * m + m * b + 2 * n * b) * 4
        flops = 2 * n * m * b + 2 * n * b

        def call(impl="auto"):
            return ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=c0,
                              impl=impl)

        def lib_call():
            return torch.addmm(c0, a, small, beta=1.0, alpha=-1.0)
    name = f"{kind}_b{b}"
    got, variant = ran_variant(mod, call)
    if not all(torch.equal(got, call()) for _ in range(2)):
        fail(f"{name} is not bit-identical from run to run")
    want = call("ref")
    err = rel_err(got, want, scale)
    abs_err = float((got - want).abs().max())
    del want, scale
    if kind == "gram":   # gram(A, A): G = AᵀA, as LOBPCG's G and SVQB's
        g_aa = ops.gram(a, a)
        if not all(torch.equal(g_aa, ops.gram(a, a)) for _ in range(2)):
            fail(f"{name}: gram(A, A) is not bit-identical from run to run")
        if not torch.equal(g_aa, g_aa.T):
            fail(f"{name}: gram(A, A) is not exactly symmetric")
        err = max(err, rel_err(g_aa, ops.gram(a, a, impl="ref"),
                               a.abs().T @ a.abs()))
        # its diagonal sums n positive products: the kernel's and the
        # library call's float32 error against the float64 sum
        exact = a.double().T @ a.double()
        lib_aa = torch.matmul(a.T, a)
        e64 = [rel_err(x, exact, a.abs().double().T @ a.abs().double())
               for x in (g_aa, lib_aa)]
        extra = (f"gram(A, A) exactly symmetric and bit-identical, against "
                 f"its float64 sum {e64[0]:.3e} (torch.matmul {e64[1]:.3e})"
                 f" of Σ|terms|")
        del g_aa, exact, lib_aa
    else:                # the generic kernel on rows 4 bytes off 16
        a_off = torch.empty(n * m + 1, device=dev)[1:].view(n, m)
        c0_off = torch.empty(n * b + 1, device=dev)[1:].view(n, b)
        a_off.copy_(a)
        c0_off.copy_(c0)
        oracle, oracle_kind = ran_variant(mod, lambda: ops.tsgemm(
            a_off, small, alpha=-1.0, beta=1.0, c0=c0_off))
        if oracle_kind != "generic" or not torch.equal(got, oracle):
            fail(f"{name} ({variant}) differs from the generic kernel "
                 f"({oracle_kind}) bit for bit")
        extra = "bit-equal to the generic kernel"
        del a_off, c0_off, oracle
    per_call = kernels_per_call(torch, call)
    ms = timer.ms(call)
    clean_ms = timer.ms(call, clean=True)
    plain = timer.ms(lambda: call("ref"))
    lib_ms = timer.ms(lib_call)
    lib_clean = timer.ms(lib_call, clean=True)
    bms, by = bound_ms(nbytes, flops)
    log(f"kernel {name}: {shape}, variant {variant} | rel err {err:.3e} "
        f"(tol {KERNEL_TOL:g} of Σ|terms|), max abs err {abs_err:.3e}, "
        f"bit-identical run to run, {extra} | device kernels per call "
        f"{per_call:g} | {ms:.4f} ms ({clean_ms:.4f} with L2 clean), plain "
        f"{plain:.4f} ms, library {lib_name} {lib_ms:.4f} ms ({lib_clean:.4f}"
        f" clean), bound {bms:.4f} ms ({by}) = {bms / clean_ms:.2f} of the "
        f"clean time")
    if not err <= KERNEL_TOL:
        fail(f"{name} disagrees with its plain version: {err}")
    if per_call != 1:
        fail(f"{name} launched {per_call} device kernels per call, not 1")
    src = "gram.cu" if kind == "gram" else "tsgemm.cu"
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": ("src/repro/kernels/gram.py:34" if kind == "gram"
                         else "src/repro/kernels/tsgemm.py:28"),
            "count": lambda: mod.LAUNCHES_BY_SHAPE.get((m, b), 0),
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def width_phase(torch, op, timer):
    """Phase A: the kernels at the widths the rest of the solver family
    gives them (SpMM k = 1, 2, 8 over the rmat-1M image; gram and tsgemm
    at b = 2 and 8, and gram at LOBPCG's 16- and 24-column G and H),
    before any solve uses them."""
    dev = op.device
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = [spmm_phase(torch, op, timer, torch.randn(
        (op.n, k), generator=gen, device=dev), width_row=True)
        for k in FAMILY_SPMM_K]
    for b in FAMILY_B:
        rows.append(dense_width_row(torch, timer, dev, "gram", b, b))
        rows.append(dense_width_row(torch, timer, dev, "tsgemm", b, b))
    for b in (2 * NEV, 3 * NEV):
        rows.append(dense_width_row(torch, timer, dev, "gram", b, b))
    torch.cuda.synchronize()
    return rows


def counted_solve(torch, op, label: str, *args, **kw):
    """solve(*args, **kw) on a fresh RAM-tier store, the launch counters
    zeroed just before and read just after. Returns the result, its wall
    seconds and the launches by width."""
    from repro_torch.core import TieredStore, solve
    store = TieredStore(device=op.device)
    for o in (op, getattr(op, "inner", None), getattr(op, "a", None),
              getattr(op, "at", None)):
        if o is not None and hasattr(o, "store"):
            o.store = store
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(*args, store=store, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    widths = launches_by_width()
    log(f"{label}: solve wall {wall:.3f} s | converged {res.converged} | "
        f"restarts/iterations {res.n_restarts} | operator applications "
        f"{res.n_ops} | launches by width {json.dumps(widths)} | by "
        f"variant {json.dumps(launches_by_variant())}")
    log(f"{label}: eigenvalues {np.array2string(res.eigenvalues, precision=8)}"
        f" | residuals {np.array2string(res.residuals, precision=3)}")
    log(f"{label}: IOStats {json.dumps(res.io_stats)}")
    for kernel, by in widths.items():
        if not sum(by.values()):
            fail(f"{label}: kernel {kernel} was not launched")
    return res, wall, widths


def near(theta, ref, slack) -> np.ndarray:
    """For each θ_i, min_j |θ_i − ref_j| − slack_j: ≤ the allowance of θ_i
    where θ_i lies within it of some ref_j (repeated eigenvalues, ±1 many
    times over here, make a one-to-one order meaningless)."""
    return (np.abs(np.asarray(theta)[:, None] - np.asarray(ref)[None, :])
            - np.asarray(slack)[None, :]).min(axis=1)


def top_pairs(res_ks) -> tuple[np.ndarray, np.ndarray]:
    """Phase 5's positive eigenvalues (its "LM" set's top end), descending,
    with their residual bounds: what LOBPCG ("LA") and the Chebyshev
    filter find."""
    th, rs = res_ks.eigenvalues, res_ks.residuals
    order = np.argsort(-th)
    keep = order[th[order] > 0]
    if keep.size == 0:
        fail("phase 5 found no positive eigenvalue to compare with")
    return th[keep], rs[keep]


def lanczos_phase(torch, op, res_ks) -> dict:
    """Phase B: block Lanczos (no restarts) on the rmat-1M image."""
    from repro_torch.core import true_residuals
    res, wall, widths = counted_solve(
        torch, op, "lanczos", op, NEV, method="lanczos",
        block_size=BLOCK_SIZE)
    resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
    gap = near(res.eigenvalues, res_ks.eigenvalues, res_ks.residuals)
    ks_io = res_ks.io_stats
    log(f"lanczos: {res.n_ops} expansions (m = {res.m_subspace}) | true "
        f"residuals {np.array2string(resid, precision=3)} | distance to "
        f"phase 5's nearest eigenvalue less its bound "
        f"{np.array2string(gap, precision=3)} (limit: the Lanczos bound) | "
        f"passes {res.io_stats['passes']} vs Krylov–Schur's "
        f"{ks_io['passes']}, pass bytes {res.io_stats['pass_bytes_read']} vs "
        f"{ks_io['pass_bytes_read']}, host bytes read "
        f"{res.io_stats['host_bytes_read']} vs {ks_io['host_bytes_read']}, "
        f"written {res.io_stats['host_bytes_written']} vs "
        f"{ks_io['host_bytes_written']}")
    if not np.all(gap <= res.residuals):
        fail(f"Lanczos Ritz values beyond the residual bounds of phase 5's: "
             f"{gap} > {res.residuals}")
    return widths


def lobpcg_phase(torch, op, res_ks) -> dict:
    """Phase C: LOBPCG at nev 8 (b = 8) on the rmat-1M image, with its pass
    identity (lobpcg.py's docstring) checked to the byte."""
    from repro_torch.core import true_residuals
    res, wall, widths = counted_solve(
        torch, op, "lobpcg", op, NEV, method="lobpcg", tol=LOBPCG_TOL,
        max_iters=LOBPCG_MAX)
    it, io = res.n_restarts, res.io_stats
    blk = op.n * NEV * 4
    if io["passes"] == 3 * it + 1:           # stopped after a residual pass
        how, want = "stopped at iteration", (10 + 14 * (it - 1) + 2) * blk
    elif io["passes"] == 3 * (it + 1):       # ran out of iterations
        how, want = "ran all iterations to", (10 + 14 * it) * blk
    else:
        fail(f"lobpcg made {io['passes']} passes at iteration {it}: neither "
             f"3·it + 1 nor 3·(it + 1)")
    short = want - io["pass_bytes_read"]
    if short < 0 or short % (4 * blk):
        fail(f"lobpcg pass bytes {io['pass_bytes_read']} do not follow the "
             f"identity ({want}, less 4·n·b·4 per deflated P)")
    resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
    top, top_res = top_pairs(res_ks)
    th = np.sort(res.eigenvalues)[::-1][:top.size]
    rs = (resid * np.maximum(1.0, np.abs(res.eigenvalues)))[
        np.argsort(-res.eigenvalues)][:top.size]
    gap = np.abs(th - top[:th.size]) - top_res[:th.size]
    pair_bytes = (io["host_bytes_read"] + io["host_bytes_written"]) / NEV
    ks_io = res_ks.io_stats
    ks_pair = (ks_io["host_bytes_read"] + ks_io["host_bytes_written"]) / NEV
    log(f"lobpcg: converged {res.converged} | {how} {it}: passes "
        f"{io['passes']} = 3·{it} + {io['passes'] - 3 * it}, pass bytes "
        f"{io['pass_bytes_read']} = identity {want} less "
        f"{short // (4 * blk)} deflated P | matmats {res.n_ops} | true "
        f"residuals ‖Ax−θx‖/max(1,|θ|) {np.array2string(resid, precision=3)}"
        f" | top {th.size} against phase 5's positive eigenvalues: distance "
        f"less phase 5's bound {np.array2string(gap, precision=3)} (limit: "
        f"the true residual) | bytes per converged pair {pair_bytes:.4e} "
        f"against Krylov–Schur's {ks_pair:.4e} = {pair_bytes / ks_pair:.3f}"
        f" (0.65 in the reference's CPU smoke)")
    if not (np.all(np.isfinite(res.eigenvalues))
            and bool(torch.isfinite(res.eigenvectors).all())):
        fail("lobpcg returned values that are not finite")
    if not np.all(gap <= rs):
        fail(f"lobpcg's top eigenvalues beyond their residuals of phase 5's:"
             f" {gap} > {rs}")
    lobpcg_breakdown(torch, op)
    return widths


def chebyshev_phase(torch, op, res_ks) -> dict:
    """Phase D: estimate_spectral_range (SpMM at k = 1), then a degree-10
    Chebyshev filter damping [lo, ½·(smallest wanted eigenvalue)], then
    Krylov–Schur on the filter for phase 5's positive eigenvalues."""
    from repro_torch.core import (ChebyshevFilterOperator,
                                  estimate_spectral_range)
    from repro_torch.kernels import spmm_tile
    top, _ = top_pairs(res_ks)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lo, hi = estimate_spectral_range(op)
    torch.cuda.synchronize()
    k1 = spmm_tile.LAUNCHES_BY_K.get(1, 0)
    log(f"chebyshev: estimate_spectral_range [{lo:.6f}, {hi:.6f}] in "
        f"{time.perf_counter() - t0:.3f} s, {k1} SpMM launches at k = 1")
    if not (k1 > 0 and lo < res_ks.eigenvalues.min()
            and hi > res_ks.eigenvalues.max()):
        fail(f"the spectral range [{lo}, {hi}] does not bracket phase 5's "
             f"eigenvalues, or SpMM at k = 1 never launched ({k1})")
    cut = 0.5 * float(top.min())
    ch = ChebyshevFilterOperator(op, (lo, cut), degree=CHEB_DEGREE)
    res, wall, widths = counted_solve(
        torch, op, "chebyshev", ch, top.size, method="krylov_schur",
        block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS, tol=TOL,
        max_iters=MAX_ITERS)
    widths["spmm_blocksparse"]["k1"] = k1
    got = np.sort(res.eigenvalues)[::-1]
    rel = np.abs(got - top) / np.abs(top)
    scaled = res.residuals / np.maximum(1.0, np.abs(res.eigenvalues))
    log(f"chebyshev: damped [{lo:.6f}, {cut:.6f}], degree {CHEB_DEGREE} | "
        f"{res.n_ops} filter applications = {res.n_ops * CHEB_DEGREE} "
        f"matmats, {widths['spmm_blocksparse'].get(f'k{BLOCK_SIZE}', 0)} "
        f"SpMM launches at k = {BLOCK_SIZE} | untransformed eigenvalues "
        f"against phase 5's: rel err {np.array2string(rel, precision=3)} "
        f"(tol 1e-5) | true residuals of A {np.array2string(scaled)}")
    if not res.converged:
        fail("the Chebyshev-filtered solve did not converge")
    if not np.all(rel <= 1e-5):
        fail(f"Chebyshev eigenvalues disagree with phase 5's: {rel}")
    if not np.all(scaled <= RESID_TOL):
        fail(f"Chebyshev true residuals above {RESID_TOL}: {scaled}")
    coo_share(torch, op, ch)
    return widths


@contextlib.contextmanager
def coo_events(torch):
    """CUDA events on the stream around every call of the operator's COO
    side path (core/operator.py's coo_spmm_ref, wrapped for the block);
    yields the list of (start, end) pairs."""
    from repro_torch.core import operator as operator_mod
    plain = operator_mod.coo_spmm_ref
    marks = []

    def bracketed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain(*args)
        end.record()
        marks.append((start, end))
        return out

    operator_mod.coo_spmm_ref = bracketed
    try:
        yield marks
    finally:
        operator_mod.coo_spmm_ref = plain


def coo_share(torch, op, ch) -> None:
    """One profiled application of the filter: device time by kind, and
    the COO side path's share of it, its kernels bracketed by CUDA events
    on the stream."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((op.n, BLOCK_SIZE), device=op.device,
                    generator=torch.Generator(device=op.device).manual_seed(3))
    ch.matmat(x)
    torch.cuda.synchronize()
    with coo_events(torch) as marks, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ch.matmat(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cats, _, others = _device_ms_by_kind(prof, {
        "spmm_blocksparse": ("spmm_blocksparse",)})
    busy = sum(cats.values())
    coo = sum(s.elapsed_time(e) for s, e in marks)
    if busy <= 0:
        log("chebyshev breakdown: the profiler reported no device time "
            "(not measured)")
        busy = float("nan")
    log(f"chebyshev breakdown (one profiled application, {len(marks)} "
        f"matmats): wall {wall:.2f} ms | device busy {busy:.2f} ms, idle "
        f"share {1 - busy / wall:.3f} | spmm_blocksparse "
        f"{cats['spmm_blocksparse']:.2f} ms, other {cats['other']:.2f} ms | "
        f"COO side path (event-bracketed) {coo:.2f} ms = "
        f"{coo / busy:.3f} of device busy, {coo / wall:.3f} of the wall | "
        f"largest other kernels (ms, count, name): "
        + "; ".join(f"{ms:.3f}, {cnt}, {name}" for ms, cnt, name in others))


def kernel_variant(name: str) -> str | None:
    """"gram tile24x24", "tsgemm vec8x8", "gram generic", ... for a device
    kernel's (demangled) name; None for any other kernel."""
    hit = re.search(r"\b(gram|tsgemm)_(?:(tile|vec|pair2)_)?kernel"
                    r"(?:<(\d+), ?(\d+)>)?", name)
    if hit is None:
        return None
    kernel, kind, m, b = hit.groups()
    if kind is None:
        return f"{kernel} generic"
    return f"{kernel} pair2x2" if kind == "pair2" else \
        f"{kernel} {kind}{m}x{b}"


def lobpcg_breakdown(torch, op, iters: int = 3) -> None:
    """A profiled LOBPCG (nev 8, tol 0: every iteration runs) of `iters`
    iterations on a fresh RAM-tier store: device ms and launches by kernel,
    gram and tsgemm by variant, the COO path's gather and index_add_, H2D
    and D2H; the COO path event-bracketed; the idle share; the wrappers'
    launches by variant; the largest host spans."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import TieredStore, solve
    from repro_torch.obs import Tracer, tracing
    store = TieredStore(device=op.device)
    op.store = store
    tracer = Tracer()
    zero_counters()
    torch.cuda.synchronize()
    with coo_events(torch) as marks, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with tracing(tracer):
            res = solve(op, NEV, method="lobpcg", tol=0.0, max_iters=iters,
                        store=store)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ms, count, others = _device_ms_by_kind(prof, {
        "spmm_blocksparse": ("spmm_blocksparse",),
        "COO gather": ("gather",),
        "COO index_add_": ("indexFunc", "index_add"),
        "Memcpy HtoD": ("Memcpy HtoD",), "Memcpy DtoH": ("Memcpy DtoH",)},
        label=kernel_variant)
    busy = sum(ms.values())
    if busy <= 0:
        log("lobpcg breakdown: the profiler reported no device time (not "
            "measured)")
        busy = float("nan")
    coo = sum(s.elapsed_time(e) for s, e in marks)
    host = {}
    for rec in tracer.records():
        if rec["type"] == "span":
            host[rec["name"]] = host.get(rec["name"], 0.0) + rec["dur"] / 1e3
    top = sorted(host.items(), key=lambda kv: -kv[1])[:6]
    order = sorted(ms, key=lambda k: -ms[k])
    log(f"lobpcg breakdown (max_iters {iters}, n_restarts "
        f"{res.n_restarts}, profiled): wall "
        f"{wall:.1f} ms | device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f} | device ms by kind "
        f"{json.dumps({k: round(ms[k], 3) for k in order})}")
    log(f"lobpcg breakdown: device launches by kind "
        f"{json.dumps({k: count[k] for k in order})} | the wrappers' "
        f"launches by variant {json.dumps(launches_by_variant())} | COO "
        f"side path (event-bracketed, {len(marks)} calls) {coo:.2f} ms = "
        f"{coo / busy:.3f} of device busy")
    log(f"lobpcg breakdown: largest other device kernels (ms, count, name): "
        + "; ".join(f"{t:.3f}, {c}, {nm}" for t, c, nm in others))
    log(f"lobpcg breakdown: largest host spans ms "
        f"{json.dumps({k: round(v, 3) for k, v in top})}")


def svd_phase(torch, dev) -> dict:
    """Phase E: the SVD of the directed 2^20-vertex R-MAT graph through
    NormalOperator.from_tiles and solve(method="svd")."""
    from repro_torch.core import NormalOperator
    from repro_torch.graphs import pack_tiles, rmat_graph
    n = 2 ** N_LOG2
    t0 = time.perf_counter()
    r, c, v = rmat_graph(n, 2 ** NNZ_LOG2, seed=GRAPH_SEED, symmetric=False)
    tms = {}
    for tag, (rr, cc) in (("A", (r, c)), ("Aᵀ", (c, r))):
        tm = pack_tiles(n, n, rr, cc, v, block_shape=BLOCK,
                        min_block_nnz=MIN_BLOCK_NNZ)
        tms[tag] = tm
        log(f"svd: {tag} image {tm.nblocks} blocks "
            f"({tm.blocks.nbytes / 1e9:.2f} GB), COO {tm.coo_vals.size} "
            f"entries = {tm.coo_vals.size / r.size:.3f} of nnz {r.size}")
    log(f"svd: directed graph generated and packed in "
        f"{time.perf_counter() - t0:.1f} s")
    nop = NormalOperator.from_tiles(tms["A"], tms["Aᵀ"], device=dev)
    del tms
    gc.collect()
    res, wall, widths = counted_solve(
        torch, nop, "svd", nop.a, SVD_NSV, method="svd",
        block_size=SVD_BLOCK, at_op=nop.at, tol=TOL, max_iters=MAX_ITERS)
    sigma, u = res.eigenvalues, res.eigenvectors
    s_t = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    v_rec = nop.at.matmat(u) / s_t[None, :]          # v = Aᵀu / σ
    err = (torch.linalg.norm(nop.a.matmat(v_rec) - u * s_t[None, :], dim=0)
           / s_t).cpu().numpy()
    log(f"svd: σ {np.array2string(sigma, precision=6)} | ‖A v − u σ‖/σ with"
        f" v = Aᵀu/σ {np.array2string(err, precision=3)} (limit "
        f"{SVD_RESID_TOL:g}) | Gram applications {res.n_ops} (two SpMMs "
        f"each)")
    if not res.converged:
        fail("the SVD did not converge")
    if not (np.all(np.isfinite(sigma)) and np.all(np.diff(sigma) <= 0)
            and bool(torch.isfinite(u).all())
            and tuple(u.shape) == (n, SVD_NSV)):
        fail(f"singular values {sigma} or vectors {tuple(u.shape)} not "
             f"finite and descending")
    if not np.all(err <= SVD_RESID_TOL):
        fail(f"‖A v − u σ‖/σ above {SVD_RESID_TOL}: {err}")
    return widths


def shift_invert_phase(torch, dev, tm) -> dict:
    """Phase F: shift-invert (inner CG) on the resident 2^15 graph of phase
    10, σ below estimate_spectral_range's low end, against a "SA"
    Krylov–Schur solve of the same graph."""
    from repro_torch.core import (GraphOperator, ShiftInvertOperator,
                                  estimate_spectral_range)
    op = GraphOperator(tm, device=dev)
    ref, _, _ = counted_solve(
        torch, op, "shift-invert reference (SA)", op, NEV,
        method="krylov_schur", which="SA", block_size=BLOCK_SIZE,
        num_blocks=NUM_BLOCKS, tol=TOL, max_iters=MAX_ITERS)
    lo, _ = estimate_spectral_range(op)
    sigma = lo - SI_GAP
    si = ShiftInvertOperator(op, sigma, inner_solver="cg", cg_tol=SI_CG_TOL,
                             cg_maxiter=SI_CG_MAXITER)
    res, wall, widths = counted_solve(
        torch, op, "shift-invert", si, NEV, method="krylov_schur",
        which="LM", block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS, tol=TOL,
        max_iters=MAX_ITERS)
    got, want = np.sort(res.eigenvalues), np.sort(ref.eigenvalues)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    scaled = res.residuals / np.maximum(1.0, np.abs(res.eigenvalues))
    log(f"shift-invert: σ = {sigma:.6f} (range low end {lo:.6f}) | "
        f"{res.n_ops} outer applications, {si.n_inner_iters} inner CG "
        f"iterations ({si.n_inner_iters / max(res.n_ops, 1):.1f} per "
        f"application) | untransformed eigenvalues against the SA solve's: "
        f"rel err {np.array2string(rel, precision=3)} (tol 1e-5) | true "
        f"residuals of A {np.array2string(scaled)}")
    if not (res.converged and ref.converged):
        fail("a shift-invert phase solve did not converge")
    if not np.all(rel <= 1e-5):
        fail(f"shift-invert eigenvalues disagree with the SA solve's: {rel}")
    if not np.all(scaled <= RESID_TOL):
        fail(f"shift-invert true residuals above {RESID_TOL}: {scaled}")
    return widths


# ------------------------------------------------------- checkpoints

KS_SOLVE = dict(method="krylov_schur", block_size=BLOCK_SIZE,
                num_blocks=NUM_BLOCKS, tol=TOL, max_iters=MAX_ITERS)
LOBPCG_SOLVE = dict(method="lobpcg", tol=LOBPCG_TOL, max_iters=LOBPCG_MAX)


class Guard:
    """A stand-in preemption guard, armed after `after` solver callbacks
    (a signal handler is what `ft.PreemptionGuard` arms; here a count
    does, so the suspension lands on a known boundary)."""

    def __init__(self, after: int):
        self.after, self.n, self.armed = after, 0, False

    def requested(self) -> bool:
        return self.armed

    def cb(self, step, theta, res) -> None:
        self.n += 1
        self.armed = self.armed or self.n == self.after


def ckpt_solve(torch, op, label: str, store=None, expect=(), tracer=None,
               **kw):
    """solve(op, NEV, **kw) on `store` (a fresh RAM tier by default), the
    launch counters zeroed just before and read just after; every solver
    kernel must have launched. With `expect` an exception type, the solve
    must stop with it and that exception is returned in place of the
    result. Returns (result, wall seconds)."""
    from repro_torch.core import TieredStore, solve
    from repro_torch.obs import tracing
    store = store if store is not None else TieredStore(device=op.device)
    op.store = store
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = None
    with (tracing(tracer) if tracer is not None
          else contextlib.nullcontext()):
        try:
            out = solve(op, NEV, store=store, **kw)
        except expect as e:
            out = e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    widths = launches_by_width()
    for kernel, by in widths.items():
        if not sum(by.values()):
            fail(f"{label}: kernel {kernel} was not launched")
    if expect and not isinstance(out, expect):
        fail(f"{label}: the solve ran to its end; it had to stop with "
             f"{expect.__name__}")
    return out, wall


def tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def snapshot_bytes(root: str) -> tuple[int, int]:
    """(step, bytes) of the newest committed snapshot under `root`: its
    state directory and, on SAFS, its page snapshot."""
    from repro_torch.ckpt.checkpoint import valid_steps
    step = valid_steps(os.path.join(root, "state"))[-1]
    name = f"step_{step:010d}"
    return step, sum(tree_bytes(os.path.join(root, sub, name))
                     for sub in ("state", "pages")
                     if os.path.isdir(os.path.join(root, sub, name)))


def snapshot_line(root: str, tracer) -> str:
    """Bytes of the newest committed snapshot under `root` and the
    seconds of every `ckpt.save` span the tracer holds."""
    step, nbytes = snapshot_bytes(root)
    secs = [r["dur"] / 1e6 for r in tracer.records()
            if r["type"] == "span" and r["name"] == "ckpt.save"]
    return (f"{nbytes} bytes per snapshot (step {step}) | ckpt.save "
            f"seconds {np.array2string(np.array(secs), precision=3)}, "
            f"mean {np.mean(secs):.3f} s = "
            f"{nbytes / np.mean(secs) / 1e9:.3f} GB/s")


def suspend_resume(torch, op, label: str, solve_kw: dict, every: int,
                   after: int, root: str):
    """The uninterrupted solve, the one the guard suspends, and its
    resume, all three under deterministic algorithms; the resume must be
    bit-equal to the uninterrupted solve. Returns (uninterrupted result,
    its wall, resumed result, suspended wall, resumed wall, tracer of the
    suspended run)."""
    from repro_torch.ckpt import CheckpointPolicy, SolveSuspended
    from repro_torch.obs import Tracer
    torch.use_deterministic_algorithms(True)
    try:
        full, wall = ckpt_solve(torch, op, f"{label} uninterrupted",
                                **solve_kw)
        guard = Guard(after)
        tracer = Tracer()
        sus, wall_s = ckpt_solve(
            torch, op, f"{label} suspended", expect=SolveSuspended,
            tracer=tracer, callback=guard.cb,
            checkpoint=CheckpointPolicy(root=root, every_restarts=every,
                                        guard=guard), **solve_kw)
        res, wall_r = ckpt_solve(torch, op, f"{label} resumed",
                                 resume=root, **solve_kw)
    finally:
        torch.use_deterministic_algorithms(False)
    same_vals = np.array_equal(res.eigenvalues, full.eigenvalues)
    same_vecs = torch.equal(res.eigenvectors, full.eigenvectors)
    log(f"{label}: suspended at step {sus.step} (guard armed after "
        f"{after} callbacks, every_restarts={every}), resumed from "
        f"{res.resumed_step} | restarts/iterations {res.n_restarts} "
        f"against {full.n_restarts} uninterrupted | eigenvalues bit-equal "
        f"{same_vals}, eigenvectors bit-equal {same_vecs} (deterministic "
        f"algorithms) | walls: uninterrupted {wall:.3f} s, suspended "
        f"{wall_s:.3f} s + resumed {wall_r:.3f} s")
    if not (full.converged and res.converged):
        fail(f"{label}: a solve did not converge")
    if res.resumed_step != sus.step:
        fail(f"{label}: resumed from {res.resumed_step}, suspended at "
             f"{sus.step}")
    if not (same_vals and same_vecs and res.n_restarts == full.n_restarts):
        fail(f"{label}: the resumed solve differs from the uninterrupted "
             f"one: {res.eigenvalues} vs {full.eigenvalues}, "
             f"{res.n_restarts} vs {full.n_restarts}")
    return full, wall, res, wall_s, wall_r, tracer


def checkpoint_phase(torch, op) -> None:
    """Phase 20: suspend and resume on the RAM tier, Krylov–Schur and
    LOBPCG, bit-equal under deterministic algorithms."""
    from repro_torch.ckpt import CheckpointPolicy
    from repro_torch.core import true_residuals
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt_ram_")
    try:
        log(f"checkpoint: {root_line(root)}")
        ks = os.path.join(root, "ks")
        full, wall, res, _, _, tracer = suspend_resume(
            torch, op, "checkpoint krylov_schur", KS_SOLVE, every=1,
            after=2, root=ks)
        resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
        log(f"checkpoint krylov_schur: resumed true residuals "
            f"{np.array2string(resid)} (limit {RESID_TOL:g}) | "
            f"{snapshot_line(ks, tracer)}")
        if not np.all(resid <= RESID_TOL):
            fail(f"resumed true residuals above {RESID_TOL}: {resid}")
        every = os.path.join(root, "every")
        torch.use_deterministic_algorithms(True)
        try:
            ck, wall_ck = ckpt_solve(
                torch, op, "checkpoint every restart",
                checkpoint=CheckpointPolicy(root=every, every_restarts=1),
                **KS_SOLVE)
        finally:
            torch.use_deterministic_algorithms(False)
        log(f"checkpoint krylov_schur: wall with a snapshot every restart "
            f"{wall_ck:.3f} s ({ck.n_restarts} snapshots, the last "
            f"{snapshot_bytes(every)[1]} bytes) "
            f"against {wall:.3f} s without | eigenvalues bit-equal to the "
            f"uninterrupted solve's: "
            f"{np.array_equal(ck.eigenvalues, full.eigenvalues)}")
        if not np.array_equal(ck.eigenvalues, full.eigenvalues):
            fail("snapshots changed the solve's eigenvalues")
        lob = os.path.join(root, "lobpcg")
        _, _, _, _, _, tracer = suspend_resume(
            torch, op, "checkpoint lobpcg", LOBPCG_SOLVE, every=5,
            after=10, root=lob)
        log(f"checkpoint lobpcg: {snapshot_line(lob, tracer)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"checkpoint: phase 20 took {time.perf_counter() - t_phase:.1f} s")


def safs_crash_phase(torch, op, res_ks, res_safs) -> None:
    """Phase 21: a crash between a page snapshot and its state commit on
    SAFS, a resume into a fresh page root, and a page repaired from the
    surviving snapshot."""
    from repro_torch.ckpt import CheckpointPolicy
    from repro_torch.ckpt.checkpoint import valid_steps
    from repro_torch.core import TieredStore, true_residuals
    from repro_torch.safs import (CrashPoint, FaultPlan, FaultRule, Scrubber,
                                  flip_bit, repair_from_checkpoint)
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt_safs_")
    ck = os.path.join(root, "ck")
    crash = fresh = None
    try:
        log(f"safs crash: {root_line(root)}")
        plan = FaultPlan([FaultRule(site="ckpt.save", kind="crash", at=3)])
        crash = TieredStore(backend="safs", device=op.device, backend_opts={
            "root": os.path.join(root, "crash"), "faults": plan})
        _, wall_c = ckpt_solve(
            torch, op, "safs crash", store=crash, expect=CrashPoint,
            checkpoint=CheckpointPolicy(root=ck, every_restarts=1),
            **KS_SOLVE)
        state = valid_steps(os.path.join(ck, "state"))
        pages = valid_steps(os.path.join(ck, "pages"))
        log(f"safs crash: CrashPoint after {wall_c:.3f} s, fired "
            f"{[f['site'] for f in plan.fired(kind='crash')]} | state steps "
            f"{state}, page steps {pages}")
        if state != [1, 2] or 3 not in pages:
            fail(f"after the ckpt.save crash: state steps {state} (want "
                 f"[1, 2]), page steps {pages} (want 3 among them)")
        fresh = TieredStore(backend="safs", device=op.device,
                            backend_opts={"root": os.path.join(root, "fresh")})
        res, wall = ckpt_solve(torch, op, "safs resume", store=fresh,
                               resume=ck, **KS_SOLVE)
        resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
        # ±1 are eigenvalues many times over here (one per connected
        # component), so each eigenvalue is held to the nearest of phase
        # 5's rather than in sorted order
        want = res_ks.eigenvalues
        rel = (np.abs(res.eigenvalues[:, None] - want[None, :])
               / np.abs(want)[None, :]).min(axis=1)
        log(f"safs crash: resumed from step {res.resumed_step} in "
            f"{wall:.3f} s | converged {res.converged}, restarts "
            f"{res.n_restarts} against phase 9's {res_safs.n_restarts} | "
            f"eigenvalues against the nearest of phase 5's: rel err "
            f"{np.array2string(rel, precision=3)} (tol 1e-5) | true "
            f"residuals {np.array2string(resid)} (limit {RESID_TOL:g})")
        if res.resumed_step != 2 or not res.converged:
            fail(f"safs resume: resumed_step {res.resumed_step} (want 2), "
                 f"converged {res.converged}")
        if not (np.all(rel <= 1e-5) and np.all(resid <= RESID_TOL)):
            fail(f"safs resume: eigenvalues {rel} or residuals {resid} off")
        if res.n_restarts > res_safs.n_restarts + 1:
            fail(f"safs resume took {res.n_restarts} restarts, phase 9 "
                 f"{res_safs.n_restarts}")
        # the crashed store at rest holds exactly the step-3 page snapshot
        backend = crash.backend
        victim = sorted(backend.data_ids())[0]
        flip_bit(backend.pagefile(victim).path, 0)
        t0 = time.perf_counter()
        scrub = Scrubber(backend).run_once()
        t_scrub = time.perf_counter() - t0
        rep = repair_from_checkpoint(backend, os.path.join(ck, "pages"))
        again = Scrubber(backend).run_once()
        integrity = backend.stats_dict()["integrity"]
        log(f"safs crash: flipped a bit of {victim!r} page 0 | scrub "
            f"{scrub['files']} files, {scrub['pages']} pages in "
            f"{t_scrub:.3f} s: corrupt {scrub['corrupt']} | repair from "
            f"step {rep['step']}: repaired {rep['repaired']}, unrepaired "
            f"{rep['unrepaired']} | second scrub corrupt {again['corrupt']} "
            f"| integrity {json.dumps(integrity)}")
        if scrub["corrupt"] != [(victim, 0)]:
            fail(f"the scrub found {scrub['corrupt']}, not {victim} page 0")
        if (rep["repaired"] != [(victim, 0)] or again["corrupt"]
                or integrity["pages_repaired"] != 1):
            fail(f"the page was not repaired from the snapshot: {rep}")
    finally:
        for store in (crash, fresh):
            if store is not None:
                store.close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"safs crash: phase 21 took {time.perf_counter() - t_phase:.1f} s")


def traced_phase(torch, op) -> None:
    """Phase 22: phase 5's solve traced, beside an untraced one."""
    from repro_torch.obs import report
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="trace_")
    try:
        path = os.path.join(root, "solve.jsonl")
        plain, wall = ckpt_solve(torch, op, "untraced", **KS_SOLVE)
        res, wall_t = ckpt_solve(torch, op, "traced", trace=path,
                                 **KS_SOLVE)
        records = report.load(path)
        problems = report.validate(records)
        rec = report.reconcile(records)
        table = report.render(records).split("\n\n")[1]
        log(f"trace: traced wall {wall_t:.3f} s against {wall:.3f} s "
            f"untraced | {len(records)} records, "
            f"{os.path.getsize(path)} bytes | validate {problems} | "
            f"reconcile {json.dumps(rec)}")
        log(f"trace: phase table\n{table}")
        if problems or not (rec and rec["exact"]):
            fail(f"the trace does not validate: {problems}, {rec}")
        if res.n_restarts != plain.n_restarts or not res.converged:
            fail("the traced solve took another course than the untraced")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"trace: phase 22 took {time.perf_counter() - t_phase:.1f} s")


def quickstart_phase(torch) -> None:
    """Phase 23: the port's quickstart on the card."""
    from repro_torch.examples import quickstart
    t_phase = time.perf_counter()
    zero_counters()
    try:
        res = quickstart.main([])
    except AssertionError as e:
        fail(f"quickstart: {e}")
    torch.cuda.synchronize()
    widths = launches_by_width()
    for kernel, by in widths.items():
        if not sum(by.values()):
            fail(f"quickstart: kernel {kernel} was not launched")
    if not res.converged:
        fail("the quickstart solve did not converge")
    log(f"quickstart: {res.n_restarts} restarts, launches by width "
        f"{json.dumps(widths)} | phase 23 took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------- shared store, ladders

def kernel_launches() -> dict:
    """The solver kernels' launches since the counters were zeroed."""
    from repro_torch.kernels import gram, spmm_tile, tsgemm
    return {"spmm_blocksparse": spmm_tile.LAUNCHES, "gram": gram.LAUNCHES,
            "tsgemm": tsgemm.LAUNCHES}


def require_launched(label: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was not launched")


def namespace_phase(torch, op, res_ks) -> None:
    """Phase 24: phase 5's solve in two namespaces of one CUDA
    TieredStore, one after the other, then in two threads, beside a solo
    solve, all under deterministic algorithms (the COO side path sums in
    a fixed order, so every run takes the same course)."""
    import threading
    from repro_torch.core import TieredStore, solve, true_residuals
    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        solo, wall_solo = ckpt_solve(torch, op, "namespace solo",
                                     **KS_SOLVE)
        store = TieredStore(device=op.device)
        results, walls = {}, {}
        for sid in ("seq0", "seq1"):
            results[sid], walls[sid] = ckpt_solve(
                torch, op, f"namespace {sid}", store=store.namespace(sid),
                **KS_SOLVE)
        ops = {sid: copy.copy(op) for sid in ("thr0", "thr1")}
        errors = []

        def worker(sid):
            try:
                ns = store.namespace(sid)
                ops[sid].store = ns
                results[sid] = solve(ops[sid], NEV, store=ns, **KS_SOLVE)
            except Exception as e:          # reported on the main thread
                errors.append(f"{sid}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=worker, args=(sid,))
                   for sid in ops]
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        walls["threads"] = time.perf_counter() - t0
        launches = kernel_launches()
    finally:
        torch.use_deterministic_algorithms(False)
    if errors or any(t.is_alive() for t in threads):
        fail(f"namespace threads failed: {errors}")
    require_launched("namespace threads", launches,
                     ("spmm_blocksparse", "gram", "tsgemm"))
    stats = store.namespace_stats()
    parent = store.stats.as_dict()
    counts = ("host_bytes_read", "host_bytes_written", "host_reads",
              "host_writes", "cache_hits", "cache_misses", "passes",
              "pass_bytes_read")
    sums = {f: sum(d[f] for d in stats.values()) for f in counts}
    reconciled = all(sums[f] == parent[f] for f in counts)
    for sid, res in results.items():
        resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
        rel = np.abs(np.sort(res.eigenvalues) - np.sort(res_ks.eigenvalues)
                     ) / np.abs(np.sort(res_ks.eigenvalues))
        log(f"namespace {sid}: converged {res.converged}, restarts "
            f"{res.n_restarts} | IOStats split equal to the solo solve's: "
            f"{stats[sid] == solo.io_stats} | eigenvalues bit-equal to the "
            f"solo solve's {np.array_equal(res.eigenvalues, solo.eigenvalues)}"
            f", rel err to phase 5's {rel.max():.2e} (tol 1e-5) | true "
            f"residuals max {resid.max():.2e} (limit {RESID_TOL:g})")
        if not (res.converged and np.all(resid <= RESID_TOL)):
            fail(f"namespace {sid}: not converged or residuals {resid}")
        if stats[sid] != solo.io_stats:
            fail(f"namespace {sid}: IOStats split {stats[sid]} differs "
                 f"from the solo solve's {solo.io_stats}")
        if not rel.max() <= 1e-5:
            fail(f"namespace {sid}: eigenvalues off phase 5's by {rel}")
    log(f"namespace: walls solo {wall_solo:.3f} s | sequential "
        f"{walls['seq0']:.3f} + {walls['seq1']:.3f} s | two threads "
        f"{walls['threads']:.3f} s | launches in the threads "
        f"{json.dumps(launches)} | splits sum to the store's counters "
        f"exactly: {reconciled} ({json.dumps(sums)})")
    if not reconciled:
        fail(f"namespace splits {sums} do not sum to the store's {parent}")
    before = store.namespace("thr0").device_bytes()
    kept = stats["thr0"]
    store.drop_namespace("thr0")
    after = store.namespace("thr0").device_bytes()
    log(f"namespace: drop_namespace('thr0') freed {before} device bytes "
        f"(left {after}), stats kept: "
        f"{store.namespace_stats()['thr0'] == kept}")
    if not (before > 0 and after == 0
            and store.namespace_stats()["thr0"] == kept):
        fail("drop_namespace did not free the namespace or lost its stats")
    store.close()
    log(f"namespace: phase 24 took {time.perf_counter() - t_phase:.1f} s")


def block_count(r, c, n: int) -> int:
    """Distinct 64×64 blocks that hold an entry: the all-dense image's
    block count, without packing it."""
    nbc = -(-n // BLOCK[1])
    keys = (r // BLOCK[0]).astype(np.int64) * nbc + c // BLOCK[1]
    return int(np.unique(keys).size)


def spmm_ladder_phase(torch, op, graph, spmm_row) -> None:
    """Phase 25: bench_spmm's Fig. 6 ladder at 2^20 (coo and +hybrid) over
    phase 3's graph and at 2^18 (every rung), each rung at k = 1 and 4
    held against its plain version (`bench_spmm.validate`)."""
    from repro_torch.benchmarks import bench_spmm
    from repro_torch.kernels import spmm_tile
    from repro_torch.kernels.spmm_ref import coo_spmm_ref
    t_phase = time.perf_counter()
    dev = op.device
    n = 2 ** N_LOG2
    r, c, _ = graph
    nb_all = block_count(r, c, n)
    log(f"spmm ladder 2^{N_LOG2}: +blocking left out: all {r.size} entries "
        f"in dense 64x64 blocks would be {nb_all} blocks "
        f"({nb_all * 64 * 64 * 4 / 1e9:.1f} GB float32), more than the "
        f"card holds")
    zero_counters()
    m = bench_spmm.collect(device=dev, n=n, nnz=2 ** NNZ_LOG2, graph=graph,
                           blocking=False)
    torch.cuda.synchronize()
    launched = spmm_tile.LAUNCHES
    ladder_log(m, launched)
    # the solver's own image (phase 3, at least 4 entries per block):
    # its COO remainder alone and its whole matmat, at k = 4
    x = torch.randn((n, BLOCK_SIZE), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(11))
    rows, cols, vals = op._coo
    timer = Timer(torch, dev)
    coo_ms = timer.ms(lambda: coo_spmm_ref(rows, cols, vals, x, n))
    matmat_ms = timer.ms(lambda: op.matmat(x))
    k4 = m["k"][str(BLOCK_SIZE)]["us"]
    log(f"spmm ladder 2^{N_LOG2}, k={BLOCK_SIZE}: coo rung (all "
        f"{m['entries']} entries) {k4['coo'] / 1e3:.3f} ms | +hybrid "
        f"matmat (blocks of >= 8 entries + {m['hybrid']['coo']} COO) "
        f"{k4['hybrid'] / 1e3:.3f} ms | phase 4's SpMM kernel on the "
        f"solver's image (>= 4 entries per block) {spmm_row['ms']:.3f} ms, "
        f"its COO remainder ({vals.shape[0]} entries) alone {coo_ms:.3f} ms"
        f", its whole matmat {matmat_ms:.3f} ms (L2 flushed, medians)")
    del x
    n18 = 2 ** 18
    from repro_torch.graphs import normalized_adjacency, rmat_graph
    r18, c18, v18 = normalized_adjacency(n18, *rmat_graph(
        n18, 2 ** 21, seed=GRAPH_SEED, symmetric=True))
    zero_counters()
    m18 = bench_spmm.collect(device=dev, n=n18, nnz=2 ** 21,
                             graph=(r18, c18, v18))
    torch.cuda.synchronize()
    ladder_log(m18, spmm_tile.LAUNCHES)
    log(f"spmm ladder: phase 25 took {time.perf_counter() - t_phase:.1f} s")


def ladder_log(m: dict, launched: int) -> None:
    from repro_torch.benchmarks import bench_spmm
    label = f"spmm ladder n={m['n']}"
    imgs = {t: m[t] for t in ("blocking", "hybrid") if t in m}
    log(f"{label}: {m['entries']} entries | images "
        + ", ".join(f"+{t} {d['nblocks']} blocks + {d['coo']} COO "
                    f"({d['nbytes_image'] / 1e9:.2f} GB)"
                    for t, d in imgs.items())
        + f" | imbalance over {m['workers']} workers: round-robin "
        f"{m['balance']['imb_naive']:.3f}, LPT {m['balance']['imb_lpt']:.3f}"
        f" | spmm_blocksparse launches {launched}")
    for k, rec in m["k"].items():
        log(f"{label}, k={k}: ms per call "
            + ", ".join(f"{t} {us / 1e3:.3f}" for t, us in rec["us"].items())
            + f" | rel err to the plain version "
            f"{json.dumps(rec['max_rel_err'])} (tol {bench_spmm.TOL:g} of "
            f"Σ|terms|) | SEM/IM modeled {rec['sem']['ratio']:.2f}")
    try:
        bench_spmm.validate(m)
    except AssertionError as e:
        fail(f"{label}: {e}")
    if launched <= 0:
        fail(f"{label}: the blocked rungs launched no spmm_blocksparse")


def tasops_phase(torch, dev) -> None:
    """Phase 26: bench_tasops's Fig. 9-11 ladder at n = 2^20, b = 4, m =
    16, 64, 256; its io_bytes a whole number of blocks, as a CPU run at
    its own n gives them."""
    from repro_torch.benchmarks import bench_tasops
    t_phase = time.perf_counter()
    zero_counters()
    m = bench_tasops.collect(device=dev, n=2 ** 20, b=4)
    torch.cuda.synchronize()
    launches = kernel_launches()
    cpu = bench_tasops.collect(device="cpu", smoke=True)
    blk, blk_cpu = m["n"] * m["b"] * 4, cpu["n"] * cpu["b"] * 4
    for ms, r in m["m"].items():
        blocks = {t: r[t]["io_bytes"] / blk
                  for t in ("naive", "cache", "lazy_scale")}
        blocks_cpu = {t: cpu["m"][ms][t]["io_bytes"] / blk_cpu
                      for t in blocks}
        log(f"tasops m={ms}: io_bytes naive {r['naive']['io_bytes']}, "
            f"+recent-cache {r['cache']['io_bytes']}, +lazy-scale "
            f"{r['lazy_scale']['io_bytes']} = {json.dumps(blocks)} blocks "
            f"of n·b·4 (CPU run at n={cpu['n']}: {json.dumps(blocks_cpu)}) "
            f"| ms naive {r['naive']['us'] / 1e3:.3f}, +recent-cache "
            f"{r['cache']['us'] / 1e3:.3f}, mv_trans_mv g2 "
            f"{r['mv_trans_mv_us']['g2'] / 1e3:.3f} g8 "
            f"{r['mv_trans_mv_us']['g8'] / 1e3:.3f} | modeled tier "
            f"io/compute {r['tier']['io_over_compute']:.2f}")
        if blocks != blocks_cpu:
            fail(f"tasops m={ms}: {blocks} blocks, the CPU run {blocks_cpu}")
    try:
        bench_tasops.validate(m)
    except AssertionError as e:
        fail(f"tasops: {e}")
    log(f"tasops: launches {json.dumps(launches)}")
    require_launched("tasops", launches, ("gram", "tsgemm"))
    log(f"tasops: phase 26 took {time.perf_counter() - t_phase:.1f} s")


def subspace_io_phase(torch, dev) -> None:
    """Phase 27: bench_subspace_io's expansion and compress ladders at n =
    2^20, b = 4, nb = SUBIO_NB, its e2e and SAFS parity solves at the
    reference's sizes; `validate` on the card's metrics."""
    from repro_torch.benchmarks import bench_subspace_io
    t_phase = time.perf_counter()
    zero_counters()
    m = bench_subspace_io.collect(device=dev, n=2 ** 20, b=4, nb=SUBIO_NB)
    torch.cuda.synchronize()
    launches = kernel_launches()
    exp, comp, e2e, sf = (m["expansion"], m["compress"], m["eigsh_e2e"],
                          m["safs"])
    log(f"subspace_io: expansion n={exp['n']} nb={exp['nblocks']}: bytes "
        f"read fused {exp['fused']['host_bytes_read']} "
        f"({exp['fused']['passes']} passes), unfused "
        f"{exp['unfused']['host_bytes_read']} "
        f"({exp['unfused']['passes']}), ratio {exp['fused_over_unfused']:.3f}"
        f" | compress k_keep={comp['k_keep']}: passes fused "
        f"{comp['fused']['passes']}, unfused {comp['unfused']['passes']}, "
        f"reads/subspace {comp['fused']['reads_over_subspace']:.2f}")
    log(f"subspace_io: e2e n={e2e['n']}: restarts fused "
        f"{e2e['fused']['n_restarts']} unfused {e2e['unfused']['n_restarts']}"
        f", passes {e2e['fused']['passes']} / {e2e['unfused']['passes']}, "
        f"pass bytes {e2e['fused']['pass_bytes_read']} / "
        f"{e2e['unfused']['pass_bytes_read']}, parity {e2e['max_rel_err']:.1e}"
        f" | safs: expansion ms fused {sf['fused']['us'] / 1e3:.1f} unfused "
        f"{sf['unfused']['us'] / 1e3:.1f} (physical bytes read "
        f"{sf['fused']['physical_bytes_read']} / "
        f"{sf['unfused']['physical_bytes_read']}), eigsh parity "
        f"{sf['eigsh_max_rel_err']:.1e} | launches {json.dumps(launches)}")
    try:
        bench_subspace_io.validate(m)
    except AssertionError as e:
        fail(f"subspace_io: {e}")
    require_launched("subspace_io", launches,
                     ("spmm_blocksparse", "gram", "tsgemm"))
    log(f"subspace_io: phase 27 took {time.perf_counter() - t_phase:.1f} s")


def safs_read_log(label: str, rt: dict) -> None:
    for ps, r in rt.items():
        log(f"{label} {int(ps) // 1024} KiB pages ({r['n_pages']} pages): "
            f"legacy {r['legacy_pages_per_s']:,.0f}, batched "
            f"{r['batched_pages_per_s']:,.0f}, readahead pool "
            f"{r['readahead_pool_pages_per_s']:,.0f} pages/s | bare preadv "
            f"floor {r['bare_GB_per_s']:.3f} GB/s = "
            f"{r['bare_pages_per_s']:,.0f} pages/s | batched takes "
            f"{r['batched_over_bare_time']:.2f}x the bare read's time")


def safs_bench_phase(torch, dev) -> None:
    """Phase 28: bench_safs at n = 2^20, b = 4, m = SAFS_BENCH_M, its
    read ladder over 8 files of 64 MiB beside the bare-read floor, under
    the temporary directory (its filesystem printed)."""
    from repro_torch.benchmarks import bench_safs
    t_phase = time.perf_counter()
    log(f"safs bench: {root_line(tempfile.gettempdir())}")
    zero_counters()
    m = bench_safs.collect(device=dev, n=2 ** 20, b=4, m=SAFS_BENCH_M,
                           nfiles=8, file_kb=64 << 10)
    torch.cuda.synchronize()
    launches = kernel_launches()
    safs_read_log("safs bench (temporary directory)", m["read_throughput"])
    st, en, ca, ig = (m["safs_stream"], m["safs_endurance"],
                      m["safs_cache"], m["safs_integrity"])
    on = st["prefetch_on"]
    log(f"safs bench m={m['m']}: mv_times_mat prefetch off "
        f"{st['prefetch_off']['us'] / 1e3:.1f} ms, on "
        f"{on['us'] / 1e3:.1f} ms (overlap fraction "
        f"{on['overlap_fraction']:.2f}) = "
        f"{on['logical_bytes_read'] / on['us'] / 1e3:.3f} GB/s | "
        f"endurance: physical/logical writes "
        f"{en['disk_over_logical_writes']:.4f} ({en['physical_bytes_written']}"
        f" / {en['logical_bytes_written']}) | reorth hit rate pinned "
        f"{ca['page_hit_rate']:.3f}, LRU only {ca['lru_only_hit_rate']:.3f}"
        f" | verify-on-read +{100 * ig['verify_overhead']:.1f}%, scrub "
        f"{ig['scrub_pages_per_s']:,.0f} pages/s | launches "
        f"{json.dumps(launches)}")
    require_launched("safs bench", launches, ("gram", "tsgemm"))
    log(f"safs bench: phase 28 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- the service

def serve_embed_serial(torch, op) -> dict:
    """bg-embed's private serial run, before phase 29 and over phase 3's
    image: the job's graph is phase 3's (the same `rmat_graph` →
    `normalized_adjacency` → `pack_tiles` as the session's
    `build_problem`), so a `SolveSession` of the job's spec runs on a
    fresh CUDA RAM-tier store over that operator instead of packing the
    2^20 graph a second time. Returns its eigenvalues and the image's
    shape, which the served job's build must match."""
    from repro_torch.core import TieredStore
    from repro_torch.serve import JobSpec, SolveSession
    from repro_torch.serve import session as session_mod
    spec = JobSpec.from_dict(copy.deepcopy(SERVE_JOBS[0]))

    def phase3_problem(spec_, store):
        op_ = copy.copy(op)
        op_.store = store
        return op_, None

    real = session_mod.build_problem
    session_mod.build_problem = phase3_problem
    try:
        s = SolveSession(spec, TieredStore(device=op.device), None)
        t0 = time.perf_counter()
        state = s.run()
        wall = time.perf_counter() - t0
    finally:
        session_mod.build_problem = real
    if state != "done":
        fail(f"bg-embed's serial run ended {state}: {s.error}")
    log(f"serve: bg-embed's serial run over phase 3's image {wall:.3f} s, "
        f"restarts {s.result['n_restarts']}, eigenvalues "
        f"{np.array2string(np.array(s.result['eigenvalues']), precision=8)}")
    return {"eigenvalues": s.result["eigenvalues"],
            "blocks": int(op._blocks.shape[0]),
            "coo": int(op._coo[2].shape[0])}


def serve_serial(torch, dev, d: dict) -> list:
    """A job's private serial run: a fresh `SolveSession` of the same
    spec on a private CUDA RAM-tier store."""
    from repro_torch.core import TieredStore
    from repro_torch.serve import JobSpec, SolveSession
    s = SolveSession(JobSpec.from_dict(copy.deepcopy(d)),
                     TieredStore(device=dev), None)
    if s.run() != "done":
        fail(f"{d['job_id']}'s serial run ended {s.state}: {s.error}")
    return s.result["eigenvalues"]


def paged_kv_phase(torch, dev, store, solver_ids) -> dict:
    """A paged KV cache in namespace "kv" of the service's store, at
    yi-9b's KV geometry: 4,096 appended tokens, 24 of 32 pages spilled to
    the host tier, one 32-head attend against plain dense attention over
    the same k/v, its host-tier reads in its namespace's IOStats, and
    `close()` leaving every solver namespace as it was."""
    from repro_torch.serve import PagedConfig, PagedKVCache
    cfg = PagedConfig(**KV_GEOM)
    names0 = {sid: store.namespace(sid).names() for sid in solver_ids}
    stats0 = copy.deepcopy({sid: store.namespace_stats()[sid]
                            for sid in solver_ids})
    kv = PagedKVCache(cfg, store, session_id="kv")
    gen = torch.Generator(device=dev).manual_seed(29)
    shape = (KV_TOKENS, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vs = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((KV_QUERY_HEADS, cfg.head_dim), generator=gen,
                    device=dev)
    kv.start(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(KV_TOKENS):
        kv.append(0, ks[t], vs[t])
    torch.cuda.synchronize()
    t_append = time.perf_counter() - t0
    table = kv._tables[0]
    spilled = sum(kv.store.tier_of(n) == "host" for n in table)
    page_bytes = 2 * cfg.page_size * cfg.n_kv_heads * cfg.head_dim * 2
    before = dict(store.namespace_stats()["kv"])
    t0 = time.perf_counter()
    out = kv.attend(0, q)
    torch.cuda.synchronize()
    t_attend = time.perf_counter() - t0
    after = dict(store.namespace_stats()["kv"])
    g = KV_QUERY_HEADS // cfg.n_kv_heads
    qg = q.reshape(cfg.n_kv_heads, g, cfg.head_dim)
    sc = torch.einsum("kgd,skd->kgs", qg, ks.float()) / cfg.head_dim ** 0.5
    dense = torch.einsum("kgs,skd->kgd", torch.softmax(sc, dim=-1),
                         vs.float()).reshape(KV_QUERY_HEADS, cfg.head_dim)
    err = float((out - dense).abs().max() / dense.abs().max())
    reads = after["host_bytes_read"] - before["host_bytes_read"]
    kv.close()
    names1 = {sid: store.namespace(sid).names() for sid in solver_ids}
    stats1 = {sid: store.namespace_stats()[sid] for sid in solver_ids}
    log(f"serve kv: {KV_TOKENS} tokens into {len(table)} pages of "
        f"{page_bytes} bytes ({spilled} on the host tier) in {t_append:.2f}"
        f" s | attend of {KV_QUERY_HEADS} heads {t_attend * 1e3:.2f} ms, "
        f"max |Δ| against dense attention {err:.3e} of its largest "
        f"magnitude (limit 2^-8) | host reads in its namespace "
        f"{reads} bytes, {after['host_reads'] - before['host_reads']} reads "
        f"| its IOStats {json.dumps(after)}")
    if len(table) != KV_TOKENS // cfg.page_size or \
            spilled != len(table) - cfg.hot_pages:
        fail(f"serve kv: {spilled} of {len(table)} pages spilled")
    if not err <= FLASH_TOL:
        fail(f"serve kv: attend off dense attention by {err:.3e}")
    if reads != spilled * page_bytes:
        fail(f"serve kv: {reads} host bytes read in its namespace, not "
             f"{spilled * page_bytes}")
    if names1 != names0 or stats1 != stats0:
        fail("serve kv: close() changed a solver namespace")
    return {"append_s": t_append, "attend_ms": t_attend * 1e3, "err": err,
            "host_bytes_read": reads}


def serve_cli_phase(tmp: str) -> None:
    """`repro_torch.launch.serve --demo --device cuda` in this process,
    its roots under the phase's temporary directory: it must return 0 and
    report at least one preemption."""
    from repro_torch.launch import serve as serve_cli
    out = os.path.join(tmp, "demo_report.json")
    t0 = time.perf_counter()
    rc = serve_cli.main(["--demo", "--device", "cuda", "--backend", "safs",
                         "--root", os.path.join(tmp, "demo_pages"),
                         "--ckpt-root", os.path.join(tmp, "demo_ckpt"),
                         "--out", out])
    wall = time.perf_counter() - t0
    with open(out) as fh:
        rep = json.load(fh)
    preempts = sum(j["preemptions"] for j in rep["jobs"])
    log(f"serve cli: --demo on the card returned {rc} in {wall:.2f} s | "
        f"{len(rep['jobs'])} jobs, {preempts} preemptions, valid "
        f"{rep['valid']}")
    if rc != 0 or not rep["valid"] or preempts < 1:
        fail(f"serve cli: rc {rc}, {preempts} preemptions, errors "
             f"{rep['errors']}")


def row_width(name: str) -> tuple[str, str]:
    """A solver row of the kernels line → its kernel and the key of its
    width in `launches_by_width`: spmm_blocksparse_k8 → (spmm_blocksparse,
    k8), gram_b24 → (gram, 24x24); a row without a suffix runs at
    BLOCK_SIZE."""
    m = re.fullmatch(r"(spmm_blocksparse|gram|tsgemm)(?:_[kb](\d+))?", name)
    kernel, w = m.group(1), int(m.group(2) or BLOCK_SIZE)
    return kernel, f"k{w}" if kernel == "spmm_blocksparse" else f"{w}x{w}"


def serve_launches(name: str, by_width: dict, other: dict) -> int:
    """A kernels-line row's launches at its width in phase 29."""
    if name in other:
        return other[name]
    kernel, key = row_width(name)
    return by_width[kernel].get(key, 0)


def spmm_f64(torch, op, x):
    """A·X in float64 over a resident operator's image, with Σ|terms| per
    element and each row's count of nonzero terms (`spmm_ref.spmm_f64`)."""
    from repro_torch.kernels.spmm_ref import spmm_f64 as exact
    return exact(op._blocks, op._block_cols, op._row_ptr, op._coo, x)


def serve_kernel_check(torch, op, res, by_width: dict):
    """One served job's kernels against exact float64 products, after
    drain and after the launch counters were read (these launches do not
    count), on the job's own image and eigenvectors V (n, nev) at every
    width the phase launched each kernel at (V's columns repeated to the
    width; tsgemm's small factor is V's own Gram): the SpMM and its plain
    version each within max(KERNEL_TOL, γ_{m+1}) of Σ|terms| in a row of
    m nonzero terms (γ_j = j·u / (1 − j·u), u = 2^-24: the bound on any
    float32 sum of those terms, whatever its order; a hub row of an
    R-MAT image sums tens of thousands of same-signed terms of an
    eigenvector), gram and tsgemm within KERNEL_TOL of Σ|terms| (their
    plain versions' errors printed beside, cuBLAS float32 strays more at
    n = 2^20, §7 of PERF.md). Then the true residuals through the kernel
    and through the plain SpMM, both within RESID_TOL, their gap within
    KERNEL_TOL of ‖A|V|‖ / max(1, |θ|) per pair. Returns the residuals,
    the kernels' and plain versions' errors with the SpMM's largest share
    of its bound, and the failures."""
    from repro_torch.core import true_residuals
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmm_ref import float32_sum_bound
    kern = copy.copy(op)     # off the store: no IOStats after the report
    kern.store, kern.impl = None, "auto"
    plain = copy.copy(kern)
    plain.impl = "ref"
    v = torch.as_tensor(res.eigenvectors, dtype=torch.float32,
                        device=op.device)
    nev = v.shape[1]

    def cols(w):
        return v[:, [i % nev for i in range(w)]]

    errs, plain_errs, of_bound, failures = {}, {}, {}, []
    for key in by_width["spmm_blocksparse"]:
        x = cols(int(key[1:]))
        exact, terms, count = spmm_f64(torch, op, x)
        bound = float32_sum_bound(terms, count, KERNEL_TOL)
        for name, y, out in (("kernel", kern.matmat(x), errs),
                             ("plain", plain.matmat(x), plain_errs)):
            over = ((y.double() - exact).abs() / bound).nan_to_num(
                nan=0.0, posinf=float("inf"))      # 0 / 0 in empty rows
            out[f"spmm {key}"] = rel_err(y, exact, terms)
            of_bound[f"{name} {key}"] = float(over.max())
            if bool((over > 1).any()):
                failures.append(
                    f"spmm {key}: the {name} version off the float64 "
                    f"product by {float(over.max()):.3g} times its "
                    f"float32 bound")
        del exact, terms, count, bound
    for key in by_width["gram"]:
        a, b = (cols(int(w)) for w in key.split("x"))
        exact = a.double().T @ b.double()
        terms = a.abs().double().T @ b.abs().double()
        errs[f"gram {key}"] = rel_err(ops.gram(a, b), exact, terms)
        plain_errs[f"gram {key}"] = rel_err(ops.gram(a, b, impl="ref"),
                                            exact, terms)
    for key in by_width["tsgemm"]:
        m, b = map(int, key.split("x"))
        a, c0 = cols(m), cols(b)
        small = ops.gram(a, c0, impl="ref")
        exact = c0.double() - a.double() @ small.double()
        terms = a.abs().double() @ small.abs().double() + c0.abs().double()
        errs[f"tsgemm {key}"] = rel_err(
            ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=c0), exact, terms)
        plain_errs[f"tsgemm {key}"] = rel_err(
            ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=c0, impl="ref"),
            exact, terms)
    bad = {k: e for k, e in errs.items()
           if not k.startswith("spmm") and not e <= KERNEL_TOL}
    if bad:
        failures.append(f"kernels off the float64 product (tol "
                        f"{KERNEL_TOL:g} of Σ|terms|): {bad}")
    theta = np.asarray(res.eigenvalues)
    r = true_residuals(kern, v, theta)
    r_plain = true_residuals(plain, v, theta)
    gap_tol = KERNEL_TOL * (torch.linalg.norm(plain.matmat(v.abs()), dim=0)
                            .cpu().numpy() / np.maximum(1.0, np.abs(theta)))
    if not (np.all(r <= RESID_TOL) and np.all(r_plain <= RESID_TOL)):
        failures.append(f"true residuals {r}, through the plain SpMM "
                        f"{r_plain}")
    if not np.all(np.abs(r - r_plain) <= gap_tol):
        failures.append(f"residuals through the kernel {r} and the plain "
                        f"SpMM {r_plain} differ by more than {gap_tol}")
    return (r, r_plain), (errs, plain_errs, of_bound), failures


def serve_phase(torch, dev, embed_serial: dict) -> tuple[dict, dict]:
    """Phase 29: the eigensolver service over one SAFS store on the card.
    The launch counters are zeroed just before the jobs are submitted and
    read just after `drain()`; returns them (by width, and the bf16 SpMM
    and flash counts) for the kernels line's `serve_launches`. Each job's
    operator and result are held until then, and its kernels checked
    against their plain versions after (`serve_kernel_check`)."""
    import threading
    import weakref
    from repro_torch.kernels import flashattn, spmm_tile
    from repro_torch.serve import PreemptFlag, build_service, validate_report
    from repro_torch.serve import session as session_mod
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="serve_")
    lock = threading.Lock()
    builds, ops, solved, latency, allotted = {}, [], {}, [], {}
    real_build, real_solve = session_mod.build_problem, session_mod.solve

    def timed_build(spec, store):
        t0 = time.perf_counter()
        op, labels = real_build(spec, store)
        with lock:
            builds.setdefault(spec.job_id, []).append({
                "s": time.perf_counter() - t0, "image": op._image_bytes,
                "blocks": int(op._blocks.shape[0]),
                "coo": int(op._coo[2].shape[0])})
            ops.append(weakref.ref(op))
        return op, labels

    def checked_solve(op, nev, **kw):
        res = real_solve(op, nev, **kw)     # SolveSuspended passes through
        with lock:                          # checked after drain()
            solved[op.store.session_id] = (op, res)
        return res

    class TimedFlag(PreemptFlag):
        """The scheduler's flag, with the time it was raised."""
        raised_at = None

        def request(self):
            self.raised_at = time.perf_counter()
            super().request()

    def timed(session):
        session.guard = TimedFlag()
        run = session.run

        def run_and_time():
            state = run()
            if state == "suspended" and session.guard.raised_at is not None:
                latency.append((session.spec.job_id, time.perf_counter()
                                - session.guard.raised_at))
                session.guard.raised_at = None
            return state

        session.run = run_and_time
        return session

    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    svc = build_service(backend="safs", root=os.path.join(tmp, "pages"),
                        device_budget=SERVE_BUDGET, min_share=SERVE_MIN_SHARE,
                        cache_bytes=SERVE_CACHE,
                        ckpt_root=os.path.join(tmp, "ckpt"),
                        max_concurrent=SERVE_MAX_CONCURRENT, device=dev)
    admit = svc.arbiter.admit

    def recording_admit(sid, priority=0):
        share = admit(sid, priority)
        allotted.setdefault(sid, []).append(share)
        return share

    svc.arbiter.admit = recording_admit
    log(f"serve: service on {dev} | SAFS page root {tmp} | device budget "
        f"{SERVE_BUDGET >> 20} MiB, min_share {SERVE_MIN_SHARE >> 20} MiB, "
        f"page cache {SERVE_CACHE >> 20} MiB, {SERVE_MAX_CONCURRENT} "
        f"sessions at a time")
    session_mod.build_problem, session_mod.solve = timed_build, checked_solve
    try:
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in SERVE_JOBS:
            timed(svc.submit(copy.deepcopy(d)))
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            svc.scheduler.tick()
            running = svc.scheduler.stats_dict()["running"]
            if any(p["steps"] >= 1 for p in running.values()):
                break
            time.sleep(0.02)
        else:
            fail("serve: no background job reported a step in 600 s")
        t_rush = time.perf_counter() - t0
        timed(svc.submit(copy.deepcopy(SERVE_RUSH)))
        svc.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_width, totals = launches_by_width(), kernel_launches()
        other = {"spmm_blocksparse_bf16": spmm_tile.LAUNCHES_BF16,
                 "flash_attention": flashattn.LAUNCHES}
    finally:
        session_mod.build_problem, session_mod.solve = real_build, real_solve
    peak = torch.cuda.max_memory_allocated()
    t_check = time.perf_counter()
    resid, kernel_err, failures = {}, {}, []
    for jid in sorted(solved):
        resid[jid], kernel_err[jid], bad = serve_kernel_check(
            torch, *solved[jid], by_width)
        failures += [f"{jid}: {b}" for b in bad]
        log(f"serve: {jid}'s kernels against the float64 product, of "
            f"Σ|terms|: {json.dumps(kernel_err[jid][0])} | their plain "
            f"versions: {json.dumps(kernel_err[jid][1])} | the SpMM's "
            f"largest share of its per-row bound: "
            f"{json.dumps(kernel_err[jid][2])}")
    torch.cuda.synchronize()
    t_check = time.perf_counter() - t_check
    solved.clear()
    gc.collect()
    live = [r() for r in ops if r() is not None]
    mem1 = torch.cuda.memory_allocated()
    ids = [d["job_id"] for d in SERVE_JOBS] + [SERVE_RUSH["job_id"]]
    kv = paged_kv_phase(torch, dev, svc.store, ids)
    rep = svc.report()
    errors = validate_report(rep)
    svc.close()
    clean = json.loads(json.dumps(rep)) == rep

    jobs = {j["job_id"]: j for j in rep["jobs"]}
    specs = {d["job_id"]: d for d in SERVE_JOBS + (SERVE_RUSH,)}
    t_serial = time.perf_counter()
    serial = {"bg-embed": embed_serial["eigenvalues"]}
    for jid in ids[1:]:
        serial[jid] = serve_serial(torch, dev, specs[jid])
    t_serial = time.perf_counter() - t_serial
    t_build = sum(b["s"] for v in builds.values() for b in v)
    lat = ", ".join(f"{j} {dt * 1e3:.1f} ms" for j, dt in latency)
    log(f"serve: {len(ids)} jobs drained in {wall:.2f} s (rush submitted at "
        f"{t_rush:.2f} s) | problem builds {t_build:.2f} s summed over the "
        f"worker threads | preemption latency, flag to SolveSuspended: "
        f"{lat or 'none'} | peak device memory {peak / 1e9:.2f} GB; "
        f"allocated before {mem0 / 1e9:.3f} GB, after drain "
        f"{mem1 / 1e9:.3f} GB")
    log("serve: job | kind | n | state | wall s | queue wait s | preempts | "
        "resumes | resumed step | restarts | builds s | allotted MiB | "
        "true resid max, kernel / plain SpMM | kernels' rel err to float64 "
        "(plain's) | "
        "rel err to serial | sha")
    for jid in ids:
        j, d = jobs[jid], specs[jid]
        res = j["result"] or {}
        got = np.array(res.get("eigenvalues") or [np.nan])
        want = np.array(serial[jid])
        rel = (float(np.max(np.abs(got - want) / np.abs(want)))
               if got.shape == want.shape else float("inf"))
        r = resid.get(jid)
        built = "+".join(f"{b['s']:.1f}" for b in builds.get(jid, []))
        shares = "/".join(str(a >> 20) for a in allotted.get(jid, []))
        worst = "-" if r is None else \
            f"{r[0].max():.2e} / {r[1].max():.2e} | " \
            f"{max(kernel_err[jid][0].values()):.2e} " \
            f"({max(kernel_err[jid][1].values()):.2e})"
        log(f"serve: {jid} | {j['kind']} | {d['n']} | {j['state']} | "
            f"{j['wall_s']:.2f} | {j['queue_wait_s']:.3f} | "
            f"{j['preemptions']} | {j['resumes']} | "
            f"{res.get('resumed_step')} | {res.get('n_restarts')} | "
            f"{built} | {shares} | {worst} | {rel:.2e} | "
            f"{(j['spectrum'] or {}).get('sha')}")
        if j["state"] != "done" or not res.get("converged"):
            failures.append(f"{jid} ended {j['state']}, converged "
                            f"{res.get('converged')}: {j['error']}")
        if jid not in resid:
            failures.append(f"{jid}: no solve returned")
        if not rel <= 1e-5:
            failures.append(f"{jid}: eigenvalues {got} against the serial "
                            f"run's {want}")
        if j["preemptions"] and (j["resumes"] < 1
                                 or res.get("resumed_step") is None):
            failures.append(f"{jid} preempted but not resumed")
    embed = builds.get("bg-embed", [{}])[0]
    physical = {k: [v["host_bytes_read"], v["host_bytes_written"]]
                for k, v in rep["backend"]["namespaces"].items()}
    log(f"serve: physical bytes [read, written] per namespace "
        f"{json.dumps(physical)} | backend totals read "
        f"{rep['backend']['io']['host_bytes_read']} written "
        f"{rep['backend']['io']['host_bytes_written']} | purity "
        f"{jobs['bg-cluster']['purity']} | serial runs {t_serial:.1f} s | "
        f"kernels and plain versions held against float64 after drain, at "
        f"every width below, on each job's image and eigenvectors "
        f"{t_check:.1f} s | launches {json.dumps(by_width)}")
    if errors:
        failures.append(f"validate_report: {errors}")
    if not clean:
        failures.append("the report is not JSON-clean")
    if sum(j["preemptions"] for j in jobs.values()) < 1:
        failures.append("no job was preempted")
    if not jobs["rush"]["queue_wait_s"] < jobs["bg-cluster"]["queue_wait_s"]:
        failures.append("the rush job waited as long as bg-cluster")
    if not (jobs["bg-cluster"]["purity"] or 0) > SERVE_PURITY:
        failures.append(f"purity {jobs['bg-cluster']['purity']}")
    if (embed.get("blocks"), embed.get("coo")) != \
            (embed_serial["blocks"], embed_serial["coo"]):
        failures.append(f"bg-embed's image {embed} is not phase 3's")
    for name in ("spmm_blocksparse", "gram", "tsgemm"):
        if totals[name] <= 0:
            failures.append(f"kernel {name} was not launched by a session")
    if live:
        failures.append(f"{len(live)} session operators still referenced "
                        f"after drain()")
    limit = min(b["image"] for jid in ("bg-embed", "bg-lobpcg", "rush")
                for b in builds.get(jid, [{"image": 0}]))
    if not mem1 - mem0 <= limit:
        failures.append(f"device memory {mem1 - mem0} bytes above where it "
                        f"was before the phase (limit: the smallest R-MAT "
                        f"image, {limit})")
    if failures:
        fail("serve: " + "; ".join(failures))
    serve_cli_phase(tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"serve: phase 29 took {time.perf_counter() - t_phase:.1f} s "
        f"(device memory limit after drain {limit} bytes; kv "
        f"{json.dumps(kv)})")
    return by_width, other


# ------------------------------------------------------------ sharded

def sorted_rel_err(got, want) -> float:
    """max_i |got_i − want_i| / |want_i| over both spectra sorted."""
    got, want = np.sort(np.asarray(got)), np.sort(np.asarray(want))
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def dist_bytes_line(o: dict) -> str:
    """One rank's collective bytes of the dist solve beside the count the
    design gives (`DistOperator.analytic_bytes`), host-staged bytes, peak
    device memory, panel and launches."""
    got = {k: o["bytes"].get(k, 0) for k in o["analytic_bytes"]}
    return (f"rank {o['rank']}: program collectives {json.dumps(got)} "
            f"(analytic {json.dumps(o['analytic_bytes'])}) | controller "
            f"scatter {o['bytes'].get('scatter', 0)} gather "
            f"{o['bytes'].get('gather', 0)} broadcast "
            f"{o['bytes'].get('broadcast', 0)} | host-staged "
            f"{o['bytes'].get('staged', 0)} | peak device "
            f"{o.get('peak_device_bytes', 0) / 1e9:.3f} GB | panel "
            f"{o['panel']['entries']} entries, {o['panel']['blocks']} dense "
            f"blocks, COO share {o['panel']['coo_share']:.4f} | launches "
            f"{json.dumps(o['launches'])}")


def check_dist_bytes(label: str, o: dict) -> None:
    for kind, want in o["analytic_bytes"].items():
        if o["bytes"].get(kind, 0) != want:
            fail(f"{label} rank {o['rank']}: {kind} moved "
                 f"{o['bytes'].get(kind, 0)} bytes, the design gives {want}")


def dist_phase(torch, dev, graph, res32, wall32) -> dict:
    """Phase 30: the sharded layer (`repro_torch.dist`) on the card.

    30a, one rank over NCCL at phase 3's size: a one-rank world, a
    `DistOperator` on a (1, 1, 1) mesh over phase 3's graph, and phase 5's
    solve over it through `solve` (eigsh's fused expansion), the launch
    counters zeroed just before and read just after; eigenvalues within
    rtol 1e-5 of phase 5's, true residuals ≤ 1e-4, fused steps, SpMM,
    gram and tsgemm launched, collective bytes equal to the design's.
    Then, in the same world, the one-rank run of 30b's graph.

    30b, DIST_SHAPE ranks sharing the card over gloo (`dist.spawn` of
    `examples.dist_eigen_e2e.run_ranks`): the same solve from the same
    natural-space start block, eigenvalues within rtol 1e-5 of the
    one-rank run's; the pod-compressed run over DIST_POD_RESTARTS
    restarts and the compressed stream within the reference's gates;
    every rank's launches, collective bytes against the design's count,
    host-staged bytes, peak device memory and COO share printed; every
    rank's SpMM, gram and tsgemm held against float64 products at the
    rank's own shapes after its solve (`dist_eigen_e2e.kernel_check`,
    serve_kernel_check's limits). Returns 30a's launches by width."""
    from repro_torch.core import solve, true_residuals
    from repro_torch.dist import DistOperator, Mesh, comm, spawn
    from repro_torch.examples import dist_eigen_e2e as e2e
    t_phase = time.perf_counter()
    cfg = dict(graph=("rmat_normalized", 2 ** DIST_LOG2, 2 ** DIST_NNZ_LOG2,
                      GRAPH_SEED), nev=NEV, block_size=BLOCK_SIZE,
               num_blocks=NUM_BLOCKS, tol=TOL, max_restarts=MAX_ITERS,
               x0_seed=DIST_X0_SEED)
    comm.init_world("nccl", rank=0, world_size=1, device=dev,
                    timeout=DIST_TIMEOUT)
    try:
        mesh = Mesh((1, 1, 1), device=dev)
        r, c, v = graph
        t0 = time.perf_counter()
        op = DistOperator(2 ** N_LOG2, r, c, v, mesh=mesh)
        torch.cuda.synchronize()
        p = op.panel
        log(f"dist 30a: {mesh.describe()} | panel ({p.n_rows}, {p.n_cols}) "
            f"of {p.n_entries} entries: {p.n_blocks} dense blocks "
            f"({p.image_bytes / 1e9:.2f} GB with the COO part), COO share "
            f"{p.coo_share:.4f} | packed and uploaded in "
            f"{time.perf_counter() - t0:.1f} s")
        mesh.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(op, NEV, method="krylov_schur", block_size=BLOCK_SIZE,
                    num_blocks=NUM_BLOCKS, tol=TOL, max_iters=MAX_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, widths = kernel_launches(), launches_by_width()
        resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
        err = sorted_rel_err(res.eigenvalues, res32.eigenvalues)
        log(f"dist 30a: solve wall {wall:.3f} s (phase 5's GraphOperator "
            f"solve {wall32:.3f} s) | converged {res.converged} | restarts "
            f"{res.n_restarts} | fused steps {op.n_fused_steps} | launches "
            f"{json.dumps(widths)} | peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"dist 30a: eigenvalues "
            f"{np.array2string(res.eigenvalues, precision=7)} | max rel err "
            f"to phase 5's {err:.3e} (limit 1e-5) | true residuals "
            f"{np.array2string(resid)} (limit {RESID_TOL:g}) | IOStats "
            f"{json.dumps(res.io_stats)}")
        log(f"dist 30a: collective bytes {json.dumps(dict(mesh.bytes))} | "
            f"analytic {json.dumps(dict(op.analytic_bytes))}")
        if not res.converged:
            fail("dist 30a: the one-rank solve did not converge")
        vec = res.eigenvectors
        if (tuple(vec.shape) != (op.n, NEV)
                or not bool(torch.isfinite(vec).all())):
            fail(f"dist 30a: eigenvectors {tuple(vec.shape)} not finite")
        if err > 1e-5:
            fail(f"dist 30a: eigenvalues {err:.3e} from phase 5's")
        if not np.all(resid <= RESID_TOL):
            fail(f"dist 30a: true residuals above {RESID_TOL}: {resid}")
        if op.n_fused_steps <= 0:
            fail("dist 30a: eigsh did not take the fused expansion")
        require_launched("dist 30a", launches,
                         ("spmm_blocksparse", "gram", "tsgemm"))
        for kind, want in op.analytic_bytes.items():
            if mesh.bytes[kind] != want:
                fail(f"dist 30a: {kind} moved {mesh.bytes[kind]} bytes, the "
                     f"design gives {want}")
        del res, vec
        breakdown(torch, op, "dist 30a")
        del op
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        one = e2e.run_ranks(Mesh((1, 1, 1), device=dev), cfg)
        log(f"dist 30b: one-rank run of 2^{DIST_LOG2} in "
            f"{time.perf_counter() - t0:.1f} s (build {one['build_s']:.1f} "
            f"s): solve wall {one['dist']['wall_s']:.3f} s, restarts "
            f"{one['dist']['restarts']}, eigenvalues "
            f"{np.array2string(np.asarray(one['dist']['eigenvalues']), precision=7)}")
    finally:
        comm.close_world()
    gc.collect()
    torch.cuda.empty_cache()
    if not one["dist"]["converged"]:
        fail("dist 30b: the one-rank run did not converge")

    cfg8 = dict(cfg, pod_restarts=DIST_POD_RESTARTS,
                w_reference=one["dist"]["eigenvalues"], compressed=True,
                kernel_check=KERNEL_TOL)
    t0 = time.perf_counter()
    outs = spawn(e2e.run_ranks, DIST_SHAPE, backend="gloo", device=dev,
                 args=(cfg8,), timeout=DIST_TIMEOUT)
    wall8 = time.perf_counter() - t0
    head = outs[0]
    d = head["dist"]
    err = sorted_rel_err(d["eigenvalues"], one["dist"]["eigenvalues"])
    devs = head["pod_compressed"]
    comp = head["compressed"]
    dev_z = float(np.abs(np.sort(np.abs(comp["eigenvalues"]))
                         - np.sort(np.abs(one["dist"]["eigenvalues"]))).max())
    log(f"dist 30b: {head['mesh']} | {len(outs)} ranks in {wall8:.1f} s "
        f"(spawn, graph, packing and every solve) | solve wall "
        f"{d['wall_s']:.3f} s against the one-rank run's "
        f"{one['dist']['wall_s']:.3f} s | converged {d['converged']} | "
        f"restarts {d['restarts']} | fused steps {head['fused_steps']}")
    log(f"dist 30b: eigenvalues "
        f"{np.array2string(np.asarray(d['eigenvalues']), precision=7)} | "
        f"max rel err to the one-rank run {err:.3e} (limit 1e-5) | true "
        f"residuals {np.array2string(np.asarray(d['true_residuals']))}")
    log(f"dist 30b: pod_compressed |λ| deviation per restart "
        f"{[f'{x:.3e}' for x in devs]} (last < {DIST_POD_TOL:g}, not above "
        f"twice the smallest after the first) | compressed stream "
        f"{dev_z:.3e} (limit {DIST_COMP_TOL:g}), {comp['restarts']} "
        f"restarts, {head['stream_bytes']} stream bytes on rank 0")
    for o in outs:
        log(f"dist 30b: {dist_bytes_line(o)}")
    for o in outs:
        kc = o["kernel_check"]
        log(f"dist 30b rank {o['rank']}: kernels at the rank's shapes, max "
            f"error / Σ|terms| against float64 {json.dumps(kc['errs'])}, "
            f"plain versions {json.dumps(kc['plain_errs'])} (gram, tsgemm "
            f"limit {KERNEL_TOL:g}) | SpMM's largest share of its float32 "
            f"bound {json.dumps(kc['of_bound'])} (limit 1)")
    same = all(np.array_equal(o["last_h"], head["last_h"])
               and np.array_equal(o["last_r"], head["last_r"]) for o in outs)
    log(f"dist 30b: the last step's h and r bit-equal on every rank: {same}")
    n_pad, b = head["panel"]["n_pad"], BLOCK_SIZE
    r_groups = DIST_SHAPE[0] * DIST_SHAPE[1]
    log(f"dist 30b: per SpMM the design gathers n_pad/M·b·4 = "
        f"{n_pad // DIST_SHAPE[2] * b * 4} and reduces n_pad/R·b·4 = "
        f"{n_pad // r_groups * b * 4} bytes a rank, plus (2·nb_v·b² + "
        f"2·b²)·4 all-reduced per step")
    if not d["converged"]:
        fail("dist 30b: the sharded solve did not converge")
    if err > 1e-5:
        fail(f"dist 30b: eigenvalues {err:.3e} from the one-rank run's")
    if not np.all(np.asarray(d["true_residuals"]) <= RESID_TOL):
        fail(f"dist 30b: true residuals above {RESID_TOL}")
    if not (len(devs) >= 2 and devs[-1] < DIST_POD_TOL
            and devs[-1] <= 2.0 * min(devs[1:]) + 1e-12):
        fail(f"dist 30b: pod_compressed deviation {devs}")
    if not dev_z < DIST_COMP_TOL:
        fail(f"dist 30b: compressed stream {dev_z:.3e} from the spectrum")
    if not same:
        fail("dist 30b: h and r differ between ranks")
    for o in outs:
        check_dist_bytes("dist 30b", o)
        require_launched(f"dist 30b rank {o['rank']}", o["launches"],
                         ("spmm_blocksparse", "gram", "tsgemm"))
        if o["bytes"].get("staged", 0) <= 0:
            fail(f"dist 30b rank {o['rank']}: gloo staged no bytes")
        if o["kernel_check"]["failures"]:
            fail(f"dist 30b rank {o['rank']}: "
                 + "; ".join(o["kernel_check"]["failures"]))
    log(f"dist: phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return widths


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
    del q, k, v
    torch.cuda.synchronize()
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flashattn.cu",
           "replaces": "src/repro/kernels/flashattn.py:28",
           "count": lambda: flashattn.LAUNCHES_BY_D.get(FLASH_SERVE[4], 0),
           "max_abs_err": abs_err,
           "ms": ms,
           "plain_ms": plain, "bound_ms": bms, "bound_by": by,
           "library_ms": lib_ms}

    # hubert-xlarge's head dim: bf16 on 128 columns (TMA zero-fills
    # 80-127), float32 on an instantiation of its own
    b, h, hkv, s, d = FLASH_HUBERT
    q, k, v = qkv(b, h, hkv, s, s, d)
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        for causal in (True, False):
            before = flashattn.LAUNCHES
            out = ops.flash_attention(qd, kd, vd, causal=causal)
            if flashattn.LAUNCHES != before + 1 or out.shape != qd.shape:
                fail(f"flash_attention at d = {d} {dtype} did not launch "
                     f"once or returned {tuple(out.shape)}")
            abs_d, rel = err(out, qd, kd, vd, causal)
            tol = FLASH_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
            log(f"kernel flash_attention: q {(b, h, s, d)} {dtype} "
                f"{'causal' if causal else 'not causal'} | rel err "
                f"{rel:.3e} (tol {tol:g}), max abs err {abs_d:.3e}")
            if not rel <= tol:
                fail(f"flash_attention at d = {d} disagrees with its plain "
                     f"version: {rel}")
            if dtype == torch.bfloat16 and not causal:
                abs_80 = abs_d
        del qd, kd, vd, out
    ms = timer.ms(lambda: ops.flash_attention(q, k, v, causal=False))
    plain = timer.ms(lambda: ops.flash_attention(q, k, v, causal=False,
                                                 impl="ref"), reps=3)
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4 * b * h * s * s * d
    bms, by = bound_ms(4 * b * h * s * d * 2, flops, BF16_FLOPS_PER_S)
    log(f"kernel flash_attention: hubert prefill q/k/v {(b, h, s, d)} bf16 "
        f"not causal | {ms:.3f} ms = {flops / ms / 1e9:.1f} TFLOP/s, plain "
        f"{plain:.3f} ms, library scaled_dot_product_attention "
        f"{lib_ms:.3f} ms, bound {bms:.4f} ms ({by}, bf16 tensor-core "
        f"peak)")
    del q, k, v
    torch.cuda.synchronize()
    return [row, {"name": "flash_attention_d80", "route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flashattn.cu",
                  "replaces": "src/repro/kernels/flashattn.py:28",
                  "count": lambda: flashattn.LAUNCHES_BY_D.get(
                      FLASH_HUBERT[4], 0),
                  "max_abs_err": abs_80, "ms": ms, "plain_ms": plain,
                  "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}]


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


def _device_ms_by_kind(prof, kinds, label=lambda name: None):
    """Device ms and launches per kind (`label(name)` where it names one,
    else the first kind whose name pattern matches a kernel name, else
    "other") and the largest "other" kernels."""
    cats = {k: 0.0 for k in kinds}
    cats["other"] = 0.0
    counts = dict.fromkeys(cats, 0)
    others = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        ms = float(evt.self_device_time_total) / 1e3
        key = label(evt.key) or next((k for k, pats in kinds.items()
                                      if any(p in evt.key for p in pats)),
                                     "other")
        cats[key] = cats.get(key, 0.0) + ms
        counts[key] = counts.get(key, 0) + evt.count
        if key == "other":
            others.append((ms, evt.count, evt.key[:60]))
    return cats, counts, sorted(others, reverse=True)[:5]


def serve_breakdown(torch, tf, params, cfg, prompt, steps: int = 4,
                    enc=None, label: str = "serve") -> dict:
    """Device time by kind over one profiled prefill and a few decode
    steps (an encoder: one profiled forward), beside their wall time (the
    idle share says how far the host holds the card back). Returns the
    idle share by phase."""
    from torch.profiler import ProfilerActivity, profile
    kinds = {"flash_attention": ("flash_f32_kernel", "flash_wgmma_kernel"),
             "gemm": ("gemm", "Gemm", "nvjet", "sm90_xmma", "cutlass"),
             "memcpy": ("Memcpy", "Memset")}
    cache_len = prompt.shape[1] + steps
    idle = {}
    for phase in (("prefill", "decode") if cfg.decoder else ("forward",)):
        if phase == "decode":
            _, cache = tf.prefill_with_cache(params, cfg, prompt,
                                             encoder=enc,
                                             cache_len=cache_len)
            tok = prompt[:, -1:]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                tf.prefill_with_cache(params, cfg, prompt, encoder=enc,
                                      cache_len=cache_len)
            elif phase == "forward":
                tf.logits_fn(params, cfg, prompt)
            else:
                for t in range(prompt.shape[1], cache_len):
                    tf.decode_step(params, cfg, cache, tok, t)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        cats, _, others = _device_ms_by_kind(prof, kinds)
        busy = sum(cats.values())
        n = steps if phase == "decode" else 1
        idle[phase] = 1 - busy / wall
        log(f"{label} breakdown ({phase}, profiled, {n} call(s)): wall "
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
        log(f"{label} breakdown ({phase}): largest host ops (self ms, "
            f"count, name): " + "; ".join(f"{ms:.2f}, {cnt}, {name}"
                                          for ms, cnt, name in host))
        if phase == "decode":
            del cache
    return idle


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ LM families

def uncounted_params(cfg) -> int:
    """The parameters `cfg.param_count()` leaves out (negative where it
    counts one the model does not have), layer by layer: norm scales and
    LayerNorm biases, QKV biases, the SSM's dt projection columns, conv
    channels of B and C, conv bias, a_log, dt_bias, d_skip and gated-norm
    scale, the RG-LRU's two gate matrices (it counts 3·rw for conv bias
    and Λ, which are 2·rw), and the audio frontend's input projection in
    place of a token table."""
    d, ln = cfg.d_model, 2 if cfg.norm == "layernorm" else 1
    extra = ln * d                                       # final norm
    if cfg.frontend == "audio":
        extra += d * d - cfg.vocab_size * d
    kinds = list(cfg.pattern) * cfg.n_super + \
        list(cfg.pattern[:cfg.n_remainder])
    ffw = d * cfg.d_ff * (3 if cfg.glu else 2)
    for kind in kinds:
        extra += ln * d                                  # norm1
        if kind in ("attn", "swa", "cross") and cfg.qkv_bias:
            extra += (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
        if kind == "ssm":
            d_in, n = cfg.ssm_expand * d, cfg.ssm_state
            h = d_in // cfg.ssm_head_dim
            extra += d * h + 2 * n * cfg.ssm_conv + (d_in + 2 * n) \
                + 3 * h + d_in
            extra -= ffw if cfg.d_ff else 0              # no FFN here
        elif cfg.d_ff > 0:
            extra += ln * d                              # norm2
        if kind == "rglru":
            rw = cfg.rglru_width or d
            extra += 2 * rw * rw - rw
    return extra


def flash_layers(cfg) -> int:
    """Layers of kind "attn" (the ones that run the flash kernel)."""
    kinds = list(cfg.pattern) * cfg.n_super + \
        list(cfg.pattern[:cfg.n_remainder])
    return sum(k == "attn" for k in kinds)


def _routing(log) -> list:
    """ROUTING_LOG entries as (experts, margin) on the host."""
    return [(e["experts"].cpu(), e["margin"].float().cpu()) for e in log]


def moe_split(torch, cfg, p, x) -> dict:
    """Device ms of one MoE layer's prefill by step (CUDA events, each
    step timed alone on the layer's own weights and input): routing (the
    router GEMM, softmax, top-k, queue positions, one-hot tensors),
    dispatch (x into the experts' slots), the expert GEMMs and combine."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    from repro_torch.models.modules import act_fn, apply_linear
    g, s, _ = x.shape
    e, k, cap = cfg.n_experts, cfg.top_k, moe.capacity(cfg, s)
    state = {}

    def routing():
        probs = torch.softmax(apply_linear(p["router"], x).float(), dim=-1)
        gv, gi = moe.top_k(probs, k)
        gv = gv / gv.sum(-1, keepdim=True)
        oh = F.one_hot(gi, e).int()
        pos = (torch.cumsum(oh.reshape(g, s * k, e), dim=1)
               * oh.reshape(g, s * k, e) - 1).reshape(g, s, k, e).amax(-1)
        keep = pos < cap
        oh_c = F.one_hot(torch.where(keep, pos, cap).long(),
                         cap + 1)[..., :cap].to(x.dtype)
        disp = torch.einsum("gske,gskc->gsec", oh.to(x.dtype), oh_c)
        gv_e = torch.einsum("gsk,gske->gse", gv * keep,
                            oh.float()).to(x.dtype)
        state["dispatch"], state["combine"] = disp, disp * gv_e[..., None]

    def dispatch():
        state["xin"] = torch.einsum("gsec,gsd->gecd", state["dispatch"], x)

    def experts():
        xin = state["xin"]
        h = torch.einsum("gecd,edf->gecf", xin, p["up"])
        if cfg.glu:
            h = act_fn(cfg)(torch.einsum("gecd,edf->gecf", xin,
                                         p["gate"])) * h
        else:
            h = act_fn(cfg)(h)
        state["out_e"] = torch.einsum("gecf,efd->gecd", h, p["down"])

    def combine():
        torch.einsum("gsec,gecd->gsd", state["combine"], state["out_e"])

    out = {}
    for name, fn in (("routing", routing), ("dispatch", dispatch),
                     ("experts", experts), ("combine", combine)):
        fn()                                             # warm up
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(3):
            fn()
        t1.record()
        t1.synchronize()
        out[name] = t0.elapsed_time(t1) / 3
    return out


def serve_family(torch, tf, params, cfg, prompt, steps: int, enc=None):
    """Prefill, then `steps` greedy decode steps, timed on the host clock
    around synchronized calls. Returns (prefill logits' last position's
    tokens, generated tokens (B, steps), decode logits (B, steps, V),
    prefill s, decode s, flash launches in prefill, in decode)."""
    from repro_torch.kernels import flashattn
    before = flashattn.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tf.prefill_with_cache(
        params, cfg, prompt, encoder=enc,
        cache_len=prompt.shape[1] + steps)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    in_prefill = flashattn.LAUNCHES - before
    if not bool(torch.isfinite(logits).all()):
        fail(f"{cfg.name}: prefill logits are not finite")
    tok = logits[:, -1:].argmax(-1).int()
    del logits
    generated, dec = [], []
    before = flashattn.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(prompt.shape[1], prompt.shape[1] + steps):
        generated.append(tok)
        out, cache = tf.decode_step(params, cfg, cache, tok, t)
        dec.append(out[:, 0])
        tok = out.argmax(-1).int()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    in_decode = flashattn.LAUNCHES - before
    del cache
    return (torch.cat(generated, dim=1), torch.stack(dec, dim=1),
            t_prefill, t_decode, in_prefill, in_decode)


def decode_vs_forward(torch, tf, params, cfg, prompt, generated, dec,
                      enc=None, routing=None) -> str:
    """The decode logits against one full forward over prompt and
    generated tokens at the generated positions; returns the log text,
    fails above SERVE_TOL. A model with plain attention (swa, cross) runs
    its forward on whole Q_CHUNKs: filler tokens after the generated ones
    are seen by no compared position (every layer is causal). With
    `routing` (the decode run's ROUTING_LOG, MoE), positions a layer
    routed to other experts in the forward are left out where either
    run's router margin there was below MOE_TIE_MARGIN, and fail the
    gate where neither was."""
    from repro_torch.models import attention as att
    from repro_torch.models import moe
    seq = torch.cat([prompt, generated], dim=1)
    p0, n = prompt.shape[1], seq.shape[1]
    if any(k in ("swa", "cross") for k in cfg.pattern) and n > att.Q_CHUNK:
        pad = -n % att.Q_CHUNK
        seq = torch.cat([seq, torch.zeros_like(seq[:, :1]).expand(
            -1, pad)], dim=1)
    if routing is not None:
        moe.ROUTING_LOG = []
    full = tf.logits_fn(params, cfg, seq, encoder=enc)[:, p0:n]
    keep = torch.ones(dec.shape[:2], dtype=torch.bool)
    note = ""
    if routing is not None:
        fwd = _routing(moe.ROUTING_LOG)
        moe.ROUTING_LOG = None
        layers = len(fwd)
        flips = 0
        for layer, (f_exp, f_mar) in enumerate(fwd):
            for t in range(dec.shape[1]):
                d_exp, d_mar = routing[t * layers + layer]
                same = (f_exp[:, p0 + t].sort(-1).values
                        == d_exp[:, 0].sort(-1).values).all(-1)
                for b in torch.nonzero(~same).flatten().tolist():
                    flips += 1
                    margin = min(float(f_mar[b, p0 + t]),
                                 float(d_mar[b, 0]))
                    if margin >= MOE_TIE_MARGIN:
                        fail(f"{cfg.name}: decode and forward route token "
                             f"{p0 + t} of request {b} in layer {layer} "
                             f"to other experts at a router margin of "
                             f"{margin:.4f} (≥ {MOE_TIE_MARGIN})")
                    keep[b, t] = False
        note = (f" | routings differing between the runs: {flips} (each "
                f"at a router margin < {MOE_TIE_MARGIN}); positions "
                f"compared {int(keep.sum())} of {keep.numel()}")
        if not bool(keep.any()):
            fail(f"{cfg.name}: no position left to compare")
    if not bool(torch.isfinite(full).all()):
        fail(f"{cfg.name}: forward logits are not finite")
    rel = (dec - full).norm(dim=-1) / full.norm(dim=-1)
    worst = float(rel[keep.to(rel.device)].max())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    if not worst <= SERVE_TOL:
        fail(f"{cfg.name}: decode logits disagree with the full forward: "
             f"{worst}")
    return (f"decode vs full forward over {n} tokens ({seq.shape[1] - n} "
            f"filler): max ‖Δ‖/‖logits‖ {worst:.4f} (limit {SERVE_TOL:g}), "
            f"greedy tokens agree at {agree:.3f}{note}")


def lm_families_phase(torch, dev, card_line: str) -> dict:
    """Phase 31: the other nine architectures at full width (LM_FAMILIES),
    one at a time. Returns per model its flash launches in the counted
    prefill or forward."""
    from repro_torch import configs
    from repro_torch.kernels import flashattn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.modules import dtype_of
    t_phase = time.perf_counter()
    out = {}
    for name, layers, batch, plen, steps in LM_FAMILIES:
        t_model = time.perf_counter()
        cfg = configs.get(name)
        cut = ""
        if layers is not None and layers != cfg.n_layers:
            cut = f", cut from {cfg.n_layers} layers"
            cfg = dataclasses.replace(cfg, n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_model(LM_SEED, cfg, device=dev)
        torch.cuda.synchronize()
        t_draw = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        want = cfg.param_count() + uncounted_params(cfg)
        w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        log(f"lm {name}: {cfg.n_layers} layers{cut} ({cfg.pattern}), "
            f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} "
            f"x {cfg.hd}, {n_params} parameters = param_count "
            f"{cfg.param_count()} + {uncounted_params(cfg)} it leaves out, "
            f"{w_bytes / 1e9:.2f} GB, drawn on the card in {t_draw:.2f} s")
        if n_params != want:
            fail(f"{name} has {n_params} parameters, not {want}")
        gen = torch.Generator(device=dev).manual_seed(LM_SEED)
        enc = None
        if cfg.frontend == "patch":
            enc = torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                              generator=gen, device=dev).to(dtype_of(cfg))
        n_flash = flash_layers(cfg)
        if not cfg.decoder:
            frames = torch.randn((batch, plen, cfg.d_model), generator=gen,
                                 device=dev).to(dtype_of(cfg))
            tf.logits_fn(params, cfg, frames[:, :128])       # warm up
            zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = tf.logits_fn(params, cfg, frames)
            torch.cuda.synchronize()
            t_fwd = time.perf_counter() - t0
            flash = flashattn.LAUNCHES_BY_D.get(cfg.hd, 0)
            peak = torch.cuda.max_memory_allocated()
            log(f"lm {name}: forward {batch} x {plen} frames in {t_fwd:.3f} "
                f"s = {batch * plen / t_fwd:.0f} frames/s | logits "
                f"{tuple(logits.shape)} | flash launches {flash} (want "
                f"{n_flash}) | peak device memory {peak / 1e9:.2f} GB")
            if not bool(torch.isfinite(logits).all()) or \
                    tuple(logits.shape) != (batch, plen, cfg.vocab_size):
                fail(f"{name}: forward logits not finite or of shape "
                     f"{tuple(logits.shape)}")
            if flash != n_flash or flashattn.LAUNCHES != n_flash:
                fail(f"{name}: flash launched {flashattn.LAUNCHES} times in "
                     f"the forward ({flash} at d = {cfg.hd}), not "
                     f"{n_flash}")
            del logits
            serve_breakdown(torch, tf, params, cfg, frames, label=f"lm {name}")
            out[name] = {"flash": flash}
            del params, frames
            continue
        prompt = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
            0, cfg.vocab_size, (batch, plen)).astype(np.int32)).to(dev)
        _, wc = tf.prefill_with_cache(params, cfg, prompt[:, :128],
                                      encoder=enc, cache_len=130)
        tf.decode_step(params, cfg, wc, prompt[:, :1], 128)  # warm up
        del wc
        if cfg.n_experts:
            moe.ROUTING_LOG = []
        zero_counters()
        generated, dec, t_pre, t_dec, f_pre, f_dec = serve_family(
            torch, tf, params, cfg, prompt, steps, enc)
        peak = torch.cuda.max_memory_allocated()
        drops = ""
        if cfg.n_experts:
            served = moe.ROUTING_LOG
            moe.ROUTING_LOG = None
            dropped = sum(int(e["dropped"]) for e in served)
            routed = sum(e["experts"].numel() for e in served)
            drops = (f" | routings dropped at capacity_factor "
                     f"{cfg.capacity_factor:g}: {dropped} of {routed} "
                     f"(prefill and decode)")
        log(f"lm {name}: prefill {batch} x {plen} tokens in {t_pre:.3f} s "
            f"= {batch * plen / t_pre:.0f} tokens/s | decode {steps} steps "
            f"of {batch}: {t_dec / steps * 1e3:.2f} ms/step | flash "
            f"launches prefill {f_pre} (want {n_flash}), decode {f_dec} | "
            f"peak device memory {peak / 1e9:.2f} GB{drops} | {card_line}")
        if f_pre != n_flash or f_dec != 0:
            fail(f"{name}: flash launched {f_pre} times in the prefill and "
                 f"{f_dec} in decode, not {n_flash} and 0")
        if not bool(torch.isfinite(dec).all()):
            fail(f"{name}: decode logits are not finite")
        if cfg.n_experts:
            x = torch.randn((batch, plen, cfg.d_model), generator=gen,
                            device=dev).to(dtype_of(cfg))
            split = moe_split(torch, cfg,
                              tf._layer(params["stack"]["l0"], 0)["ffn"], x)
            split = {k: round(v, 3) for k, v in split.items()}
            log(f"lm {name}: one MoE layer's prefill ({batch} x {plen} "
                f"tokens, capacity {moe.capacity(cfg, plen)} per expert), "
                f"device ms by step {json.dumps(split)}")
            del x
            # the gate: a short run with nothing dropped
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            prompt = prompt[:, :MOE_GATE_PROMPT]
            moe.ROUTING_LOG = []
            generated, dec, *_ = serve_family(
                torch, tf, params, cfg, prompt, MOE_GATE_DECODE, enc)
            routing = [r for r in _routing(moe.ROUTING_LOG)
                       if r[0].shape[1] == 1]         # decode's, in order
            moe.ROUTING_LOG = None
            text = decode_vs_forward(torch, tf, params, cfg, prompt,
                                     generated, dec, enc, routing)
            text = (f"capacity_factor {cfg.capacity_factor:g}, prompt "
                    f"{MOE_GATE_PROMPT}, {MOE_GATE_DECODE} steps: " + text)
        else:
            text = decode_vs_forward(torch, tf, params, cfg, prompt,
                                     generated, dec, enc)
        log(f"lm {name}: {text}")
        serve_breakdown(torch, tf, params, cfg, prompt, enc=enc,
                        label=f"lm {name}")
        log(f"lm {name}: {time.perf_counter() - t_model:.1f} s for the "
            f"model")
        out[name] = {"flash": f_pre}
        del params, prompt, generated, dec, enc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm-families: phase 31 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------------------ training

def flash_bwd_phase(torch, timer, dev) -> list:
    """32a: the flash backward against its plain version and the float64
    gradient at FLASH_BWD_SHAPES, bit-identical run to run, the forward's
    LSE against the plain one and its O unchanged by storing LSE; the
    first and last shapes timed (L2 flushed) beside the plain backward,
    SDPA's backward and the bound, and the last (float32) shape's forward
    beside its plain version, SDPA's forward and its bound. Returns their
    kernel rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import flashattn
    from repro_torch.kernels.flashattn_ref import (attention_ref_lse,
                                                   flash_attention_bwd_ref)
    gen = torch.Generator(device=dev).manual_seed(32)

    def rel(got, want):
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max().clamp_min(1e-30))

    rows = []
    for label, (b, h, hkv, s, d), dt, causal in FLASH_BWD_SHAPES:
        dtype = getattr(torch, dt)
        # strided (B, S, H, d) views, as the model passes them
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev)
                   .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
        do = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
        o, lse = flashattn.flash_attention_lse(q, k, v, causal=causal)
        if not torch.equal(o, flashattn.flash_attention(q, k, v,
                                                        causal=causal)):
            fail(f"flash forward with LSE changed O at {label}")
        lse_err = float((lse - attention_ref_lse(q, k, v, causal=causal)[1])
                        .abs().max())
        before = flashattn.BWD_LAUNCHES
        got = flashattn.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal)
        again = flashattn.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=causal)
        if flashattn.BWD_LAUNCHES != before + 2:
            fail(f"flash backward did not launch once per call at {label}")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        plain = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(),
                                        causal=causal)
        e_plain = [rel(x, y) for x, y in zip(got, plain)]
        abs_err = max(float((x.double() - y.double()).abs().max())
                      for x, y in zip(got, plain))
        del plain
        q6, k6, v6 = q.double(), k.double(), v.double()
        o6, lse6 = attention_ref_lse(q6, k6, v6, causal=causal)
        exact = flash_attention_bwd_ref(q6, k6, v6, o6, lse6, do.double(),
                                        causal=causal)
        e_exact = [rel(x, y) for x, y in zip(got, exact)]
        del q6, k6, v6, o6, lse6, exact
        torch.cuda.empty_cache()
        tol_plain, tol_exact = FLASH_BWD_TOL[dt]
        log(f"kernel flash_attention_bwd: {label} q {(b, h, s, d)} k/v "
            f"{(b, hkv, s, d)} {dt} {'causal' if causal else 'not causal'}"
            f" | rel err (dq, dk, dv) vs plain "
            f"{', '.join(f'{e:.3e}' for e in e_plain)} (tol {tol_plain:g})"
            f", vs float64 {', '.join(f'{e:.3e}' for e in e_exact)} (tol "
            f"{tol_exact:g}), max abs err vs plain {abs_err:.3e} | LSE max "
            f"abs err {lse_err:.3e} (tol {FLASH_LSE_TOL:g}), O unchanged "
            f"with LSE on | bit-identical run to run: {same}")
        if not (same and max(e_plain) <= tol_plain
                and max(e_exact) <= tol_exact and lse_err <= FLASH_LSE_TOL):
            fail(f"flash backward at {label} failed its gates")
        if label in (FLASH_BWD_SHAPES[0][0], FLASH_BWD_SHAPES[-1][0]):
            rows.append(_flash_bwd_row(torch, F, timer, flashattn,
                                       flash_attention_bwd_ref, q, k, v, o,
                                       lse, do, causal, dt, abs_err, label))
        if label == FLASH_BWD_SHAPES[-1][0]:
            rows.append(_flash_f32_fwd_row(torch, F, timer, flashattn, q, k,
                                           v, causal, label))
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    return rows


def _flash_bwd_row(torch, F, timer, flashattn, bwd_ref, q, k, v, o, lse, do,
                   causal, dt, abs_err, label) -> dict:
    """Times of the backward at one shape (L2 flushed) and its row."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    ms = timer.ms(lambda: flashattn.flash_attention_bwd(q, k, v, o, lse, do,
                                                        causal=causal))
    plain = timer.ms(lambda: bwd_ref(q, k, v, o, lse, do, causal=causal),
                     reps=3)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                         enable_gqa=True)
    lib_ms = timer.ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                  retain_graph=True))
    del out, qs, ks, vs
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 10 * d * pairs                   # 5 products, 2 flop per MAC
    size = q.element_size()
    nbytes = (4 * b * h * s * d + 4 * b * hkv * s * d) * size + 4 * b * h * s
    peak = BF16_FLOPS_PER_S if dt == "bfloat16" else F32_FLOPS_PER_S
    bms, by = bound_ms(nbytes, flops, peak)
    floor_ms = bound_ms(nbytes, 14 * d * pairs, peak)[0]   # 7 products
    per_call, split = kernel_split(
        torch, lambda: flashattn.flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal=causal))
    log(f"kernel flash_attention_bwd: {label} | device kernels per call "
        f"{per_call:g}; device ms per call by kernel {json.dumps(split)}")
    log(f"kernel flash_attention_bwd: {label} | {ms:.3f} ms = "
        f"{flops / ms / 1e9:.1f} TFLOP/s of the 5-product work "
        f"({1.4 * flops / ms / 1e9:.1f} of the 7 it does), plain "
        f"{plain:.3f} ms, library scaled_dot_product_attention backward "
        f"{lib_ms:.3f} ms, bound {bms:.4f} ms ({by}, {dt} peak), the "
        f"design's 7-product floor {floor_ms:.4f} ms | {flops:.3e} flop, "
        f"{nbytes} bytes")
    name = ("flash_attention_bwd" if dt == "bfloat16"
            else "flash_attention_bwd_f32")
    key = (d, dt)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flashattn_bwd.cu",
            "replaces": "src/repro/models/attention.py:48 (JAX's autodiff "
                        "of _attend; no Pallas backward)",
            "count": lambda: TRAIN_BWD_LAUNCHES.get(key, 0),
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "floor_ms": floor_ms}


def _flash_f32_fwd_row(torch, F, timer, flashattn, q, k, v, causal,
                       label) -> dict:
    """The float32 forward at one shape (L2 flushed) against its plain
    version (FLASH_F32_TOL), bit-identical run to run, timed beside the
    plain version, SDPA's forward and the bound: 2 products, 4 d flop a
    kept pair, at the float32 peak."""
    from repro_torch.kernels.flashattn_ref import attention_ref_lse
    b, h, s, d = q.shape
    hkv = k.shape[1]
    out = flashattn.flash_attention(q, k, v, causal=causal)
    same = torch.equal(out, flashattn.flash_attention(q, k, v,
                                                      causal=causal))
    want = attention_ref_lse(q, k, v, causal=causal)[0]
    abs_err = float((out - want).abs().max())
    rel = abs_err / float(want.abs().max())
    del out, want
    ms = timer.ms(lambda: flashattn.flash_attention(q, k, v, causal=causal))
    plain = timer.ms(lambda: attention_ref_lse(q, k, v, causal=causal),
                     reps=3)
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * 4
    bms, by = bound_ms(nbytes, 4 * d * pairs, F32_FLOPS_PER_S)
    per_call, split = kernel_split(torch, lambda: flashattn.flash_attention(
        q, k, v, causal=causal))
    log(f"kernel flash_attention: {label} forward q {(b, h, s, d)} k/v "
        f"{(b, hkv, s, d)} float32 {'causal' if causal else 'not causal'} "
        f"| rel err {rel:.3e} (tol {FLASH_F32_TOL:g}), max abs err "
        f"{abs_err:.3e}, bit-identical run to run: {same} | {ms:.4f} ms = "
        f"{4 * d * pairs / ms / 1e9:.1f} TFLOP/s, plain {plain:.3f} ms, "
        f"library scaled_dot_product_attention {lib_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}, float32 peak) | device kernels per call "
        f"{per_call:g}; device ms per call by kernel {json.dumps(split)}")
    if not (same and rel <= FLASH_F32_TOL):
        fail(f"the float32 flash forward at {label} failed its gates")
    key = (d, "float32")
    return {"name": "flash_attention_f32", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flashattn.cu",
            "replaces": "src/repro/kernels/flashattn.py:28",
            "count": lambda: TRAIN_FWD_LAUNCHES.get(key, 0),
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def kernel_split(torch, fn, calls: int = 4, windows: int = 3
                 ) -> tuple[float, dict]:
    """Device kernels per call of fn and its device ms per call by
    kernel, over a profiled window of `calls` calls (a log). CPU and CUDA
    activities, as train_breakdown's: in this script's runs a CUDA-only
    window opened in phase 32 recorded no kernel at all. Fills open and
    close the window (see kernels_per_call), and a window with none of
    fn's kernels is profiled again, up to `windows` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    word = torch.empty(1, device="cuda")
    for window in range(1, windows + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            word.fill_(1.0)
            for _ in range(calls):
                fn()
            word.fill_(1.0)
            torch.cuda.synchronize()
        split, n = {}, 0
        for e in prof.key_averages():
            if ("CUDA" not in str(getattr(e, "device_type", ""))
                    or e.key.startswith(("Memcpy", "Memset"))
                    or "FillFunctor" in e.key):
                continue
            name = re.sub(r"^void |\(.*$", "",
                          e.key.replace("(anonymous namespace)::", ""))
            split[name] = round(e.self_device_time_total / 1e3 / calls, 4)
            n += e.count
        if n:
            break
        log(f"kernel_split: profile window {window} of {windows} recorded "
            f"none of the {calls} calls' kernels")
    return n / calls, split


# backward launches of phase 32's runs by (head dim, dtype): 32c's trainer
# (bf16) and 32b's card gradients (float32); and 32b's forward launches
TRAIN_BWD_LAUNCHES: dict = {}
TRAIN_FWD_LAUNCHES: dict = {}
# 32c's measured peak device memory and model flops a step (phase 35b)
TRAIN_32C: dict = {}


def _rel_fro(torch, got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm()
                 / want.norm().clamp_min(1e-12))


def _grads(torch, tf, adamw, params, cfg, batch, device):
    alias = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = tf.loss_fn(alias, cfg, batch, device=device)
    return loss.detach(), torch.autograd.grad(loss, adamw.tree_leaves(alias))


def train_grad_phase(torch, dev) -> None:
    """32b: qwen2-1.5b cut to GRAD_LAYERS layers at full widths in float32
    (remat on), one sequence of GRAD_TOKENS: every leaf's gradient on the
    card, through the kernels, against the host CPU's through the plain
    versions; the card's flash launches counted."""
    from repro_torch import configs
    from repro_torch.kernels import flashattn
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=GRAD_LAYERS,
                              param_dtype="float32")
    g = np.random.default_rng(TRAIN_SEED)
    batch = {k: g.integers(0, cfg.vocab_size, (1, GRAD_TOKENS)).astype(
        np.int32) for k in ("tokens", "targets")}
    params = tf.init_model(TRAIN_SEED, cfg, device="cpu")
    l_cpu, g_cpu = _grads(torch, tf, adamw, params, cfg, batch, "cpu")
    t_cpu = time.perf_counter() - t0
    on_card = adamw.tree_map(lambda t: t.to(dev), params)
    zero_counters()
    l_dev, g_dev = _grads(torch, tf, adamw, on_card, cfg, batch, dev)
    torch.cuda.synchronize()
    fwd, bwd = flashattn.LAUNCHES, flashattn.BWD_LAUNCHES
    TRAIN_BWD_LAUNCHES[(cfg.hd, "float32")] = bwd
    TRAIN_FWD_LAUNCHES[(cfg.hd, "float32")] = fwd
    errs = [_rel_fro(torch, a.cpu(), b) for a, b in zip(g_dev, g_cpu)]
    worst = max(errs)
    l_err = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    log(f"train grads: {TRAIN_ARCH} cut to {GRAD_LAYERS} layers at full "
        f"widths, float32, remat on, 1 x {GRAD_TOKENS} tokens | loss card "
        f"{float(l_dev):.6f} cpu {float(l_cpu):.6f} (rel {l_err:.2e}) | "
        f"{len(errs)} leaves, worst relative Frobenius error "
        f"{worst:.3e} (tol {GRAD_TOL:g}), median "
        f"{statistics.median(errs):.3e} | flash launches forward {fwd} "
        f"(want {2 * GRAD_LAYERS}: remat recomputes), backward {bwd} (want "
        f"{GRAD_LAYERS}) | CPU side {t_cpu:.1f} s")
    if not (worst <= GRAD_TOL and l_err <= GRAD_TOL
            and (fwd, bwd) == (2 * GRAD_LAYERS, GRAD_LAYERS)):
        fail("card gradients disagree with the CPU's, or the flash kernels "
             "were not launched as counted")
    del on_card, g_dev, g_cpu, params
    gc.collect()
    torch.cuda.empty_cache()


def ckpt_root(nbytes: int) -> tuple[str, str]:
    """A fresh directory for checkpoints of `nbytes` (twice that free):
    under /dev/shm (memory) when it has room, else under the temporary
    directory. Returns (path, which)."""
    if os.path.isdir("/dev/shm") and \
            shutil.disk_usage("/dev/shm").free > 2 * nbytes:
        return tempfile.mkdtemp(prefix="repro_train_", dir="/dev/shm"), \
            "/dev/shm"
    return tempfile.mkdtemp(prefix="repro_train_"), tempfile.gettempdir()


def train_model_flops(cfg, tokens: int, seq: int) -> float:
    """Model flops of one training step (forward + backward, 3 x the
    forward; remat's recompute not counted): 2 flop per weight of every
    matrix product per token (layers and the vocab head), and the
    attention products, 2 x 2 B H S^2 d / 2 per causal layer forward."""
    d, hd = cfg.d_model, cfg.hd
    layer = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2 + \
        d * cfg.d_ff * (3 if cfg.glu else 2)
    matmul = 2 * tokens * (cfg.n_layers * layer + d * cfg.vocab_size)
    attn = cfg.n_layers * 2 * tokens * seq * cfg.n_heads * hd
    return 3.0 * (matmul + attn)


def train_breakdown(torch, step_fn, params, opt, batch,
                    step_ms: float) -> tuple:
    """Device time by kind over one profiled training step (the optimizer
    marked by a profiler range around `adamw.global_norm_clip` and
    `adamw.update`), beside its wall time and the median unprofiled step
    `step_ms` (the profiler slows the host). Each flash forward call is
    marked by a range of its own (serving or with LSE), whose device-side
    copy spans the call's kernels and carries the CPU range's id: the log
    counts the calls, those copies and the flash forward kernels, and
    names (by index in the step) any call with no device-side copy (its
    kernel's record was lost with it); the backward's kernels per call
    come from the wrapper's count, its device time by kernel from the
    profile. Returns (params, opt)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import flashattn
    from repro_torch.optim import adamw
    saved = (adamw.update, adamw.global_norm_clip, flashattn.flash_attention,
             flashattn.flash_attention_lse)

    def marked(fn, name):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    adamw.update, adamw.global_norm_clip = (marked(f, "optimizer")
                                            for f in saved[:2])
    flashattn.flash_attention = marked(saved[2], "flash_fwd_call:serve")
    flashattn.flash_attention_lse = marked(saved[3], "flash_fwd_call:lse")
    kinds = {"flash_bwd": ("flash_bwd_",),
             "flash_fwd": ("flash_f32_kernel", "flash_wgmma_kernel"),
             "gemm": ("gemm", "Gemm", "nvjet", "sm90_xmma", "cutlass"),
             "memcpy": ("Memcpy", "Memset")}
    bwd0 = flashattn.BWD_LAUNCHES
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        (adamw.update, adamw.global_norm_clip, flashattn.flash_attention,
         flashattn.flash_attention_lse) = saved
    bwd_calls = flashattn.BWD_LAUNCHES - bwd0
    cats, counts, others = _device_ms_by_kind(
        prof, kinds, label=lambda name: "range" if name == "optimizer"
        or name.startswith("flash_fwd_call") else None)
    cats.pop("range", None)
    opt_ms = sum(e.device_time_total for e in prof.events()
                 if e.name == "optimizer"
                 and "CPU" in str(e.device_type)) / 1e3
    cats["optimizer"] = opt_ms
    cats["elementwise"] = cats.pop("other") - opt_ms
    busy = sum(cats.values())
    on_card = [e for e in prof.events() if "CUDA" in str(e.device_type)]
    fwd_kernels = sum(1 for e in on_card
                      if any(p in e.name for p in kinds["flash_fwd"]))
    copies = {e.id for e in on_card if e.name.startswith("flash_fwd_call")}
    cpu_calls = sorted((e for e in prof.events()
                        if e.name.startswith("flash_fwd_call")
                        and "CPU" in str(e.device_type)),
                       key=lambda e: e.time_range.start)
    lost = [(i, e.name.split(":")[1]) for i, e in enumerate(cpu_calls)
            if e.id not in copies]
    bwd_split = {e.key.split("flash_bwd_")[1].split("<")[0].split("(")[0]:
                 (round(e.self_device_time_total / 1e3, 2), e.count)
                 for e in prof.key_averages()
                 if "flash_bwd_" in e.key and "CUDA" in str(e.device_type)}
    log(f"train breakdown (one profiled step): wall {wall:.1f} ms | device "
        f"busy {busy:.1f} ms, idle share {1 - busy / wall:.3f} (of the "
        f"median unprofiled step {step_ms:.1f} ms: {1 - busy / step_ms:.3f})"
        f" | device ms by kind "
        f"{json.dumps({k: round(v, 2) for k, v in cats.items()})} | "
        f"launches flash_fwd {counts['flash_fwd']}, flash_bwd "
        f"{counts['flash_bwd']} over {bwd_calls} backward calls "
        f"({counts['flash_bwd'] / max(bwd_calls, 1):g} kernels a call; "
        f"ms and launches by kernel {json.dumps(bwd_split)}) | "
        f"flash forward calls {len(cpu_calls)}, their device-side ranges "
        f"{len(copies)}, flash forward kernels {fwd_kernels}; calls (index "
        f"in the step, kind) with no device-side range {lost} | largest "
        f"kernels outside gemm and flash (ms, count, name): "
        + "; ".join(f"{ms:.2f}, {cnt}, {name}" for ms, cnt, name in others))
    return params, opt


def train_phase(torch, dev, card_line: str) -> None:
    """32c: qwen2-1.5b at its published size trained TRAIN_STEPS steps
    through `train.trainer.train` (bf16 weights, float32 moments, remat,
    the synthetic pipeline at train_4k's length, TRAIN_BATCH in TRAIN_MB
    microbatches), the launch counters zeroed just before and read after
    every step; then one more step profiled by kind."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import flashattn
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    from repro_torch.train import TrainConfig, train
    t_phase = time.perf_counter()
    cfg = configs.get(TRAIN_ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=TRAIN_SEED)
    batch0 = TokenPipeline(dcfg).batch(0)
    rows = TRAIN_BATCH // TRAIN_MB
    params = tf.init_model(TRAIN_SEED, cfg, device=dev)
    with torch.no_grad():       # the serving forward, no LSE, no remat
        loss0 = sum(float(tf.loss_fn(params, cfg, {
            k: x[i * rows:(i + 1) * rows] for k, x in batch0.items()},
            device=dev)) for i in range(TRAIN_MB)) / TRAIN_MB
    n_params = sum(t.numel() for t in _leaves(params))
    state_bytes = n_params * (2 + 8) + 4
    del params
    torch.cuda.empty_cache()
    root, where = ckpt_root(state_bytes)
    log(f"train: {TRAIN_ARCH} {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params} parameters "
        f"{cfg.param_dtype}, remat {cfg.remat} | {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step in {TRAIN_MB} microbatches | "
        f"checkpoints ({state_bytes} bytes of state) under {where}")
    seen = []

    def record(line: str) -> None:
        if line.startswith("step"):
            seen.append((flashattn.LAUNCHES, flashattn.BWD_LAUNCHES))
        log(f"train: {line}")

    tcfg = TrainConfig(steps=TRAIN_STEPS, ckpt_every=10 ** 9,
                       ckpt_dir=os.path.join(root, "ck"), keep_ckpts=1,
                       log_every=1, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                       num_microbatches=TRAIN_MB, seed=TRAIN_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    try:
        summary = train(cfg, tcfg, dcfg, log=record, device=dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    TRAIN_BWD_LAUNCHES[(cfg.hd, "bfloat16")] = flashattn.BWD_LAUNCHES
    per_step = [(f - pf, b - pb) for (f, b), (pf, pb)
                in zip(seen, [(0, 0)] + seen[:-1])]
    want = (cfg.n_layers * TRAIN_MB * 2, cfg.n_layers * TRAIN_MB)
    losses, norms, secs = (summary[k] for k in ("losses", "grad_norms",
                                                "step_s"))
    med = statistics.median(secs[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_model_flops(cfg, tokens, TRAIN_SEQ)
    TRAIN_32C.update(peak=peak, model_flops=flops)
    l0_err = abs(losses[0] - loss0) / abs(loss0)
    log(f"train: losses {losses} | grad norms {norms} | step seconds "
        f"{[round(x, 3) for x in secs]} (the first includes warm-up) | "
        f"median step {med:.3f} s = {tokens / med:.0f} tokens/s | peak "
        f"device memory {peak / 1e9:.2f} GB | model flops per step "
        f"{flops:.4e} = {flops / med / 1e12:.1f} TFLOP/s, "
        f"{flops / med / BF16_FLOPS_PER_S:.3f} of the bf16 peak | flash "
        f"launches per step (forward, backward) {per_step} (want {want}) | "
        f"step 0 loss {losses[0]:.6f} vs loss_fn without grad "
        f"{loss0:.6f} (rel {l0_err:.2e}, tol {TRAIN_LOSS_TOL:g}) | "
        f"{card_line}")
    if not (len(losses) == TRAIN_STEPS and all(map(math.isfinite,
                                                   losses + norms))):
        fail("training produced a non-finite loss or grad norm")
    if not l0_err <= TRAIN_LOSS_TOL:
        fail(f"step 0's loss {losses[0]} disagrees with loss_fn's {loss0}")
    if any(c != want for c in per_step) or len(per_step) != TRAIN_STEPS:
        fail(f"flash launches per step {per_step}, not {want}")
    params, opt = steps.init_all(TRAIN_SEED, cfg, device=dev)
    step_fn = steps.build_train_step(
        cfg, num_microbatches=TRAIN_MB, peak_lr=TRAIN_LR,
        warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS, device=dev)
    batch = TokenPipeline(dcfg).batch(1)
    params, opt, _ = step_fn(params, opt, batch0)      # warm
    train_breakdown(torch, step_fn, params, opt, batch, med * 1e3)
    del params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: phase 32c took {time.perf_counter() - t_phase:.1f} s")


def train_resume_phase(torch, dev) -> None:
    """32d: at RESUME_LAYERS layers (full widths, bf16, remat), under
    deterministic algorithms: [train 4] against [train 2, restore, train
    2], every leaf of (params, AdamWState) bit for bit."""
    from repro_torch import configs
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data import DataConfig
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, train
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              n_layers=RESUME_LAYERS)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=TRAIN_SEED)
    root, where = ckpt_root(4 * 10 * cfg.vocab_size * cfg.d_model)
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    quiet = lambda line: None
    torch.use_deterministic_algorithms(True)
    try:
        for d, n in ((a, 4), (b, 2), (b, 4)):
            train(cfg, TrainConfig(steps=n, ckpt_every=10 ** 9, ckpt_dir=d,
                                   log_every=10 ** 9,
                                   num_microbatches=TRAIN_MB), dcfg,
                  log=quiet, device=dev)
        like = steps.init_all(0, cfg, device="cpu")
        ta, _ = ckpt.restore(a, ckpt.latest_step(a), like)
        tb, _ = ckpt.restore(b, ckpt.latest_step(b), like)
        la, lb = adamw.tree_leaves(ta), adamw.tree_leaves(tb)
        same = len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))
        steps_ab = (ckpt.latest_step(a), ckpt.latest_step(b))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    log(f"train resume: {TRAIN_ARCH} cut to {RESUME_LAYERS} layers, "
        f"deterministic algorithms, checkpoints under {where} | [train 4] "
        f"vs [train 2, restore, train 2] at steps {steps_ab}: {len(la)} "
        f"leaves bit-identical: {same} | {time.perf_counter() - t0:.1f} s")
    if not (same and steps_ab == (4, 4)):
        fail("a resumed training run is not bit-identical to an "
             "uninterrupted one")


def training_phase(torch, dev, timer, card_line: str) -> list:
    """Phase 32 (a-d). Returns the backward's kernel rows."""
    t0 = time.perf_counter()
    rows = flash_bwd_phase(torch, timer, dev)
    train_grad_phase(torch, dev)
    train_phase(torch, dev, card_line)
    train_resume_phase(torch, dev)
    log(f"train: phase 32 took {time.perf_counter() - t0:.1f} s")
    return rows


def curvature_kernel_check(torch, v, hv, by_width: dict):
    """gram and tsgemm on phase 33's own blocks, at every width the solve
    launched each at, against float64 products summed in row chunks (the
    rows are ~3e8): A's columns from the Ritz vectors V, B's (gram) and
    C0's (tsgemm) from their HVP block HV = H·V, each repeated to the
    width; tsgemm computes the project-out C0 − A·(AᵀC0). Each within
    KERNEL_TOL of Σ|terms| per element, as the serve phase holds them;
    the plain versions' errors are returned beside. After the counters
    were read: these launches do not count."""
    from repro_torch.kernels import ops
    nev = v.shape[1]
    rows = 1 << 24

    def cols(t, w):
        return t[:, [i % nev for i in range(w)]]

    def chunks(*ts):
        for r0 in range(0, ts[0].shape[0], rows):
            yield (t[r0:r0 + rows].double() for t in ts)

    errs, plain_errs = {}, {}
    for key in by_width["gram"]:
        m, b = map(int, key.split("x"))
        a, bb = cols(v, m), cols(hv, b)
        exact = torch.zeros((m, b), dtype=torch.float64, device=v.device)
        terms = torch.zeros_like(exact)
        for ac, bc in chunks(a, bb):
            exact += ac.T @ bc
            terms += ac.abs().T @ bc.abs()
        errs[f"gram {key}"] = rel_err(ops.gram(a, bb), exact, terms)
        plain_errs[f"gram {key}"] = rel_err(ops.gram(a, bb, impl="ref"),
                                            exact, terms)
        del a, bb
    for key in by_width["tsgemm"]:
        m, b = map(int, key.split("x"))
        a, c0 = cols(v, m), cols(hv, b)
        small = ops.gram(a, c0, impl="ref")
        s64 = small.double()
        for name, out, impl in (("kernel", errs, "auto"),
                                ("plain", plain_errs, "ref")):
            got = ops.tsgemm(a, small, alpha=-1.0, beta=1.0, c0=c0,
                             impl=impl)
            out[f"tsgemm {key}"] = max(
                rel_err(gc, cc - ac @ s64, ac.abs() @ s64.abs() + cc.abs())
                for ac, cc, gc in chunks(a, c0, got))
            del got
        del a, c0
    return errs, plain_errs


def curvature_phase(torch, dev, card_line: str) -> None:
    """Phase 33: the Hessian spectrum of qwen2-1.5b's loss (published
    widths, CURV_LAYERS layers, float32, remat on) through
    `examples.curvature_spectrum.hessian_operator` and `eigsh`, on the
    card. Checks: one HVP column against the CPU's and against remat
    off, symmetry, the Ritz
    pairs' true residuals, and the launches of the float32 flash forward
    and backward, gram and tsgemm in the solve (counters zeroed just
    before it and read just after), with the plain second-order calls
    counted."""
    from repro_torch import configs
    from repro_torch.core import eigsh, true_residuals
    from repro_torch.examples.curvature_spectrum import hessian_operator
    from repro_torch.kernels import flashattn, gram, tsgemm
    from repro_torch.models import transformer as tf
    from repro_torch.obs import trace
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    full = configs.get(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=CURV_LAYERS,
                              param_dtype="float32")
    log(f"curvature: {TRAIN_ARCH} at published widths: d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
        f"head dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings {cfg.tie_embeddings}")
    log(f"curvature: reduction: depth cut to {CURV_LAYERS} layers (published "
        f"{full.n_layers})")
    log(f"curvature: reduction: float32 parameters (published "
        f"{full.param_dtype}; a Hessian in bf16 is noise)")
    log(f"curvature: remat {cfg.remat} as published: each HVP's double "
        f"backward recomputes the layers")
    params = tf.init_model(CURV_SEED, cfg, device=dev)
    on_cpu = adamw.tree_map(lambda t: t.cpu(), params)
    op = hessian_operator(cfg, device=dev, params=params,
                          batch_shape=CURV_BATCH)
    log(f"curvature: n_logical {op.n_logical} coordinates (n {op.n}), "
        f"{op.n * 4 / 1e9:.3f} GB per float32 vector; batch "
        f"{CURV_BATCH[0]} x {CURV_BATCH[1]} tokens, seed {CURV_SEED}")

    # one block of two columns: the first against the CPU's, symmetry
    gen = torch.Generator(device=dev).manual_seed(CURV_SEED + 1)
    x = torch.randn((op.n, 2), generator=gen, device=dev)
    x[op.n_logical:] = 0
    hx = op.matmat(x)
    # the same column with remat off, on the card (the parameters shared)
    off = hessian_operator(dataclasses.replace(cfg, remat=False),
                           device=dev, params=params,
                           batch_shape=CURV_BATCH).matmat(x[:, :1])
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = hessian_operator(cfg, device="cpu", params=on_cpu,
                            batch_shape=CURV_BATCH).matmat(x[:, :1].cpu())
    t_cpu = time.perf_counter() - t0
    del on_cpu
    scale = float(want.abs().max())
    hvp_err = float((hx[:, :1].cpu() - want).abs().max()) / scale
    off_err = float((hx[:, :1] - off).abs().max()) / scale
    off_same = bool(torch.equal(hx[:, :1], off))
    del off
    u, v, hu, hv = x[:, 0].double(), x[:, 1].double(), hx[:, 0].double(), \
        hx[:, 1].double()
    sym = float(abs(u @ hv - v @ hu) / (u.norm() * hv.norm()))
    del u, v, hu, hv, want
    log(f"curvature: one HVP column card vs CPU: max |Δ| / max |Hv| "
        f"{hvp_err:.3e} (tol {CURV_HVP_TOL:g}; max |Hv| {scale:.4e}; CPU "
        f"side {t_cpu:.1f} s) | remat on vs off on the card: {off_err:.3e} "
        f"(tol {CURV_HVP_TOL:g}), bit-equal {off_same} | symmetry "
        f"|uᵀHv − vᵀHu| / (‖u‖‖Hv‖) {sym:.3e} (tol {CURV_SYM_TOL:g})")
    if not (hvp_err <= CURV_HVP_TOL and off_err <= CURV_HVP_TOL
            and sym <= CURV_SYM_TOL):
        fail("curvature: the card's Hessian-vector product disagrees with "
             "the CPU's or with remat off, or is not symmetric")
    times = []
    for _ in range(CURV_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op.matmat(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del x, hx
    gc.collect()
    torch.cuda.empty_cache()

    # the solve, counted
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    flashattn.GRAD2_CALLS = 0
    t0 = time.perf_counter()
    with trace.tracing(trace.Tracer()) as tracer:
        res = eigsh(op, CURV_NEV, block_size=CURV_BLOCK, tol=CURV_TOL,
                    max_restarts=CURV_RESTARTS, which="LA")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_attention_f32": flashattn.LAUNCHES_BY_D.get(cfg.hd, 0),
              "flash_attention_bwd_f32":
                  flashattn.BWD_LAUNCHES_BY_D.get(cfg.hd, 0),
              "gram": gram.LAUNCHES, "tsgemm": tsgemm.LAUNCHES,
              "plain second-order calls": flashattn.GRAD2_CALLS}
    by_width = launches_by_width()
    peak = torch.cuda.max_memory_allocated() / 1e9
    resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
    log(f"curvature: eigsh nev {CURV_NEV}, block {CURV_BLOCK}, tol "
        f"{CURV_TOL:g}, which LA: converged {res.converged} in "
        f"{res.n_restarts} restarts, {res.n_ops} HVP blocks, subspace "
        f"m {res.m_subspace}, wall {wall:.3f} s | top eigenvalues "
        f"{np.array2string(np.sort(res.eigenvalues)[::-1], precision=5)}"
        f" | true residuals {np.array2string(resid, precision=3)} (tol "
        f"{CURV_RESID_TOL:g})")
    io, rates = res.io_stats, span_rates(tracer)
    matmat_s = sum(r["dur"] for r in tracer.records() if r["type"] == "span"
                   and r["name"] == "operator.matmat") / 1e6
    log(f"curvature: where the solve's {wall:.3f} s went (host spans): "
        f"operator.matmat {matmat_s:.3f} s; the subspace on the host tier "
        f"(RAM, pinned; every block but the newest): "
        f"{io['host_bytes_read'] / 1e9:.1f} GB read, "
        f"{io['host_bytes_written'] / 1e9:.1f} GB written, "
        f"{io['passes']} passes; store.get "
        f"{rates['store.get']['GB']:.1f} GB in {rates['store.get']['s']:.3f}"
        f" s, store.demote {rates['store.demote']['GB']:.1f} GB in "
        f"{rates['store.demote']['s']:.3f} s")
    log(f"curvature: launches in the solve: {counts} | "
        f"{statistics.median(times) / 2 * 1e3:.3f} ms per HVP column "
        f"(median of {CURV_REPS} blocks of 2: one forward and one "
        f"backward with a graph, then a backward per column) | peak "
        f"device memory {peak:.2f} GB in the solve | {card_line}")
    if not (res.converged and np.isfinite(res.eigenvalues).all()
            and (resid <= CURV_RESID_TOL).all()):
        fail("curvature: the spectrum did not converge, or a Ritz pair's "
             "true residual is above its tolerance")
    for name, n in counts.items():
        if n <= 0:
            fail(f"curvature: {name} ran no time in the solve")
    t0 = time.perf_counter()
    v = torch.as_tensor(res.eigenvectors, dtype=torch.float32, device=dev)
    hv = op.matmat(v)
    errs, plain_errs = curvature_kernel_check(torch, v, hv, by_width)
    del v, hv
    log(f"curvature: gram and tsgemm at the solve's widths "
        f"{json.dumps({k: by_width[k] for k in ('gram', 'tsgemm')})}, "
        f"on the Ritz vectors and their HVP block ({op.n} rows), error / "
        f"Σ|terms| against float64: kernels {json.dumps(errs)} (tol "
        f"{KERNEL_TOL:g}), plain versions {json.dumps(plain_errs)} | "
        f"{time.perf_counter() - t0:.1f} s")
    bad = {k: e for k, e in errs.items() if not e <= KERNEL_TOL}
    if bad or not (by_width["gram"] and by_width["tsgemm"]):
        fail(f"curvature: gram or tsgemm off the float64 product at the "
             f"solve's shapes (tol {KERNEL_TOL:g} of Σ|terms|), or not "
             f"launched: {bad}")
    del op, res
    gc.collect()
    torch.cuda.empty_cache()
    log(f"curvature: phase 33 took {time.perf_counter() - t_phase:.1f} s")


def shard_rank(mesh, cfg, tcfg, dcfg) -> dict:
    """A rank of phase 34c (`dist.spawn` starts it): `train(mesh=)` with
    this process's launch counters zeroed just before and read just
    after."""
    from repro_torch.kernels import flashattn
    from repro_torch.train import train
    zero_counters()
    out = train(cfg, tcfg, dcfg, mesh=mesh, log=lambda *_: None)
    out["flash"] = (flashattn.LAUNCHES_BY_D.get(cfg.hd, 0),
                    flashattn.BWD_LAUNCHES_BY_D.get(cfg.hd, 0))
    return out


def ckpt_params(root: str, step: int) -> list:
    """The parameter leaves ("0/...") of a training checkpoint, as numpy
    arrays in the stored order, without reading its moments."""
    path = os.path.join(root, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        names = json.load(f)["names"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return [z[f"a{i}"] for i, n in enumerate(names)
                if n.startswith("0/")]


def sharded_train_phase(torch, dev, card_line: str) -> dict:
    """Phase 34: sharded training on the card. (a) unsharded, (b) one NCCL
    rank on (1, 1, 1) in this process, (c) SHARD_SHAPE gloo ranks sharing
    the card; the gates of the module docstring. Returns the float32
    flash forward and backward launches of the three runs, every rank's
    (each process's counters zeroed just before its run, read just
    after), and each (c) rank's step collective bytes and held bytes
    (for phase 35)."""
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.dist import comm
    from repro_torch.kernels import flashattn
    from repro_torch.train import TrainConfig, train
    t_phase = time.perf_counter()
    full = configs.get(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=SHARD_LAYERS,
                              param_dtype="float32")
    log(f"sharded train: {TRAIN_ARCH} at published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied embeddings), remat "
        f"{cfg.remat} as published | reductions: depth cut to "
        f"{SHARD_LAYERS} layers (published {full.n_layers}) so that four "
        f"ranks share one card; float32 parameters (published "
        f"{full.param_dtype}) so that the comparison can be tight | "
        f"{SHARD_BATCH} x {SHARD_SEQ} tokens a step, {SHARD_STEPS} steps")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SHARD_SEQ,
                      global_batch=SHARD_BATCH, seed=TRAIN_SEED)
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    n_params = sum(t.numel() for t in adamw.tree_leaves(
        tf.init_model(0, cfg, device="meta")))
    roots = {}

    def tcfg(name):
        roots[name], _ = ckpt_root(3 * 4 * n_params)
        return TrainConfig(steps=SHARD_STEPS, ckpt_every=10 ** 9,
                           ckpt_dir=roots[name], log_every=10 ** 9,
                           peak_lr=SHARD_LR, warmup=SHARD_WARMUP,
                           seed=TRAIN_SEED)

    def counted(run):
        zero_counters()
        out = run()
        torch.cuda.synchronize()
        out["flash"] = (flashattn.LAUNCHES_BY_D.get(cfg.hd, 0),
                        flashattn.BWD_LAUNCHES_BY_D.get(cfg.hd, 0))
        return out

    # (a) and (b) under deterministic algorithms: the embedding's backward
    # adds with atomics otherwise, and (b) is (a) operation for operation
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.reset_peak_memory_stats()
        runs["a"] = [counted(lambda: train(cfg, tcfg("a"), dcfg, device=dev,
                                           log=lambda *_: None))]
        runs["a"][0]["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        comm.init_world("nccl", rank=0, world_size=1, device=dev)
        try:
            mesh = comm.Mesh((1, 1, 1), device=dev)
            runs["b"] = [counted(lambda: train(cfg, tcfg("b"), dcfg,
                                               mesh=mesh,
                                               log=lambda *_: None))]
        finally:
            comm.close_world()
    finally:
        torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs["c"] = comm.spawn(shard_rank, SHARD_SHAPE, backend="gloo",
                           device=dev, args=(cfg, tcfg("c"), dcfg),
                           timeout=900)
    t_c = time.perf_counter() - t0

    a = runs["a"][0]
    want = {"fwd": SHARD_LAYERS * 2 * SHARD_STEPS,
            "bwd": SHARD_LAYERS * SHARD_STEPS}
    bad = []
    for name, outs in runs.items():
        label = {"a": "(a) unsharded, one process",
                 "b": "(b) one NCCL rank, mesh (1, 1, 1)",
                 "c": f"(c) {len(outs)} gloo ranks sharing one card, mesh "
                      f"{SHARD_SHAPE} (staged through host memory: not a "
                      f"speed figure for training on several cards)"}[name]
        for rank, o in enumerate(outs):
            log(f"sharded train {label} rank {rank}: losses "
                f"{[round(x, 6) for x in o['losses']]}, grad norms "
                f"{[round(x, 6) for x in o['grad_norms']]} | step s "
                f"{[round(x, 3) for x in o['step_s']]} | peak device "
                f"memory {(o['peak_device_bytes'] or 0) / 1e9:.2f} GB | flash "
                f"launches forward {o['flash'][0]} (want {want['fwd']}), "
                f"backward {o['flash'][1]} (want {want['bwd']})"
                + ("" if name == "a" else
                   f" | held bytes {o['held_bytes']} | step collective "
                   f"bytes {o['step_bytes'][0]} (design "
                   f"{o['analytic_bytes']}), whole run "
                   f"{o['mesh_bytes']}"))
            if o["flash"] != (want["fwd"], want["bwd"]):
                bad.append(f"{name}{rank}: flash launches {o['flash']}")
            if not np.isfinite(o["losses"]).all() or \
                    len(o["losses"]) != SHARD_STEPS:
                bad.append(f"{name}{rank}: losses {o['losses']}")
            if name == "a":
                continue
            design = {k: v for k, v in o["analytic_bytes"].items() if v}
            if any({k: v for k, v in step.items() if k != "staged"}
                   != design for step in o["step_bytes"]):
                bad.append(f"{name}{rank}: collective bytes "
                           f"{o['step_bytes']} against {design}")
            held = o["held_bytes"]
            if {k: held[k] for k in ("params", "moments")} != held["specs"]:
                bad.append(f"{name}{rank}: held bytes {held}")
            if name == "c" and not o["mesh_bytes"].get("staged"):
                bad.append(f"c{rank}: no staged bytes")
            rtol = SHARD_ONE_RTOL if name == "b" else SHARD_RTOL
            for k in ("losses", "grad_norms"):
                err = float(np.max(np.abs(np.subtract(o[k], a[k]))
                                   / np.abs(a[k])))
                if not err <= rtol:
                    bad.append(f"{name}{rank}: {k} off (a)'s by {err:.3e}")
    same_b = all(runs["b"][0][k] == a[k] for k in ("losses", "grad_norms"))
    pa = ckpt_params(roots["a"], SHARD_STEPS)
    tol = 2 * SHARD_LR * SHARD_STEPS + 1e-5
    worst = {}
    for name in ("b", "c"):
        pb = ckpt_params(roots[name], SHARD_STEPS)
        worst[name] = max(float(np.max(np.abs(x - y))) for x, y in
                          zip(pa, pb))
        del pb
    del pa
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    log(f"sharded train: (b) losses and grad norms bit-equal to (a)'s "
        f"(both under deterministic algorithms): {same_b}; final parameters max |Δ| against (a): (b) "
        f"{worst['b']:.3e}, (c) {worst['c']:.3e} (tol {tol:g}) | (c) "
        f"spawn to last rank done {t_c:.1f} s | {card_line}")
    if worst["c"] > tol or worst["b"] > tol:
        bad.append(f"final parameters off (a)'s: {worst}")
    if bad:
        fail("sharded train: " + "; ".join(bad))
    log(f"sharded train: phase 34 took {time.perf_counter() - t_phase:.1f}"
        f" s")
    launches = {k: sum(o["flash"][i] for outs in runs.values() for o in outs)
                for i, k in enumerate(("flash_attention_f32",
                                       "flash_attention_bwd_f32"))}
    return launches, [{k: o[k] for k in ("step_bytes", "held_bytes")}
                      for o in runs["c"]]


def dry_run_phase(torch, dev, shard_c: list, card_line: str) -> None:
    """Phase 35: the dry run (`launch.dryrun`) against what the card ran.
    (a) phase 34(c)'s program traced on a DryMesh for each rank, held to
    that rank's counted step bytes and held bytes; (b) the dry run of
    32c's step printed beside 32c's measured peak and model flops (no
    gate: the caching allocator is not modelled); (c) a sharded prefill
    and decode in a one-rank NCCL world, bit-equal to the unsharded ones
    under deterministic algorithms; (d) the wall of the whole sweep."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import comm
    from repro_torch.kernels import flashattn
    from repro_torch.launch import dryrun
    from repro_torch.train import sharded
    t_phase = time.perf_counter()
    full = configs.get(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=SHARD_LAYERS,
                              param_dtype="float32")
    bad = []
    # (a) every rank of 34(c): step bytes by kind and held bytes
    shape = ShapeConfig("34c", SHARD_SEQ, SHARD_BATCH, "train")
    row_groups = SHARD_SHAPE[0] * SHARD_SHAPE[1]
    rows = (SHARD_BATCH // row_groups if SHARD_BATCH % row_groups == 0
            else SHARD_BATCH)
    batch = 2 * rows * SHARD_SEQ * 4         # int32 tokens and targets
    for rank, got in enumerate(shard_c):
        run, args, dry, arg_bytes, design, _ = dryrun.lm_program(
            cfg, shape, SHARD_SHAPE, rank=rank, num_microbatches=1)
        rec = dryrun.analyze(run, args, dry, arg_bytes, design, 0.0)
        measured = [{k: v for k, v in step.items() if k != "staged"}
                    for step in got["step_bytes"]]
        held = got["held_bytes"]
        log(f"dry run: (a) 34(c) rank {rank} traced in {rec['trace_s']} s "
            f"on a DryMesh {SHARD_SHAPE}: step collective bytes "
            f"{rec['collective_bytes']} (design {rec['design_bytes']}), "
            f"34(c) measured {measured}; arguments {arg_bytes} = held "
            f"params + moments {held['params'] + held['moments']} + batch "
            f"rows {batch} + step 4; temp {rec['memory']['temp_size_in_bytes']}"
            f" | {card_line}")
        if any(rec["collective_bytes"] != m for m in measured):
            bad.append(f"(a) rank {rank}: traced {rec['collective_bytes']} "
                       f"against measured {measured}")
        if arg_bytes - 4 - batch != held["params"] + held["moments"]:
            bad.append(f"(a) rank {rank}: arguments {arg_bytes} against "
                       f"held {held}")
    # (b) 32c's step, one rank
    run, args, dry, arg_bytes, _, meta = dryrun.lm_program(
        full, ShapeConfig("32c", TRAIN_SEQ, TRAIN_BATCH, "train"),
        (1, 1, 1), num_microbatches=TRAIN_MB)
    rec = dryrun.analyze(run, args, dry, arg_bytes, None, 0.0)
    pred = rec["per_device_bytes_resident"]
    peak = TRAIN_32C.get("peak")
    log(f"dry run: (b) 32c's step ({TRAIN_ARCH}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {TRAIN_MB} microbatches, one rank) traced "
        f"in {rec['trace_s']} s: predicted peak {pred / 1e9:.3f} GB "
        f"(arguments {arg_bytes / 1e9:.3f} + temp "
        f"{rec['memory']['temp_size_in_bytes'] / 1e9:.3f}) against 32c's "
        f"measured peak device memory "
        f"{(peak or float('nan')) / 1e9:.3f} GB; traced FLOPs "
        f"{rec['flops_per_device']:.4e} a step against 32c's model flops "
        f"{TRAIN_32C.get('model_flops', float('nan')):.4e} (ratio "
        f"{rec['flops_per_device'] / TRAIN_32C.get('model_flops', 1):.3f})"
        f"; no gate: the caching allocator is not modelled | {card_line}")
    # (c) a sharded prefill and decode in a one-rank NCCL world
    tokens = np.random.default_rng(TRAIN_SEED).integers(
        0, cfg.vocab_size, (SHARD_BATCH, SHARD_SEQ))
    torch.use_deterministic_algorithms(True)
    comm.init_world("nccl", rank=0, world_size=1, device=dev)
    try:
        mesh = comm.Mesh((1, 1, 1), device=dev)
        zero_counters()
        out = sharded.serve_rows(mesh, cfg, TRAIN_SEED, tokens,
                                 decode_steps=2)
        torch.cuda.synchronize()
        launched = flashattn.LAUNCHES_BY_D.get(cfg.hd, 0)
    finally:
        comm.close_world()
        torch.use_deterministic_algorithms(False)
    same = {"prefill": bool(torch.equal(*out["prefill"])),
            "decode": all(torch.equal(a, b)
                          for a, b in zip(*out["decode"])),
            "cache": all(torch.equal(a, b) for a, b in zip(*out["cache"]))}
    finite = bool(torch.isfinite(out["prefill"][0]).all())
    log(f"dry run: (c) sharded prefill of {SHARD_BATCH} x {SHARD_SEQ} "
        f"tokens and 2 decode steps on one NCCL rank against the "
        f"unsharded steps, under deterministic algorithms: bit-equal "
        f"{same}, finite {finite}, logits {tuple(out['prefill'][0].shape)};"
        f" float32 flash launches {launched} (want {2 * SHARD_LAYERS})")
    if not all(same.values()) or not finite:
        bad.append(f"(c) sharded serving not bit-equal: {same}, finite "
                   f"{finite}")
    if launched != 2 * SHARD_LAYERS:
        bad.append(f"(c) flash launches {launched}, not {2 * SHARD_LAYERS}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the whole sweep, one process a core
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "dryrun.jsonl")
    jobs = os.cpu_count() or 1
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--jobs", str(jobs), "--out", path],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    recs = ([json.loads(ln) for ln in open(path)]
            if os.path.exists(path) else [])
    shutil.rmtree(tmp, ignore_errors=True)
    want = 2 * len(dryrun.all_cells())
    errors = [r for r in recs if "error" in r]
    off = [(r["arch"], r["shape"], r["mesh"]) for r in recs
           if "error" not in r and not (
               r["n_devices"] in (256, 512)
               and r["collective_per_device"]["total"] > 0
               and r["step_time_bound_s"] > 0
               and r.get("design_match", True))]
    log(f"dry run: (d) --all --both-meshes with {jobs} processes: "
        f"{len(recs)} records (want {want}), {len(errors)} errors, "
        f"wall {wall:.1f} s, sum of trace_s "
        f"{sum(r.get('trace_s', 0) for r in recs):.1f} s (host CPU: trace "
        f"output, not card time)")
    if res.returncode or len(recs) != want or errors or off:
        bad.append(f"(d) sweep: exit {res.returncode}, {len(recs)} records, "
                   f"errors {errors[:3]}, off {off[:3]}: "
                   f"{res.stderr[-2000:]}")
    if bad:
        fail("dry run: " + "; ".join(bad))
    log(f"dry run: phase 35 took {time.perf_counter() - t_phase:.1f} s")


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

    tm, graph = make_graph(N_LOG2, NNZ_LOG2)
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
    res_safs = safs_subspace_phase(torch, op, rows, res32, wall32)

    # the rest of the solver family on the same image (phases 14-17)
    t_family = time.perf_counter()
    family = width_phase(torch, op, timer)
    rows += family
    widths = {"lanczos": lanczos_phase(torch, op, res32),
              "lobpcg": lobpcg_phase(torch, op, res32),
              "chebyshev": chebyshev_phase(torch, op, res32)}
    t_family = time.perf_counter() - t_family
    checkpoint_phase(torch, op)                      # phase 20
    safs_crash_phase(torch, op, res32, res_safs)     # phase 21
    traced_phase(torch, op)                          # phase 22
    namespace_phase(torch, op, res32)                # phase 24
    spmm_ladder_phase(torch, op, graph, rows[0])     # phase 25
    del tm                               # the host copy of the image
    gc.collect()
    dist_widths = dist_phase(torch, dev, graph, res32, wall32)  # phase 30
    embed_serial = serve_embed_serial(torch, op)     # for phase 29
    del op, graph                        # free the 12.86 GB image
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    widths["svd"] = svd_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t_family += time.perf_counter() - t0
    tm16 = safs_stream_phase(torch, dev, rows)
    t0 = time.perf_counter()
    widths["shift_invert"] = shift_invert_phase(torch, dev, tm16)
    t_family += time.perf_counter() - t0
    del tm16
    quickstart_phase(torch)                          # phase 23
    tasops_phase(torch, dev)                         # phase 26
    subspace_io_phase(torch, dev)                    # phase 27
    safs_bench_phase(torch, dev)                     # phase 28
    gc.collect()
    torch.cuda.empty_cache()
    serve_counts = serve_phase(torch, dev, embed_serial)   # phase 29
    # each width row's launches: the solve that runs the kernel at it
    for r in family:
        kernel, key = row_width(r["name"])
        phase = {"k1": "chebyshev", "k2": "svd", "k8": "lobpcg",
                 "2x2": "svd", "8x8": "lobpcg", "16x16": "lobpcg",
                 "24x24": "lobpcg"}[key]
        r["launches"] = widths[phase][kernel].get(key, 0)
        if r["launches"] <= 0:
            fail(f"{r['name']} was not launched by the {phase} solve")
    log(f"solver family: phases 14-19 took {t_family:.1f} s (the SAFS "
        f"image phase between them excluded)")

    flash_rows = flash_phase(torch, timer, dev)
    rows += flash_rows
    launches = serve(torch, dev, rows, card_line)
    flash_rows[0]["launches"] = launches["flash_attention"]
    families = lm_families_phase(torch, dev, card_line)   # phase 31
    # the d = 80 row's launches: hubert's forward (one per layer)
    flash_rows[1]["launches"] = families["hubert-xlarge"]["flash"]
    gc.collect()
    torch.cuda.empty_cache()
    bwd_rows = training_phase(torch, dev, timer, card_line)   # phase 32
    for r in bwd_rows:
        r["launches"] = r["count"]()
        if r["launches"] <= 0:
            fail(f"{r['name']} was not launched by phase 32's runs")
    rows += bwd_rows
    gc.collect()
    torch.cuda.empty_cache()
    curvature_phase(torch, dev, card_line)                    # phase 33
    gc.collect()
    torch.cuda.empty_cache()
    shard_counts, shard_c = sharded_train_phase(torch, dev,
                                                card_line)   # phase 34
    gc.collect()
    torch.cuda.empty_cache()
    dry_run_phase(torch, dev, shard_c, card_line)              # phase 35
    for r in rows:      # the launches at each row's width in phases 29, 30a
        r["serve_launches"] = serve_launches(
            r["name"], serve_counts[0],
            {**serve_counts[1], "flash_attention_d80": 0,
             "flash_attention_bwd": 0, "flash_attention_bwd_f32": 0,
             "flash_attention_f32": 0})
        r["dist_launches"] = serve_launches(r["name"], dist_widths, {
            "spmm_blocksparse_bf16": 0, "flash_attention": 0,
            "flash_attention_d80": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_f32": 0, "flash_attention_f32": 0})
        r["shard_launches"] = shard_counts.get(r["name"], 0)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "serve_launches", "dist_launches",
            "shard_launches")
    log(f"total: {time.perf_counter() - t_start:.1f} s (build "
        f"{build_s:.1f} s)")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + (("floor_ms",) if "floor_ms" in r else ())}
        for r in rows]}))   # floor_ms: the flash backward's 7-product floor
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
