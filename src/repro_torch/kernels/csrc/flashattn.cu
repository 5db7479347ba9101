// Flash attention (online softmax) for Hopper (sm_90a), in two routes by
// input type: bf16 on the tensor cores (wgmma, TMA, a producer warp), and
// float32 on the CUDA cores. Output in the input type.
//
// Replaces: src/repro/kernels/flashattn.py : flash_attention_single
// (Pallas body _flash_kernel, pallas_call at :106; vmapped over batch and
// heads by flash_attention). On the TPU one core walked the KV blocks as
// the sequential ("arbitrary") grid axis and carried the running max,
// denominator and accumulator across grid steps in VMEM scratch.
//
// What bounds it on an H100: operations. One causal prefill layer of
// yi-9b (B 4, H 32, Hkv 4, S 2048, d 128, bf16) does 2*B*H*S*S*d = 1.37e11
// flop over the causal half, 0.139 ms at the 989 TFLOP/s bf16 tensor-core
// peak, while Q, K, V and O are 151 MB, 0.045 ms at 3.35 TB/s.
//
// Common to both routes:
//   * a CTA per (query tile, head, batch) walks its KV tiles in order in a
//     loop of its own, which takes the place of the TPU's sequential grid
//     axis; under `causal` the loop stops at the diagonal tile (the TPU
//     kernel's pl.when skip), and the heaviest query tiles launch first;
//   * grouped-query attention in the kernel: head h reads KV head
//     h / (H / Hkv); K and V are never repeated in memory;
//   * strides in elements for batch, head and sequence (the last dim is
//     contiguous), so callers pass views of (B, S, H, d) projections;
//   * ragged Sq and Sk: rows past Sq are not stored, keys past Sk are
//     masked; no divisibility rule on either;
//   * scores, running max, denominator and accumulator in float32, the
//     denominator floored at 1e-30. No atomics and no split of the KV loop
//     over CTAs: every sum runs in a fixed order (per-thread loops and
//     fixed shuffle trees), so the output is bit-identical run to run.
//
// bf16 route (flash_wgmma_kernel), what it does about the bound:
//   * 128 query rows per CTA as two consumer warpgroups of 64 rows, plus
//     one producer warp: 288 threads, one CTA per SM;
//   * the producer issues TMA loads of Q (once) and of 128-key K and V
//     tiles into a 2-stage shared-memory ring guarded by mbarriers ("full"
//     when the bytes have landed, "empty" when both warpgroups are done).
//     The tensor maps are rank 4 over (d, S, H, B), encoded on the host
//     per call from the strides, with 64-column boxes and the 128-byte
//     swizzle that the wgmma descriptors name; rows past Sq or Sk and
//     columns past d land as zeros, so head dims 16 and 32 share the
//     64-column instantiation and 80 (hubert's) the 128-column one: its
//     second box holds columns 64-79 and 48 zero columns, which add
//     nothing to S, and the PV product's columns past d are never stored;
//   * S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//     (K-major); the products of bf16 values are exact in float32;
//   * the online softmax runs on the accumulator fragment in registers:
//     exp2 with the scale folded into log2(e); a row's max and sum go over
//     the 4 lanes that hold it in a fixed xor tree;
//   * O += P V by wgmma with V from shared memory as an MN-major
//     (transposed) B operand and P as the register A operand, split into
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products per step:
//     1.5 times the flops of one bf16 P, and 16 bits of each weight.
//     P_hi alone leaves the rounding of every weight in the output on
//     top of the output's own bf16 rounding, which alone comes close to
//     the 2^-8 limit (PERF.md). Defining REPRO_FLASH_PV_HI_ONLY builds
//     that design instead, for `python -m repro_torch.kernels.flash_pv`,
//     which compares the two in a build of its own; the library never
//     holds it. The denominator sums the float32 weights.
//
// Both routes optionally store each row's log-sum-exp of the scaled scores,
// LSE in natural units, (B, H, Sq) float32, for the backward
// (csrc/flashattn_bwd.cu): their running max is in log2 units with the
// scale folded in, so they store m ln 2 + log(l). O does not depend on
// whether LSE is stored.
//
// float32 route (flash_f32_kernel), on the CUDA cores (the port's numerics
// rule allows no TF32). What bounds it: operations, 4 d flop a kept
// (query, key) pair; at the layer of chip_smoke.py's phase 32b (B 1, H 12,
// Hkv 2, S 1024, d 128, causal) 3.22e9 flop, 0.048 ms at the 67 TFLOP/s
// float32 peak. What its
// design does about that (the tile helpers are in cudacore.cuh, shared
// with the backward's float32 route):
//   * 64 query rows a CTA against 128 keys a step, 256 threads, one CTA an
//     SM at d = 128 (194 KB of shared memory); the CTAs of the heaviest
//     query tiles of every head launch first;
//   * Q (once), K and V are staged row-major by 16-byte cp.async copies,
//     V of this step while S is computed and K of the next step while the
//     PV product runs: two barriers a step;
//   * S = Q K^T in registers, 4 query rows (8 apart) by 8 keys (16 apart)
//     a thread, read as float4s along d; a row's 128 keys are spread over
//     16 lanes of one warp, which take its max and sum in fixed xor trees
//     (bit-identical in every lane); exp2 with the scale folded into
//     log2(e), masked scores -inf;
//   * P stays float32 into the PV product: stored transposed, a row per
//     key, with each thread's 4 query rows in one float4, so that
//     O += P V reads one float4 of P and d/64 float4s of V per key for
//     4 x d/16 accumulators a thread.
//   Head dims 16 and 32 run on 64 columns and 80 on 128 (columns past d
//   are staged as zeros and never stored). ptxas (-Xptxas -v,
//   sm_90a): flash_f32_kernel<128> uses 250 registers and
//   flash_f32_kernel<64> 168, no spills (one CTA of 256 threads an SM may
//   use 255).
//
// The TMA, mbarrier and wgmma helpers and the tensor-map encoder are in
// hopper.cuh, shared with the backward (flashattn_bwd.cu).
#include "cudacore.cuh"

namespace {

// ------------------------------------------------------------ float32 route

constexpr int kFQ = 64;    // query rows a CTA
constexpr int kFK = 128;   // keys a step

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, H, Sq) log-sum-exp, or nullptr
  Strides sq, sk, sv, so;
  int heads, kv_heads, len_q, len_k, head_dim, causal;
  float scale_log2;  // scale * log2(e)
};

// Shared memory of flash_f32_kernel, in floats: Q [64][NP], K and V
// [128][NP] (swizzled), and P^T [128 keys][kLdP].
template <int NP>
constexpr int f32_smem_floats() {
  return kFQ * NP + 2 * kFK * NP + kFK * kLdP;
}

// Max and sum over the 16 lanes of a half warp in fixed xor trees; every
// lane ends with the same bits.
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NP>
__global__ void __launch_bounds__(kFThreads, 1)
flash_f32_kernel(const __grid_constant__ Params p) {
  constexpr int kNB = NP / 64;  // output column chunks a thread
  extern __shared__ float4 f_smem[];
  float* q_s = reinterpret_cast<float*>(f_smem);
  float* k_s = q_s + kFQ * NP;
  float* v_s = k_s + kFK * NP;
  float* pt_s = v_s + kFK * NP;  // P^T, a row per key

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFQ;  // heaviest first
  const int hk = h / (p.heads / p.kv_heads);
  const float* kg = p.k + b * p.sk.b + hk * p.sk.h;
  const float* vg = p.v + b * p.sv.b + hk * p.sv.h;
  int n_tiles = (p.len_k + kFK - 1) / kFK;
  if (p.causal)  // no key past the tile's last query row is needed
    n_tiles = min(n_tiles, (min(q0 + kFQ, p.len_q) - 1) / kFK + 1);

  // A thread: query rows a0 + 8 i (i < 4), keys kg0 + 16 j (j < 8) of S;
  // the same query rows by column chunks kg0 + 16 n of O. The 16 lanes of
  // a half warp share the query rows; P^T holds them as float4 `slot`.
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg0 = lane & 15;
  const int a0 = (w & 3) + 4 * (lane >> 4) + 32 * (w >> 2);
  const int slot[1] = {(a0 & 7) + 8 * (a0 >> 5)};
  int cc[kNB];
#pragma unroll
  for (int n = 0; n < kNB; ++n) cc[n] = kg0 + 16 * n;

  stage_tile<kFQ, NP>(q_s, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0,
                      p.len_q, p.head_dim);
  stage_tile<kFK, NP>(k_s, kg, p.sk.s, 0, p.len_k, p.head_dim);
  cp_async_commit();

  float o[4][4 * kNB], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // this lane's share; the half warp is summed at the end
#pragma unroll
    for (int c = 0; c < 4 * kNB; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFK;
    cp_async_wait_all();
    __syncthreads();  // K of this step is in; the last PV product is done
    stage_tile<kFK, NP>(v_s, vg, p.sv.s, k0, p.len_k, p.head_dim);
    cp_async_commit();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    dot_rows<NP, 4, 8, 8, 16>(s, q_s, a0, k_s, kg0);

    // Online softmax in log2 units; masked scores are -inf.
    const bool edge = k0 + kFK > p.len_k ||
                      (p.causal && k0 + kFK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + a0 + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + kg0 + 16 * j;
        float x = s[i][j] * p.scale_log2;
        if (edge && (kj >= p.len_k || (p.causal && kj > qi))) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      const float base = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[i] - base);
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = exp2f(s[i][j] - base);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 4 * kNB; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(pt_s + (kg0 + 16 * j) * kLdP +
                                 4 * slot[0]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    cp_async_wait_all();
    __syncthreads();  // V and P^T are in; every thread is done with K
    if (t + 1 < n_tiles) {
      stage_tile<kFK, NP>(k_s, kg, p.sk.s, k0 + kFK, p.len_k, p.head_dim);
      cp_async_commit();
    }
    acc_rows<kFK, NP, 1, kNB>(o, pt_s, slot, v_s, cc);   // O += P V
  }

  float* og = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + a0 + 8 * i;
    const float den = fmaxf(half_sum(l[i]), 1e-30f);
    if (qi >= p.len_q) continue;
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int col = 4 * cc[n];
      if (col >= p.head_dim) continue;
      *reinterpret_cast<float4*>(og + qi * p.so.s + col) =
          make_float4(o[i][4 * n] / den, o[i][4 * n + 1] / den,
                      o[i][4 * n + 2] / den, o[i][4 * n + 3] / den);
    }
    if (p.lse != nullptr && kg0 == 0)
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.len_q + qi] =
          m[i] * kLn2 + logf(den);
  }
}

template <int NP>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = f32_smem_floats<NP>() * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.heads, batch, (p.len_q + kFQ - 1) / kFQ);
  flash_f32_kernel<NP><<<grid, kFThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 route

constexpr int kWBM = 128;         // query rows per CTA: two warpgroups of 64
constexpr int kWBK = 128;         // keys per KV tile
constexpr int kWConsumers = 256;  // two consumer warpgroups
constexpr int kWThreads = kWConsumers + 32;  // and one producer warp
constexpr int kStages = 2;        // K/V ring depth

struct WParams {
  TmaView q, k, v;
  __nv_bfloat16* o;
  float* lse;  // (B, H, Sq) log-sum-exp, or nullptr
  Strides so;
  int heads, kv_heads, len_q, len_k, head_dim, causal;
  float scale_log2;  // scale * log2(e)
};

// Max and sum over the 4 lanes of a quad (the lanes that hold one row of
// an accumulator fragment); every lane ends with the same bits.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two weights (the lower key first) as a bf16 pair P_hi = bf16(P) and
// the remainder P_lo = bf16(P - P_hi): P_hi + P_lo carries 16 bits of P.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// NP: head dim padded to whole 64-column boxes (64 for d <= 64, or 128).
// Shared memory, 1024-byte aligned: Q as NP/64 boxes of [128 rows][64],
// then the K ring and the V ring, each stage NP/64 boxes of [128 keys][64],
// then the mbarriers.
template <int NP>
constexpr int wgmma_smem_bytes() {
  return kWBM * NP * 2 + 2 * kStages * kWBK * NP * 2 + 64 + 1024;
}

template <int NP>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ WParams p) {
  constexpr int kSub = NP / kBox;
  constexpr uint32_t kQBytes = kWBM * NP * 2;
  constexpr uint32_t kTileBytes = kWBK * NP * 2;
  extern __shared__ __align__(1024) unsigned char w_smem[];
  const uint32_t q_s = (smem_u32(w_smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;                // + stage * kTileBytes
  const uint32_t v_s = k_s + kStages * kTileBytes;   // + stage * kTileBytes
  const uint32_t bars = v_s + kStages * kTileBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                    // + 8 * stage
  const uint32_t v_full = bars + 8 + 8 * kStages;      // + 8 * stage
  const uint32_t kv_empty = bars + 8 + 16 * kStages;   // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWBM;  // heaviest first
  const int hk = h / (p.heads / p.kv_heads);
  int n_tiles = (p.len_k + kWBK - 1) / kWBK;
  if (p.causal)  // no key past the tile's last query row is needed
    n_tiles = min(n_tiles, (min(q0 + kWBM, p.len_q) - 1) / kWBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWConsumers) {  // the producer warp: one lane issues
    if (threadIdx.x == kWConsumers) {
      mbar_expect_tx(q_full, kQBytes);
      for (int j = 0; j < kSub; ++j)
        tma_load(q_s + j * kWBM * kRowBytes, p.q, j * kBox, q0, h, b,
                 q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // wait for both warpgroups to release the stage
          mbar_wait(kv_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        for (int j = 0; j < kSub; ++j)
          tma_load(k_s + s * kTileBytes + j * kWBK * kRowBytes, p.k,
                   j * kBox, t * kWBK, hk, b, k_full + 8 * s);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        for (int j = 0; j < kSub; ++j)
          tma_load(v_s + s * kTileBytes + j * kWBK * kRowBytes, p.v,
                   j * kBox, t * kWBK, hk, b, v_full + 8 * s);
      }
    }
    return;
  }

  // Consumers. Warpgroup wg owns query rows q0 + 64 wg .. + 63; a thread
  // holds rows row_a and row_a + 8 and, in every 8-column chunk i of a
  // fragment, columns 8 i + col_t and 8 i + col_t + 1.
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row_a = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const int wg_row0 = q0 + wg * 64;
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;

  float o[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_full, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t ks = k_s + s * kTileBytes, vs = v_s + s * kTileBytes;

    // S = Q K^T: NP/16 steps of 16 columns; a step moves 32 bytes inside a
    // 128-byte swizzled row, or on to the next box.
    float sc[kWBK / 2];
    mbar_wait(k_full + 8 * s, parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      wgmma_ss_n128(sc,
                    wgmma_desc(q_wg + (kk >> 2) * kWBM * kRowBytes + col, 16,
                               1024),
                    wgmma_desc(ks + (kk >> 2) * kWBK * kRowBytes + col, 16,
                               1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kWBK / 2>(sc);

    // Online softmax on the fragment, in log2 units.
    const int k0 = t * kWBK;
    const bool masked =
        k0 + kWBK > p.len_k || (p.causal && k0 + kWBK - 1 > wg_row0);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWBK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * p.scale_log2;
        if (masked) {
          const int kj = k0 + 8 * i + col_t + (e & 1);
          const int qi = e < 2 ? row_a : row_a + 8;
          if (kj >= p.len_k || (p.causal && kj > qi)) x = -INFINITY;
        }
        sc[4 * i + e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - base_a);
    const float alpha_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
    // P as the A operand, 16 keys per step, split into bf16 hi and lo
    uint32_t p_hi[kWBK / 16][4], p_lo[kWBK / 16][4];
#pragma unroll
    for (int i = 0; i < kWBK / 8; ++i) {
      const float p0 = exp2f(sc[4 * i] - base_a);
      const float p1 = exp2f(sc[4 * i + 1] - base_a);
      const float p2 = exp2f(sc[4 * i + 2] - base_b);
      const float p3 = exp2f(sc[4 * i + 3] - base_b);
      rs_a += p0 + p1;
      rs_b += p2 + p3;
      const int j = i >> 1, r = (i & 1) * 2;
      split_bf16(p0, p1, p_hi[j][r], p_lo[j][r]);
      split_bf16(p2, p3, p_hi[j][r + 1], p_lo[j][r + 1]);
    }
    l_a = l_a * alpha_a + rs_a;  // per lane; the quad is summed at the end
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      o[4 * i] *= alpha_a;
      o[4 * i + 1] *= alpha_a;
      o[4 * i + 2] *= alpha_b;
      o[4 * i + 3] *= alpha_b;
    }

    // O += P_hi V + P_lo V: 8 steps of 16 keys, 2 KB apart in every box
    // of V, each step the hi product then the lo one.
    mbar_wait(v_full + 8 * s, parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kWBK / 16; ++j) {
      const uint64_t desc_v =
          wgmma_desc(vs + j * 16 * kRowBytes, kWBK * kRowBytes, 1024);
      wgmma_pv<NP>(o, p_hi[j], desc_v);
#ifndef REPRO_FLASH_PV_HI_ONLY
      wgmma_pv<NP>(o, p_lo[j], desc_v);
#endif
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NP / 2>(o);
    mbar_arrive(kv_empty + 8 * s);
  }

  const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
  __nv_bfloat16* og = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < NP / 8; ++i) {
    const int col = 8 * i + col_t;
    if (col >= p.head_dim) continue;
    if (row_a < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(og + row_a * p.so.s + col) =
          __floats2bfloat162_rn(o[4 * i] / den_a, o[4 * i + 1] / den_a);
    if (row_a + 8 < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(og + (row_a + 8) * p.so.s + col) =
          __floats2bfloat162_rn(o[4 * i + 2] / den_b, o[4 * i + 3] / den_b);
  }
  if (p.lse != nullptr && (lane & 3) == 0) {  // one lane of each quad
    float* lg = p.lse + (static_cast<long long>(b) * p.heads + h) * p.len_q;
    if (row_a < p.len_q) lg[row_a] = m_a * kLn2 + logf(den_a);
    if (row_a + 8 < p.len_q) lg[row_a + 8] = m_b * kLn2 + logf(den_b);
  }
}

template <int NP>
cudaError_t launch_bf16(const WParams& p, int batch, cudaStream_t stream) {
  constexpr int bytes = wgmma_smem_bytes<NP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.heads, batch, (p.len_q + kWBM - 1) / kWBM);
  flash_wgmma_kernel<NP><<<grid, kWThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

void unpack_strides(const long long* strides, Strides* out[4]) {
  for (int i = 0; i < 4; ++i)
    *out[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// q (B, H, Sq, d), k/v (B, Hkv, Sk, d), o (B, H, Sq, d) of one type, each
// addressed by its (batch, head, sequence) strides in elements, in this
// order in `strides` (a host array of 12): q, k, v, o. The last dim is
// contiguous; q, k and v are 16-byte aligned and each of their strides of
// a dim longer than 1 is a multiple of 16 bytes (the kernels read 16-byte
// pieces; checked by the wrapper). lse is a contiguous (B, H, Sq) float32
// array, or null to store none. The caller guarantees B, H, Hkv, Sq,
// Sk >= 1, H % Hkv == 0, d in {16, 32, 64, 80, 128}.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         const long long* strides, int batch,
                                         int heads, int kv_heads, int len_q,
                                         int len_k, int head_dim, int causal,
                                         float scale, int device,
                                         void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (head_dim % 16 != 0 || head_dim < 16 || head_dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  Strides* all[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  unpack_strides(strides, all);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.head_dim = head_dim;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim <= 64 ? launch_f32<64>(p, batch, s)
                                         : launch_f32<128>(p, batch, s));
}

// The same contract in bf16 (the 16-byte rule is TMA's).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          const long long* strides, int batch,
                                          int heads, int kv_heads, int len_q,
                                          int len_k, int head_dim, int causal,
                                          float scale, int device,
                                          void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (head_dim % 16 != 0 || head_dim < 16 || head_dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  WParams p;
  Strides sq, sk, sv;
  Strides* all[4] = {&sq, &sk, &sv, &p.so};
  unpack_strides(strides, all);
  int err = encode_view(&p.q, q, batch, heads, len_q, head_dim, sq, kWBM);
  if (err == 0)
    err = encode_view(&p.k, k, batch, kv_heads, len_k, head_dim, sk, kWBK);
  if (err == 0)
    err = encode_view(&p.v, v, batch, kv_heads, len_k, head_dim, sv, kWBK);
  if (err != 0) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.head_dim = head_dim;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim <= 64 ? launch_bf16<64>(p, batch, s)
                                         : launch_bf16<128>(p, batch, s));
}
