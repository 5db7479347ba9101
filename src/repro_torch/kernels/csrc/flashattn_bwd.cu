// The backward of flash attention for Hopper (sm_90a): dQ, dK and dV of
// softmax attention from Q, K, V, the forward's output O, its row
// log-sum-exp LSE (csrc/flashattn.cu stores it) and dO. bf16 or float32
// inputs, gradients in the input type.
//
// Replaces: no Pallas kernel. The TPU package trains by JAX's autodiff of
// its plain attention (src/repro/models/attention.py : _attend, and
// src/repro/kernels/flashattn_ref.py : attention_ref); its Pallas forward
// (src/repro/kernels/flashattn.py : flash_attention_single) has no
// backward. The port's forward is the hand-written kernel, so its
// gradient is one too (kernels/ops.py wraps both in an autograd.Function).
//
// What bounds it on an H100: operations. With s = scale * Q K^T,
// P = exp(s - LSE), D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,
// plus the recomputed S: 5 products of 2 B H Sq Sk d flop, halved under
// causal. qwen2-1.5b's training layer (B 2, H 12, Hkv 2, S 4096, d 128,
// causal, bf16) needs 2.58e11 flop, 0.261 ms at the 989 TFLOP/s bf16
// tensor-core peak; its Q, K, V, O, dO, LSE in and dQ, dK, dV out are
// 118 MB, 0.035 ms at 3.35 TB/s.
//
// No atomics in either route: dQ is summed over the keys by the CTA of its
// query tile, dK and dV over the queries by the CTAs of their key tile,
// each in a fixed order, so the gradients are bit-identical run to run.
// That costs the recomputation of S and dP for dQ: 7 products where an
// atomic dQ (FlashAttention-2) needs 5 (3.61e11 flop at qwen2's layer,
// 0.365 ms at the peak).
//
// bf16 route, on the tensor cores (wgmma, TMA loads; the helpers are in
// hopper.cuh, shared with the forward), four launches on the caller's
// stream (three when H = Hkv):
//   * flash_bwd_prep_kernel: D = rowsum(dO o O) (one warp per row, as in
//     the float32 route) and LSE log2(e), into (B, H, Sq_pad) scratch
//     padded to whole 64-row tiles; a padded row has LSE = +inf and D = 0,
//     so its P and dS come out 0 with no mask;
//   * flash_bwd_dkdv_wgmma_kernel: a CTA per (64-key tile, query head,
//     batch) of one warpgroup, two CTAs per SM. Thread 0 loads the K and V
//     tiles once by TMA and streams the 64-query tiles of Q and dO, with
//     their LSE and D by bulk copies, through a 2-stage ring on mbarriers;
//     under causal the CTA walks the query tiles from the diagonal on, and
//     the key tiles launch heaviest first. In the transposed orientation
//     (FlashAttention-3's), per query tile: S^T = K Q^T and dP^T = V dO^T
//     by wgmma m64n64k16 with both operands in shared memory (K-major);
//     P^T = exp2(S^T scale log2(e) - LSE log2(e)) and
//     dS^T = P^T o (dP^T - D) on the accumulator fragments in registers,
//     which are the layout of wgmma's register A operand; dV += P^T dO and
//     dK += dS^T Q by wgmma with dO and Q as MN-major B operands (as the
//     forward's V). With G = H / Hkv > 1 the CTA stores float32 partials
//     (B, H, Sk, d) of dK and dV; with G = 1, the bf16 gradients;
//   * flash_bwd_reduce_kernel (G > 1): dK and dV of a KV head as the sum
//     of its G partials in order g = 0 .. G-1, dK scaled, cast to bf16;
//   * flash_bwd_dq_wgmma_kernel: a CTA per (64-query tile, head, batch),
//     one warpgroup, Q and dO loaded once, 64-key tiles of K and V through
//     a 2-stage ring up to the diagonal, heaviest tiles first: S = Q K^T
//     and dP = dO V^T from shared memory, dS in registers, and dQ += dS K
//     with K as the MN-major B operand.
//   Every accumulator is float32; P and dS are rounded to bf16 once for
//   their products (tests/test_torch_flash_bwd.py models that rounding
//   against the gates). Rows past Sq and keys past Sk arrive as TMA zeros,
//   and so do columns past d (d = 16 and 32 run on 64 columns, 80 on 128,
//   as in the forward): they add nothing to S or dP. Keys past Sk and the
//   pairs causal masks get P = 0, and nothing past Sq, Sk or d is stored.
//   A key tile that no query sees (causal, Sq < Sk) stores zeros.
//   A CTA per query head, not per KV head: per KV head qwen2's layer would
//   be 128 CTAs of 64 keys on 132 SMs, the first walking 6 x 64 query
//   tiles and the last 6; per query head it is 1,536 CTAs, and its
//   partials (100.7 MB there) cost ~0.06 ms to write and read.
//
// float32 route, on the CUDA cores (the port's numerics rule allows no
// TF32, so the tensor cores are not used), three launches:
//   * flash_bwd_delta_kernel: D = rowsum(dO o O), one warp per row, each
//     lane over columns lane, lane + 32, ... then a fixed xor tree;
//   * flash_bwd_dkdv_kernel: a CTA per (64-key tile, KV head, batch)
//     holds K^T and V^T in shared memory and dK, dV in registers, and walks
//     the KV head's G query heads in order g = 0 .. G-1 and, for each, the
//     64-row query tiles from the diagonal on under `causal` (the earlier
//     ones see none of these keys); per tile it recomputes S and dP, forms
//     P and dS in shared memory and adds P^T dO and dS^T Q;
//   * flash_bwd_dq_kernel: a CTA per (64-row query tile, head, batch)
//     holds Q^T and dO^T and walks the key tiles up to the diagonal,
//     recomputing S and dP and adding dS K into dQ in registers.
// Layout of a CTA (256 threads as 16 x 16, tx = tid % 16, ty = tid / 16):
// a thread owns 4 consecutive rows 4 ty .. 4 ty + 3 of a 64 x 64 score
// tile and the columns tx + 16 j (j < 4); of a 64 x d accumulator the same
// rows and the columns tx + 16 c (c < d / 16). Matrices read 4 rows at a
// time are stored with rows of 68 floats (float4 loads), those read one
// column per thread with rows of 65 (conflict-free both along and across
// rows). Masked and out-of-range entries of P and dS are 0; rows and keys
// past Sq and Sk are staged as zeros and never stored.
#include "hopper.cuh"

namespace {

// ------------------------------------------------------------ float32 route

template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq), written by the first launch
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int batch, heads, kv_heads, len_q, len_k, head_dim, causal;
  float scale;
};

constexpr int kBT = 64;          // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLdT = kBT + 4;    // rows read as float4
constexpr int kLdS = kBT + 1;    // rows read one column per thread

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_f(float* p, float x) { *p = x; }

// Stage rows [r0, r0 + 64) of a (len, D) matrix transposed, dst[c * ld + r],
// zeros past len.
template <typename T, int D>
__device__ __forceinline__ void stage_t(float* dst, int ld, const T* src,
                                        long long stride, int r0, int len) {
  for (int i = threadIdx.x; i < kBT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[c * ld + r] = g < len ? ld_f(src + g * stride + c) : 0.f;
  }
}

// LSE and D of rows [q0, q0 + 64), zeros past len_q.
__device__ __forceinline__ void stage_rows(float* lse_s, float* dl_s,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int len_q) {
  if (threadIdx.x < kBT) {
    const int qi = q0 + threadIdx.x;
    const bool in = qi < len_q;
    lse_s[threadIdx.x] = in ? lse[qi] : 0.f;
    dl_s[threadIdx.x] = in ? delta[qi] : 0.f;
  }
}

__device__ __forceinline__ bool kept(int qi, int kj, int len_q, int len_k,
                                     int causal) {
  return qi < len_q && kj < len_k && !(causal && kj > qi);
}

// D of one row, rowsum(dO o O): lane c sums columns c, c + 32, ... in
// order, then a fixed xor tree; every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ float row_delta(const T* og, const T* dg,
                                           int head_dim, int lane) {
  float acc = 0.f;
  for (int c = lane; c < head_dim; c += 32)
    acc = fmaf(ld_f(og + c), ld_f(dg + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const BwdParams<T> p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  const long long rows =
      static_cast<long long>(p.batch) * p.heads * p.len_q;
  if (row >= rows) return;
  const int qi = static_cast<int>(row % p.len_q);
  const long long bh = row / p.len_q;
  const int h = static_cast<int>(bh % p.heads);
  const int b = static_cast<int>(bh / p.heads);
  const float acc =
      row_delta(p.o + b * p.so.b + h * p.so.h + qi * p.so.s,
                p.dout + b * p.sdo.b + h * p.sdo.h + qi * p.sdo.s,
                p.head_dim, lane);
  if (lane == 0) p.delta[row] = acc;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * D * kLdT + 2 * D * kLdS + 2 * kBT * kLdT + 2 * kBT;
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * D * kLdT + 2 * D * kLdS + kBT * kLdT + 2 * kBT;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const BwdParams<T> p) {
  static_assert(D % 16 == 0 && D >= 16, "head dim");
  constexpr int kC = D / 16;
  extern __shared__ float4 dkdv_smem[];
  float* kt = reinterpret_cast<float*>(dkdv_smem);  // [D][kLdT] K^T
  float* vt = kt + D * kLdT;                         // [D][kLdT] V^T
  float* qt = vt + D * kLdT;                         // [D][kLdS] Q^T
  float* dot = qt + D * kLdS;                        // [D][kLdS] dO^T
  float* pm = dot + D * kLdS;     // [kBT][kLdT] P, a row per query
  float* dsm = pm + kBT * kLdT;   // [kBT][kLdT] dS, a row per query
  float* lse_s = dsm + kBT * kLdT;
  float* dl_s = lse_s + kBT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBT;  // under causal the first tiles weigh most
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  stage_t<T, D>(kt, kLdT, p.k + b * p.sk.b + hk * p.sk.h, p.sk.s, k0,
                p.len_k);
  stage_t<T, D>(vt, kLdT, p.v + b * p.sv.b + hk * p.sv.h, p.sv.s, k0,
                p.len_k);

  float dk[4][kC], dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (p.len_q + kBT - 1) / kBT;
  const int first = p.causal ? k0 / kBT : 0;  // no earlier row sees a key
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qg = p.q + b * p.sq.b + h * p.sq.h;
    const T* dg = p.dout + b * p.sdo.b + h * p.sdo.h;
    const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.len_q;
    for (int t = first; t < n_q; ++t) {
      const int q0 = t * kBT;
      __syncthreads();  // K, V staged; the last tile's Q, dO, P, dS consumed
      stage_t<T, D>(qt, kLdS, qg, p.sq.s, q0, p.len_q);
      stage_t<T, D>(dot, kLdS, dg, p.sdo.s, q0, p.len_q);
      stage_rows(lse_s, dl_s, p.lse + row0, p.delta + row0, q0, p.len_q);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(kt + c * kLdT +
                                                           4 * ty);
        const float4 v4 = *reinterpret_cast<const float4*>(vt + c * kLdT +
                                                           4 * ty);
        const float kr[4] = {k4.x, k4.y, k4.z, k4.w};
        const float vr[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float qv = qt[c * kLdS + tx + 16 * j];
          const float gv = dot[c * kLdS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(kr[i], qv, s[i][j]);
            dp[i][j] = fmaf(vr[i], gv, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j, qi = q0 + ql;
        float pr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + 4 * ty + i;
          const float pv = kept(qi, kj, p.len_q, p.len_k, p.causal)
                               ? expf(s[i][j] * p.scale - lse_s[ql])
                               : 0.f;
          pr[i] = pv;
          dr[i] = pv * (dp[i][j] - dl_s[ql]);
        }
        *reinterpret_cast<float4*>(pm + ql * kLdT + 4 * ty) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
        *reinterpret_cast<float4*>(dsm + ql * kLdT + 4 * ty) =
            make_float4(dr[0], dr[1], dr[2], dr[3]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q, over the tile's queries in order
#pragma unroll 4
      for (int ql = 0; ql < kBT; ++ql) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pm + ql * kLdT + 4 * ty);
        const float4 d4 =
            *reinterpret_cast<const float4*>(dsm + ql * kLdT + 4 * ty);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float gv = dot[(tx + 16 * c) * kLdS + ql];
          const float qv = qt[(tx + 16 * c) * kLdS + ql];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pr[i], gv, dv[i][c]);
            dk[i][c] = fmaf(dr[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dkg = p.dk + b * p.sdk.b + hk * p.sdk.h;
  T* dvg = p.dv + b * p.sdv.b + hk * p.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= p.len_k) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      st_f(dkg + kj * p.sdk.s + tx + 16 * c, dk[i][c] * p.scale);
      st_f(dvg + kj * p.sdv.s + tx + 16 * c, dv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams<T> p) {
  static_assert(D % 16 == 0 && D >= 16, "head dim");
  constexpr int kC = D / 16;
  extern __shared__ float4 dq_smem[];
  float* qt = reinterpret_cast<float*>(dq_smem);  // [D][kLdT] Q^T
  float* dot = qt + D * kLdT;                      // [D][kLdT] dO^T
  float* kt = dot + D * kLdT;                      // [D][kLdS] K^T
  float* vt = kt + D * kLdS;                       // [D][kLdS] V^T
  float* dst = vt + D * kLdS;   // [kBT][kLdT] dS^T, a row per key
  float* lse_s = dst + kBT * kLdT;
  float* dl_s = lse_s + kBT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBT;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.len_q;
  stage_t<T, D>(qt, kLdT, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0,
                p.len_q);
  stage_t<T, D>(dot, kLdT, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0,
                p.len_q);
  stage_rows(lse_s, dl_s, p.lse + row0, p.delta + row0, q0, p.len_q);
  const T* kg = p.k + b * p.sk.b + hk * p.sk.h;
  const T* vg = p.v + b * p.sv.b + hk * p.sv.h;

  float dq[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dq[i][c] = 0.f;

  int n_k = (p.len_k + kBT - 1) / kBT;
  if (p.causal)  // no key past the tile's last query row is needed
    n_k = min(n_k, (min(q0 + kBT, p.len_q) - 1) / kBT + 1);
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * kBT;
    __syncthreads();  // Q, dO staged; the last tile's K, V, dS consumed
    stage_t<T, D>(kt, kLdS, kg, p.sk.s, k0, p.len_k);
    stage_t<T, D>(vt, kLdS, vg, p.sv.s, k0, p.len_k);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows are queries, columns keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(qt + c * kLdT + 4 * ty);
      const float4 g4 =
          *reinterpret_cast<const float4*>(dot + c * kLdT + 4 * ty);
      const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
      const float gr[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = kt[c * kLdS + tx + 16 * j];
        const float vv = vt[c * kLdS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qr[i], kv, s[i][j]);
          dp[i][j] = fmaf(gr[i], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = tx + 16 * j, kj = k0 + kl;
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = 4 * ty + i;
        dr[i] = kept(q0 + ql, kj, p.len_q, p.len_k, p.causal)
                    ? expf(s[i][j] * p.scale - lse_s[ql]) *
                          (dp[i][j] - dl_s[ql])
                    : 0.f;
      }
      *reinterpret_cast<float4*>(dst + kl * kLdT + 4 * ty) =
          make_float4(dr[0], dr[1], dr[2], dr[3]);
    }
    __syncthreads();

    // dQ += dS K, over the tile's keys in order
#pragma unroll 4
    for (int kl = 0; kl < kBT; ++kl) {
      const float4 d4 =
          *reinterpret_cast<const float4*>(dst + kl * kLdT + 4 * ty);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kv = kt[(tx + 16 * c) * kLdS + kl];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(dr[i], kv, dq[i][c]);
      }
    }
  }

  T* dqg = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.len_q) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      st_f(dqg + qi * p.sdq.s + tx + 16 * c, dq[i][c] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const BwdParams<T>& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.batch) * p.heads * p.len_q;
  flash_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + 7) / 8), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kv_bytes = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.len_k + kBT - 1) / kBT, p.kv_heads, p.batch);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, kv_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.len_q + kBT - 1) / kBT, p.heads, p.batch);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, q_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int run_bwd(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* delta, void* dq,
            void* dk, void* dv, const long long* strides, int batch,
            int heads, int kv_heads, int len_q, int len_k, int head_dim,
            int causal, float scale, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  BwdParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  Strides* all[8] = {&p.sq, &p.sk, &p.sv, &p.so,
                     &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.head_dim = head_dim;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch_bwd<T, 16>(p, s));
    case 32: return static_cast<int>(launch_bwd<T, 32>(p, s));
    case 64: return static_cast<int>(launch_bwd<T, 64>(p, s));
    case 80: return static_cast<int>(launch_bwd<T, 80>(p, s));
    case 128: return static_cast<int>(launch_bwd<T, 128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --------------------------------------------------------------- bf16 route

constexpr int kB = 64;                     // queries and keys per tile
constexpr int kWg = 128;                   // one warpgroup a CTA
constexpr int kBoxBytes = kB * kRowBytes;  // one 64-column box of a tile
constexpr int kRowsBytes = 2 * kB * 4;     // LSE log2(e) and D of a tile

struct BParams {
  TmaView q, k, v, dout;  // boxes of 64 columns by kB rows
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout_ptr;
  const float* lse;  // (B, H, Sq) log-sum-exp, natural units
  float* lse2;       // (B, H, Sq_pad): LSE log2(e), +inf past Sq
  float* delta;      // (B, H, Sq_pad): D, 0 past Sq
  float* partial;    // (2, B, H, Sk, d) dK and dV per query head, or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides so, sdo, sdq, sdk, sdv;
  int batch, heads, kv_heads, len_q, len_k, len_q_pad, head_dim, causal;
  float scale, scale_log2;  // scale, and scale * log2(e)
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const __grid_constant__ BParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (row >= static_cast<long long>(p.batch) * p.heads * p.len_q_pad) return;
  const int qi = static_cast<int>(row % p.len_q_pad);
  const long long bh = row / p.len_q_pad;
  float dsum = 0.f, lse2 = INFINITY;
  if (qi < p.len_q) {  // the whole warp takes one branch
    const int h = static_cast<int>(bh % p.heads);
    const int b = static_cast<int>(bh / p.heads);
    dsum = row_delta(p.o + b * p.so.b + h * p.so.h + qi * p.so.s,
                     p.dout_ptr + b * p.sdo.b + h * p.sdo.h + qi * p.sdo.s,
                     p.head_dim, lane);
    lse2 = p.lse[bh * p.len_q + qi] * kLog2e;
  }
  if (lane == 0) {
    p.delta[row] = dsum;
    p.lse2[row] = lse2;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Holds a wgmma's register A operand until the wait that retires it, so
// that no register of it is reused while the product may still read it.
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

// Shared memory, 1024-byte aligned, of both wgmma kernels: six tiles of
// NP/64 boxes of [64 rows][64 columns] (128-byte swizzle), then the LSE
// and D of two query tiles (the dK/dV kernel's), then the mbarriers.
template <int NP>
constexpr int bwd_smem_bytes() {
  return 6 * (NP / kBox) * kBoxBytes + 2 * kRowsBytes + 64 + 1024;
}

template <int NP>
__global__ void __launch_bounds__(kWg, 2)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ BParams p) {
  constexpr int kSub = NP / kBox;
  constexpr uint32_t kTile = kSub * kBoxBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + kTile;
  const uint32_t q_s = base + 2 * kTile;     // + stage * kTile
  const uint32_t do_s = base + 4 * kTile;    // + stage * kTile
  const uint32_t rows_s = base + 6 * kTile;  // + stage * kRowsBytes
  const uint32_t kv_full = rows_s + 2 * kRowsBytes;
  const uint32_t qd_full = kv_full + 8;      // + 8 * stage
  const float* rows = reinterpret_cast<const float*>(wg_smem + (rows_s - raw));

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kB;  // under causal the first key tiles weigh most
  const int hk = h / (p.heads / p.kv_heads);
  const int n_q = (p.len_q + kB - 1) / kB;
  const int first = p.causal ? k0 / kB : 0;  // no earlier query sees a key
  const int n_tiles = max(n_q - first, 0);
  const long long row0 = (static_cast<long long>(b) * p.heads + h) *
                         p.len_q_pad;

  // Q, dO, LSE log2(e) and D of query tile first + t into stage t % 2
  auto load_q_tile = [&](int t) {
    const int s = t & 1, q0 = (first + t) * kB;
    const uint32_t bar = qd_full + 8 * s;
    mbar_expect_tx(bar, 2 * kTile + kRowsBytes);
    for (int j = 0; j < kSub; ++j) {
      tma_load(q_s + s * kTile + j * kBoxBytes, p.q, j * kBox, q0, h, b,
               bar);
      tma_load(do_s + s * kTile + j * kBoxBytes, p.dout, j * kBox, q0, h, b,
               bar);
    }
    bulk_load(rows_s + s * kRowsBytes, p.lse2 + row0 + q0, kB * 4, bar);
    bulk_load(rows_s + s * kRowsBytes + kB * 4, p.delta + row0 + q0, kB * 4,
              bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(qd_full, 1);
    mbar_init(qd_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(kv_full, 2 * kTile);
    for (int j = 0; j < kSub; ++j) {
      tma_load(k_s + j * kBoxBytes, p.k, j * kBox, k0, hk, b, kv_full);
      tma_load(v_s + j * kBoxBytes, p.v, j * kBox, k0, hk, b, kv_full);
    }
    load_q_tile(0);
    if (n_tiles > 1) load_q_tile(1);
  }

  // A thread holds key rows r_a and r_a + 8 of the tile and, in every
  // 8-column chunk i of a fragment, columns 8 i + col_t and 8 i + col_t + 1
  // (queries in S^T and dP^T, head-dim columns in dK and dV).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_a = warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  float dk[NP / 2], dv[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const int q0 = (first + t) * kB;
    const uint32_t qs = q_s + s * kTile, dos = do_s + s * kTile;
    const float* lse2 = rows + s * 2 * kB;
    const float* dl = lse2 + kB;
    mbar_wait(qd_full + 8 * s, (t >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T, one commit group each: NP/16 steps of
    // 16 columns; a step moves 32 bytes inside a 128-byte swizzled row, or
    // on to the next box.
    float st[kB / 2], dpt[kB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(st, wgmma_desc(k_s + off, 16, 1024),
                   wgmma_desc(qs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(dpt, wgmma_desc(v_s + off, 16, 1024),
                   wgmma_desc(dos + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T may still run
    fence_regs<kB / 2>(st);

    // P^T: float32 in st (for dS^T), bf16 as the A operand, 16 queries a
    // step. Under causal a key past a query gets 0.
    const bool diag = p.causal && k0 + kB - 1 > q0;
    uint32_t pa[kB / 16][4];
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(lse2 + 8 * i + col_t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2f(fmaf(st[4 * i + e], p.scale_log2,
                             -((e & 1) ? l2.y : l2.x)));
        if (diag && r_a + 8 * (e >> 1) + k0 > q0 + 8 * i + col_t + (e & 1))
          x = 0.f;
        st[4 * i + e] = x;
      }
      pa[i >> 1][(i & 1) * 2] = pack_bf16(st[4 * i], st[4 * i + 1]);
      pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(st[4 * i + 2], st[4 * i + 3]);
    }

    // dV += P^T dO: kB/16 steps of 16 queries, 2 KB apart in every box of
    // dO (an MN-major B operand)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kB / 16; ++j)
      wgmma_pv<NP>(dv, pa[j],
                   wgmma_desc(dos + j * 16 * kRowBytes, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dV may still run
    fence_regs<kB / 2>(dpt);

    // dS^T = P^T o (dP^T - D), bf16 as the A operand
    uint32_t dsa[kB / 16][4];
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
      const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * i + col_t);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = st[4 * i + e] * (dpt[4 * i + e] - ((e & 1) ? dd.y : dd.x));
      dsa[i >> 1][(i & 1) * 2] = pack_bf16(x[0], x[1]);
      dsa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }

    // dK += dS^T Q (scaled once, at the store or in the reduction)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kB / 16; ++j)
      wgmma_pv<NP>(dk, dsa[j],
                   wgmma_desc(qs + j * 16 * kRowBytes, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs<kB / 4>(&pa[0][0]);
    keep_regs<kB / 4>(&dsa[0][0]);
    fence_regs<NP / 2>(dv);
    fence_regs<NP / 2>(dk);
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && t + 2 < n_tiles) load_q_tile(t + 2);
  }

  const int k_a = k0 + r_a;
  if (p.partial == nullptr) {  // G = 1: the gradients themselves
    __nv_bfloat16* dkg = p.dk + b * p.sdk.b + hk * p.sdk.h;
    __nv_bfloat16* dvg = p.dv + b * p.sdv.b + hk * p.sdv.h;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      const int col = 8 * i + col_t;
      if (col >= p.head_dim) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = k_a + 8 * r;
        if (kj >= p.len_k) continue;
        *reinterpret_cast<__nv_bfloat162*>(dkg + kj * p.sdk.s + col) =
            __floats2bfloat162_rn(dk[4 * i + 2 * r] * p.scale,
                                  dk[4 * i + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + kj * p.sdv.s + col) =
            __floats2bfloat162_rn(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  } else {  // this query head's partials, summed by flash_bwd_reduce_kernel
    const long long head = static_cast<long long>(p.len_k) * p.head_dim;
    const long long plane = static_cast<long long>(p.batch) * p.heads * head;
    float* pk = p.partial + (static_cast<long long>(b) * p.heads + h) * head;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      const int col = 8 * i + col_t;
      if (col >= p.head_dim) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = k_a + 8 * r;
        if (kj >= p.len_k) continue;
        float* at = pk + static_cast<long long>(kj) * p.head_dim + col;
        *reinterpret_cast<float2*>(at) =
            make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(at + plane) =
            make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dK and dV of (B, Hkv, Sk, d) from the partials: a thread per pair of
// columns sums the G query heads of its KV head in order.
__global__ void __launch_bounds__(kThreads)
flash_bwd_reduce_kernel(const __grid_constant__ BParams p) {
  const int half = p.head_dim / 2;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(p.batch) * p.kv_heads * p.len_k * half)
    return;
  const int c = static_cast<int>(i % half) * 2;
  long long r = i / half;
  const int kj = static_cast<int>(r % p.len_k);
  r /= p.len_k;
  const int hk = static_cast<int>(r % p.kv_heads);
  const int b = static_cast<int>(r / p.kv_heads);
  const int group = p.heads / p.kv_heads;
  const long long head = static_cast<long long>(p.len_k) * p.head_dim;
  const long long plane = static_cast<long long>(p.batch) * p.heads * head;
  const float* at = p.partial +
                    (static_cast<long long>(b) * p.heads + hk * group) * head +
                    static_cast<long long>(kj) * p.head_dim + c;
  float2 sk = *reinterpret_cast<const float2*>(at);
  float2 sv = *reinterpret_cast<const float2*>(at + plane);
  for (int g = 1; g < group; ++g) {
    const float2 gk = *reinterpret_cast<const float2*>(at + g * head);
    const float2 gv = *reinterpret_cast<const float2*>(at + plane + g * head);
    sk.x += gk.x;
    sk.y += gk.y;
    sv.x += gv.x;
    sv.y += gv.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(p.dk + b * p.sdk.b + hk * p.sdk.h +
                                     kj * p.sdk.s + c) =
      __floats2bfloat162_rn(sk.x * p.scale, sk.y * p.scale);
  *reinterpret_cast<__nv_bfloat162*>(p.dv + b * p.sdv.b + hk * p.sdv.h +
                                     kj * p.sdv.s + c) =
      __floats2bfloat162_rn(sv.x, sv.y);
}

template <int NP>
__global__ void __launch_bounds__(kWg, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BParams p) {
  constexpr int kSub = NP / kBox;
  constexpr uint32_t kTile = kSub * kBoxBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + kTile;
  const uint32_t k_s = base + 2 * kTile;  // + stage * kTile
  const uint32_t v_s = base + 4 * kTile;  // + stage * kTile
  const uint32_t qd_full = base + 6 * kTile + 2 * kRowsBytes;
  const uint32_t kv_full = qd_full + 8;   // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;  // heaviest first
  const int hk = h / (p.heads / p.kv_heads);
  int n_k = (p.len_k + kB - 1) / kB;
  if (p.causal)  // no key past the tile's last query row is needed
    n_k = min(n_k, (min(q0 + kB, p.len_q) - 1) / kB + 1);

  // K and V of key tile t into stage t % 2
  auto load_k_tile = [&](int t) {
    const int s = t & 1;
    const uint32_t bar = kv_full + 8 * s;
    mbar_expect_tx(bar, 2 * kTile);
    for (int j = 0; j < kSub; ++j) {
      tma_load(k_s + s * kTile + j * kBoxBytes, p.k, j * kBox, t * kB, hk, b,
               bar);
      tma_load(v_s + s * kTile + j * kBoxBytes, p.v, j * kBox, t * kB, hk, b,
               bar);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    mbar_init(kv_full, 1);
    mbar_init(kv_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qd_full, 2 * kTile);
    for (int j = 0; j < kSub; ++j) {
      tma_load(q_s + j * kBoxBytes, p.q, j * kBox, q0, h, b, qd_full);
      tma_load(do_s + j * kBoxBytes, p.dout, j * kBox, q0, h, b, qd_full);
    }
    load_k_tile(0);
    if (n_k > 1) load_k_tile(1);
  }

  // A thread holds query rows row_a and row_a + 8 and, in every 8-column
  // chunk i of a fragment, columns 8 i + col_t and 8 i + col_t + 1 (keys
  // in S and dP, head-dim columns in dQ).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const long long row0 = (static_cast<long long>(b) * p.heads + h) *
                         p.len_q_pad;
  const float l2_a = p.lse2[row0 + row_a], l2_b = p.lse2[row0 + row_a + 8];
  const float d_a = p.delta[row0 + row_a], d_b = p.delta[row0 + row_a + 8];
  float dq[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dq[i] = 0.f;

  mbar_wait(qd_full, 0);
  for (int t = 0; t < n_k; ++t) {
    const int s = t & 1, k0 = t * kB;
    const uint32_t ks = k_s + s * kTile, vs = v_s + s * kTile;
    mbar_wait(kv_full + 8 * s, (t >> 1) & 1);

    // S = Q K^T and dP = dO V^T, one commit group each
    float sc[kB / 2], dp[kB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(sc, wgmma_desc(q_s + off, 16, 1024),
                   wgmma_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(dp, wgmma_desc(do_s + off, 16, 1024),
                   wgmma_desc(vs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S is in; dP may still run
    fence_regs<kB / 2>(sc);

    // P in place; keys past Sk and, under causal, keys past the query get 0
    const bool masked =
        k0 + kB > p.len_k || (p.causal && k0 + kB - 1 > q0);
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2f(fmaf(sc[4 * i + e], p.scale_log2,
                             -(e < 2 ? l2_a : l2_b)));
        if (masked) {
          const int kj = k0 + 8 * i + col_t + (e & 1);
          const int qi = e < 2 ? row_a : row_a + 8;
          if (kj >= p.len_k || (p.causal && kj > qi)) x = 0.f;
        }
        sc[4 * i + e] = x;
      }
    }
    wgmma_wait<0>();
    fence_regs<kB / 2>(dp);

    // dS = P o (dP - D), bf16 as the A operand, 16 keys a step
    uint32_t dsa[kB / 16][4];
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = sc[4 * i + e] * (dp[4 * i + e] - (e < 2 ? d_a : d_b));
      dsa[i >> 1][(i & 1) * 2] = pack_bf16(x[0], x[1]);
      dsa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }

    // dQ += dS K, with K as an MN-major B operand (scaled at the store)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kB / 16; ++j)
      wgmma_pv<NP>(dq, dsa[j],
                   wgmma_desc(ks + j * 16 * kRowBytes, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs<kB / 4>(&dsa[0][0]);
    fence_regs<NP / 2>(dq);
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && t + 2 < n_k) load_k_tile(t + 2);
  }

  __nv_bfloat16* dqg = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < NP / 8; ++i) {
    const int col = 8 * i + col_t;
    if (col >= p.head_dim) continue;
    if (row_a < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(dqg + row_a * p.sdq.s + col) =
          __floats2bfloat162_rn(dq[4 * i] * p.scale, dq[4 * i + 1] * p.scale);
    if (row_a + 8 < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (row_a + 8) * p.sdq.s + col) =
          __floats2bfloat162_rn(dq[4 * i + 2] * p.scale,
                                dq[4 * i + 3] * p.scale);
  }
}

template <int NP>
cudaError_t launch_bwd_bf16(const BParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.batch) * p.heads *
                         p.len_q_pad;
  flash_bwd_prep_kernel<<<static_cast<unsigned>((rows + 7) / 8), kThreads,
                          0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int bytes = bwd_smem_bytes<NP>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.heads, p.batch, (p.len_k + kB - 1) / kB);
  flash_bwd_dkdv_wgmma_kernel<NP><<<grid_kv, kWg, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.partial != nullptr) {
    const long long n = static_cast<long long>(p.batch) * p.kv_heads *
                        p.len_k * (p.head_dim / 2);
    flash_bwd_reduce_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                    kThreads),
                              kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(p.heads, p.batch, (p.len_q + kB - 1) / kB);
  flash_bwd_dq_wgmma_kernel<NP><<<grid_q, kWg, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, H, Sq, d) and k, v, dk, dv (B, Hkv, Sk, d) of one type,
// each addressed by its (batch, head, sequence) strides in elements, in
// this order in `strides` (a host array of 24): q, k, v, o, dout, dq, dk,
// dv. The last dim is contiguous. lse (the forward's) and delta (scratch
// the first launch fills) are contiguous (B, H, Sq) float32. The caller
// guarantees B, H, Hkv, Sq, Sk >= 1, H % Hkv == 0, d in {16, 32, 64, 80,
// 128}. Three launches on `stream`: D, then dK and dV, then dQ.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int batch, int heads, int kv_heads,
    int len_q, int len_k, int head_dim, int causal, float scale, int device,
    void* stream) {
  return run_bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                        batch, heads, kv_heads, len_q, len_k, head_dim,
                        causal, scale, device, stream);
}

// The same contract in bf16, with other scratch: `rows` is 2 B H Sq_pad
// float32 (Sq_pad = Sq rounded up to 64), `partial` 2 B H Sk d float32
// when H > Hkv (null when H = Hkv). Besides, q, k, v and dout are 16-byte
// aligned and each of their strides of a dim longer than 1 is a multiple
// of 8 elements (TMA's rule, checked by the wrapper). Returns the forward's
// error codes on a failed tensor-map encode. Four launches on `stream`
// (three when H = Hkv): LSE and D, dK and dV, their reduction, dQ.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* partial, void* dq,
    void* dk, void* dv, const long long* strides, int batch, int heads,
    int kv_heads, int len_q, int len_k, int head_dim, int causal,
    float scale, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (head_dim % 16 != 0 || head_dim < 16 || head_dim > 128 ||
      (heads != kv_heads && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BParams p;
  Strides sq, sk, sv;
  Strides* all[8] = {&sq, &sk, &sv, &p.so, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  int err = encode_view(&p.q, q, batch, heads, len_q, head_dim, sq, kB);
  if (err == 0)
    err = encode_view(&p.k, k, batch, kv_heads, len_k, head_dim, sk, kB);
  if (err == 0)
    err = encode_view(&p.v, v, batch, kv_heads, len_k, head_dim, sv, kB);
  if (err == 0)
    err = encode_view(&p.dout, dout, batch, heads, len_q, head_dim, p.sdo,
                      kB);
  if (err != 0) return err;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout_ptr = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.len_q_pad = (len_q + kB - 1) / kB * kB;
  p.lse2 = static_cast<float*>(rows);
  p.delta = p.lse2 + static_cast<long long>(batch) * heads * p.len_q_pad;
  p.partial = heads == kv_heads ? nullptr : static_cast<float*>(partial);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.head_dim = head_dim;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim <= 64 ? launch_bwd_bf16<64>(p, s)
                                         : launch_bwd_bf16<128>(p, s));
}
