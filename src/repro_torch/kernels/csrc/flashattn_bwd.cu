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
// This first design runs on the CUDA cores in float32 (the bf16 inputs are
// widened exactly), as three launches on the caller's stream:
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
//     recomputing S and dP (the two extra products of this design) and
//     adding dS K into dQ in registers.
// No atomics anywhere: every sum is one thread's loop in a fixed order
// (or a fixed shuffle tree), so the gradients are bit-identical run to
// run. That costs the recomputation of S and dP in the dQ kernel:
// 7 products where an atomic dQ (FlashAttention-2) needs 5.
//
// Layout of a CTA (256 threads as 16 x 16, tx = tid % 16, ty = tid / 16):
// a thread owns 4 consecutive rows 4 ty .. 4 ty + 3 of a 64 x 64 score
// tile and the columns tx + 16 j (j < 4); of a 64 x d accumulator the same
// rows and the columns tx + 16 c (c < d / 16). Matrices read 4 rows at a
// time are stored with rows of 68 floats (float4 loads), those read one
// column per thread with rows of 65 (conflict-free both along and across
// rows). Masked and out-of-range entries of P and dS are 0; rows and keys
// past Sq and Sk are staged as zeros and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Strides {
  long long b, h, s;
};

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
__device__ __forceinline__ void st_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
  const T* og = p.o + b * p.so.b + h * p.so.h + qi * p.so.s;
  const T* dg = p.dout + b * p.sdo.b + h * p.sdo.h + qi * p.sdo.s;
  float acc = 0.f;
  for (int c = lane; c < p.head_dim; c += 32)
    acc = fmaf(ld_f(og + c), ld_f(dg + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
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

extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int batch, int heads, int kv_heads,
    int len_q, int len_k, int head_dim, int causal, float scale, int device,
    void* stream) {
  return run_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                strides, batch, heads, kv_heads, len_q,
                                len_k, head_dim, causal, scale, device,
                                stream);
}
