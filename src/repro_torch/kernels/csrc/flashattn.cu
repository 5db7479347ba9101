// Flash attention (online softmax) for Hopper (sm_90a): float32 or bf16
// in, float32 arithmetic, output in the input type.
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
// peak, while Q, K, V and O are 151 MB, 0.045 ms at 3.35 TB/s. This kernel
// runs its products on the CUDA cores in float32 (67 TFLOP/s peak), so it
// sits far above that bound; wgmma, TMA and warp specialisation are later
// work.
//
// Design:
//   * grid (query tile, head, batch); query tiles are launched heaviest
//     first, so the long causal rows do not trail the launch. Each CTA
//     walks its KV tiles in order in a loop of its own, which takes the
//     place of the TPU's sequential grid axis; under `causal` the loop
//     stops at the diagonal tile (the TPU kernel's pl.when skip).
//   * 64 query rows by 64 keys per step, 256 threads as a 16 x 16 grid:
//     a thread owns 4 query rows and 4 score columns (tx + 16 j), and the
//     same 4 rows by d/16 output columns (tx + 16 c). The Q tile (once),
//     then the K tile (transposed), then the V tile (same buffer) and the
//     weights P (transposed) are staged in shared memory as float32.
//   * grouped-query attention in the kernel: head h reads KV head
//     h / (H / Hkv); K and V are never repeated in memory.
//   * strides in elements for batch, head and sequence (the last dim is
//     contiguous), so callers pass views of (B, S, H, d) projections.
//   * ragged Sq and Sk: rows past Sq are not stored, keys past Sk are
//     masked; no divisibility rule on either.
//   * numerics as the TPU kernel: s = (q.k) * scale in float32, masked
//     entries -1e30, running max / denominator / accumulator in float32,
//     P stays float32 into the PV product, denominator floored at 1e-30.
//     No atomics: each sum runs in a fixed order (per-thread loops and a
//     fixed shuffle tree over the 16 threads of a row), so the result is
//     bit-identical from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per step
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = 4;         // query rows per thread: 4 ty .. 4 ty + 3
constexpr int kCols = kBK / 16;  // score columns per thread: tx + 16 j
constexpr int kQPad = kBQ + 4;   // row length of Q^T and P^T (float4 reads)
constexpr int kKPad = kBK + 1;   // row length of K^T (conflict-free stores)
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int batch, heads, kv_heads, len_q, len_k, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Sum over the 16 lanes of a row group in a fixed tree; every lane of the
// group gets lane 0's result, so all agree to the bit.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_down_sync(0xffffffffu, v, 8, 16);
  v += __shfl_down_sync(0xffffffffu, v, 4, 16);
  v += __shfl_down_sync(0xffffffffu, v, 2, 16);
  v += __shfl_down_sync(0xffffffffu, v, 1, 16);
  return __shfl_sync(0xffffffffu, v, 0, 16);
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int D>
constexpr int smem_floats() {
  return D * kQPad + D * kKPad + kBK * kQPad;
}

// Stage rows [r0, r0 + 64) of a (len, D) matrix as float32, zeros past
// len: transposed to dst[c * ld + r] or row-major dst[r * D + c].
template <typename T, int D, bool kTranspose>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long stride, int r0, int len) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    const float x = g < len ? to_f32(src[g * stride + c]) : 0.f;
    if (kTranspose)
      dst[c * ld + r] = x;
    else
      dst[r * D + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  static_assert(D % 16 == 0 && D >= 16, "head dim");
  constexpr int kOut = D / 16;  // output columns per thread
  extern __shared__ float4 smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [D][kQPad]  Q^T
  float* kv = qt + D * kQPad;  // [D][kKPad] K^T, then [kBK][D] V
  float* pt = kv + D * kKPad;  // [kBK][kQPad] P^T

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  T* og = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  stage<T, D, true>(qt, kQPad, qg, p.sq.s, q0, p.len_q);

  float acc[kRows][kOut];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (p.len_k + kBK - 1) / kBK;
  if (p.causal) {  // no key past the tile's last query row is needed
    const int last_q = min(q0 + kBQ, p.len_q) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous step's V and P are consumed
    stage<T, D, true>(kv, kKPad, kg, p.sk.s, k0, p.len_k);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(qt + d * kQPad + ty * kRows);
      const float qr[kRows] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kk = kv[d * kKPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] = fmaf(qr[i], kk, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (kj >= p.len_k || (p.causal && kj > qi)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        pt[(tx + 16 * j) * kQPad + ty * kRows + i] = e;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K consumed, P stored
    stage<T, D, false>(kv, D, vg, p.sv.s, k0, p.len_k);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pv =
          *reinterpret_cast<const float4*>(pt + j * kQPad + ty * kRows);
      const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = kv[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= p.len_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      og[qi * p.so.s + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.len_q + kBQ - 1) / kBQ, p.heads, p.batch);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o,
        const long long* strides, int batch, int heads, int kv_heads,
        int len_q, int len_k, int head_dim, int causal, float scale,
        int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  Strides* all[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1],
                      strides[3 * i + 2]};
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<T, 16>(p, s));
    case 32: return static_cast<int>(launch<T, 32>(p, s));
    case 64: return static_cast<int>(launch<T, 64>(p, s));
    case 128: return static_cast<int>(launch<T, 128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, Sq, d), k/v (B, Hkv, Sk, d), o (B, H, Sq, d) of one type, each
// addressed by its (batch, head, sequence) strides in elements, in this
// order in `strides` (a host array of 12): q, k, v, o. The last dim is
// contiguous. The caller guarantees B, H, Hkv, Sq, Sk >= 1, H % Hkv == 0.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides, int batch,
                                         int heads, int kv_heads, int len_q,
                                         int len_k, int head_dim, int causal,
                                         float scale, int device,
                                         void* stream) {
  return run<float>(q, k, v, o, strides, batch, heads, kv_heads, len_q,
                    len_k, head_dim, causal, scale, device, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* strides, int batch,
                                          int heads, int kv_heads, int len_q,
                                          int len_k, int head_dim, int causal,
                                          float scale, int device,
                                          void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, strides, batch, heads, kv_heads,
                            len_q, len_k, head_dim, causal, scale, device,
                            stream);
}
