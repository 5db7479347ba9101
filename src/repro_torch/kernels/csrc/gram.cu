// Gram / projection  G = alpha * A^T @ B  for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/gram.py : gram (Pallas body _gram_kernel),
// which streamed row intervals through one TPU core and accumulated the
// (m x b) result in VMEM across sequential grid steps.
//
// What bounds it on an H100: reading A and B. On the eigensolver's path
// every call is (m, b) = (4, 4): A and B are (2^20 x 4) float32, 32 MB
// together, 10 us at 3.35 TB/s, for a (4 x 4) result.
//
// Design: one launch per call.
//   * Rows are cut into n_parts contiguous intervals (gram.row_partition:
//     a function of n alone), one CTA each; for an (m, b) outside the
//     compiled widths, grid.y tiles the m*b outputs in chunks of 16.
//   * Compiled widths, (4, 4) (the solver's only shape): a row of A and
//     a row of B are one float4 each; neighbouring threads take
//     neighbouring rows, kUnroll rows per thread are loaded before any is
//     used, and each thread keeps its 16 sums in registers. Any other
//     (m, b): the same walk with scalar loads, the (p, q) of each of the
//     chunk's outputs computed once before the row loop.
//   * Each CTA reduces its threads' sums in a fixed order (warp shuffle
//     tree, then the warps in index order) into its partial in scratch.
//   * Cross-CTA reduction in the same launch by a last-CTA ticket: each
//     CTA fences its partial and draws a ticket from an integer counter
//     (atomicAdd on an unsigned int, the only atomic here); the CTA that
//     draws the last ticket sums the partials in a fixed order (16
//     interleaved strands of parts per output, then the strands in
//     index order), scales by alpha once, and sets the counter back to 0.
//     A ticket rather than a cooperative launch: the grid may exceed what
//     is co-resident, and a grid-wide sync would pin the partition to the
//     card's SM count. The counter is one int per (device, stream), held
//     by the wrapper (gram.py); launches on one stream run in order, so
//     the next call finds it at 0, and two streams never share one.
// No float atomics: every sum's order depends on n, m and b only, so G is
// bit-identical from run to run on any card. Ragged n is handled by the
// last interval; there is no divisibility rule on n.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // outputs per CTA of the generic kernel
constexpr int kUnroll = 4;  // rows in flight per thread (compiled widths)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The CTA's N sums (acc) of which the first cnt are live, reduced in a
// fixed order and written to part[0..cnt).
template <int N>
__device__ __forceinline__ void cta_reduce(const float (&acc)[N], int cnt,
                                           float* part) {
  __shared__ float warp_part[kWarps][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e < cnt) {  // cnt is uniform over the CTA: all lanes shuffle
      const float v = warp_sum(acc[e]);
      if (lane == 0) warp_part[warp][e] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < cnt) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    part[threadIdx.x] = s;
  }
}

// After the CTA's partial is written: draw a ticket; the CTA with the last
// one returns true, once every other CTA's partial is visible to it.
__device__ __forceinline__ bool last_cta(unsigned int* counter) {
  __shared__ bool is_last;
  __threadfence();  // this CTA's partial before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int total = gridDim.x * gridDim.y;
    is_last = atomicAdd(counter, 1u) == total - 1;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// In the last CTA: out[e] = alpha * sum over parts p of partials[p][e].
// Thread t sums strand s = t / mb of output e = t % mb (parts s, s + S,
// s + 2S, ..., S = kThreads / mb strands), then the strands are added in
// index order. Loads bypass L1 (the partials were written by other SMs).
__device__ void final_reduce(const float* partials, int n_parts, int mb,
                             float alpha, float* out,
                             unsigned int* counter) {
  __shared__ float strand[kThreads];
  const int S = mb < kThreads ? kThreads / mb : 1;
  for (int e0 = 0; e0 < mb; e0 += kThreads / S) {
    const int t = threadIdx.x;
    const int e = e0 + t % (kThreads / S);
    const int s = t / (kThreads / S);
    float v = 0.f;
    if (s < S && e < mb) {
#pragma unroll 8
      for (int p = s; p < n_parts; p += S)
        v += __ldcg(partials + static_cast<size_t>(p) * mb + e);
    }
    strand[t] = v;
    __syncthreads();
    if (t < kThreads / S && e < mb) {
      float total = 0.f;
      for (int k = 0; k < S; ++k) total += strand[k * (kThreads / S) + t];
      out[e] = alpha * total;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next call
}

// Compiled widths: M and B multiples of 4, rows read as float4s.
template <int M, int B>
__global__ void __launch_bounds__(kThreads)
gram_vec_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                float* __restrict__ partials, float* __restrict__ out,
                unsigned int* __restrict__ counter, long long n,
                long long rows_per_part, float alpha) {
  static_assert(M % 4 == 0 && B % 4 == 0, "rows are float4s");
  constexpr int MV = M / 4;
  constexpr int BV = B / 4;
  constexpr int MB = M * B;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long r1 = min(n, r0 + rows_per_part);

  float acc[MB];
#pragma unroll
  for (int e = 0; e < MB; ++e) acc[e] = 0.f;
  for (long long base = r0 + threadIdx.x; base < r1;
       base += kThreads * kUnroll) {
    float ar[kUnroll][M];
    float br[kUnroll][B];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      const bool live = i < r1;
#pragma unroll
      for (int v = 0; v < MV; ++v) {
        const float4 t = live ? __ldg(a + i * MV + v)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        ar[u][4 * v] = t.x;
        ar[u][4 * v + 1] = t.y;
        ar[u][4 * v + 2] = t.z;
        ar[u][4 * v + 3] = t.w;
      }
#pragma unroll
      for (int v = 0; v < BV; ++v) {
        const float4 t = live ? __ldg(b + i * BV + v)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        br[u][4 * v] = t.x;
        br[u][4 * v + 1] = t.y;
        br[u][4 * v + 2] = t.z;
        br[u][4 * v + 3] = t.w;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int p = 0; p < M; ++p)
#pragma unroll
        for (int q = 0; q < B; ++q)
          acc[p * B + q] = fmaf(ar[u][p], br[u][q], acc[p * B + q]);
  }
  cta_reduce<MB>(acc, MB, partials + static_cast<size_t>(blockIdx.x) * MB);
  if (last_cta(counter))
    final_reduce(partials, gridDim.x, MB, alpha, out, counter);
}

// Any (m, b): CTA (x, y) takes row interval x and outputs
// [16 y, 16 y + 16) of the m*b, row-major.
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ partials, float* __restrict__ out,
            unsigned int* __restrict__ counter, long long n, int m, int bc,
            long long rows_per_part, float alpha) {
  const int mb = m * bc;
  const int e0 = blockIdx.y * kChunk;
  const int cnt = min(kChunk, mb - e0);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long r1 = min(n, r0 + rows_per_part);

  int ap[kChunk];
  int bq[kChunk];
  float acc[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    const int ee = min(e0 + e, mb - 1);
    ap[e] = ee / bc;
    bq[e] = ee - ap[e] * bc;
    acc[e] = 0.f;
  }
  for (long long i = r0 + threadIdx.x; i < r1; i += kThreads) {
    const float* ar = a + i * m;
    const float* br = b + i * bc;
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < cnt) acc[e] = fmaf(__ldg(ar + ap[e]), __ldg(br + bq[e]), acc[e]);
  }
  cta_reduce<kChunk>(acc, cnt,
                     partials + static_cast<size_t>(blockIdx.x) * mb + e0);
  if (last_cta(counter))
    final_reduce(partials, gridDim.x, mb, alpha, out, counter);
}

}  // namespace

// a (n, m) and b (n, bc) row-major; partials holds n_parts * m * bc floats
// of scratch; counter is an unsigned int at 0, owned by this stream; out
// is (m, bc). The caller guarantees n > 0, m * bc > 0 and
// n_parts * rows_per_part >= n.
extern "C" int repro_gram_f32(const float* a, const float* b, float* partials,
                              unsigned int* counter, float* out, long long n,
                              int m, int bc, int n_parts,
                              long long rows_per_part, float alpha,
                              int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(a) |
        reinterpret_cast<std::uintptr_t>(b)) & 15) == 0;
  if (aligned && m == 4 && bc == 4) {
    gram_vec_kernel<4, 4><<<n_parts, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
        partials, out, counter, n, rows_per_part, alpha);
  } else {
    const dim3 grid(n_parts, (m * bc + kChunk - 1) / kChunk);
    gram_kernel<<<grid, kThreads, 0, s>>>(a, b, partials, out, counter, n, m,
                                          bc, rows_per_part, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
