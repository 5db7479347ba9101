// Gram / projection  G = alpha * A^T @ B  for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/gram.py : gram (Pallas body _gram_kernel),
// which streamed row intervals through one TPU core and accumulated the
// (m x b) result in VMEM across sequential grid steps.
//
// What bounds it on an H100: reading A and B. On the eigensolver's path A
// and B are (2^20 x 4) float32, 32 MB together, about 10 us at 3.35 TB/s,
// for a (4 x 4) result; launch latency is of the same order.
//
// Design (the paper's §3.4.2 per-row-interval partial plus aggregate):
//   * launch 1: CTA x takes one contiguous row interval, grid.y tiles the
//     m*b outputs in chunks of 64; each thread keeps its chunk's partial
//     sums in registers over a fixed stride of rows, then the CTA reduces
//     them in a fixed order (warp shuffle tree, then warps in index
//     order) and writes one (chunk) partial per row interval to scratch;
//   * launch 2: one CTA per output element sums the row-interval partials
//     in index order (fixed strides, then the same fixed tree) and scales
//     by alpha once.
// No atomics: the order of every sum depends only on n, m and b, so a
// result is bit-identical from run to run. Ragged n is handled by the
// last interval; there is no divisibility rule on n.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // output elements per CTA along grid.y

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ partials, long long n, int m, int bc,
                    long long rows_per_part) {
  __shared__ float warp_part[kWarps][kChunk];
  const int mb = m * bc;
  const int e0 = blockIdx.y * kChunk;
  const int cnt = min(kChunk, mb - e0);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long r1 = min(n, r0 + rows_per_part);

  float acc[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) acc[e] = 0.f;
  for (long long i = r0 + threadIdx.x; i < r1; i += kThreads) {
    const float* ar = a + i * m;
    const float* br = b + i * bc;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      if (e < cnt) {
        const int ee = e0 + e;
        const int p = ee / bc;
        acc[e] = fmaf(__ldg(ar + p), __ldg(br + (ee - p * bc)), acc[e]);
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
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
    partials[static_cast<size_t>(blockIdx.x) * mb + e0 + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                   int n_parts, int mb, float alpha) {
  __shared__ float warp_part[kWarps];
  const int e = blockIdx.x;
  float s = 0.f;
  for (int p = threadIdx.x; p < n_parts; p += kThreads)
    s += partials[static_cast<size_t>(p) * mb + e];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_part[w];
    out[e] = alpha * t;
  }
}

}  // namespace

// a (n, m) and b (n, bc) row-major; partials holds n_parts * m * bc
// floats of scratch; out is (m, bc). The caller guarantees n > 0,
// m * bc > 0 and n_parts * rows_per_part >= n.
extern "C" int repro_gram_f32(const float* a, const float* b, float* partials,
                              float* out, long long n, int m, int bc,
                              int n_parts, long long rows_per_part,
                              float alpha, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mb = m * bc;
  const dim3 grid(n_parts, (mb + kChunk - 1) / kChunk);
  gram_partial_kernel<<<grid, kThreads, 0, s>>>(a, b, partials, n, m, bc,
                                                rows_per_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<mb, kThreads, 0, s>>>(partials, out, n_parts, mb,
                                             alpha);
  return static_cast<int>(cudaGetLastError());
}
