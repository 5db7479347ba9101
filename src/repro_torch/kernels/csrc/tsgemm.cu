// Tall-skinny GEMM  C = alpha * A @ B + beta * C0  for Hopper (sm_90a),
// float32 throughout.
//
// Replaces: src/repro/kernels/tsgemm.py : tsgemm (Pallas body
// _tsgemm_kernel), which streamed row intervals of A and C0 through VMEM
// with B resident.
//
// What bounds it on an H100: memory traffic. On the eigensolver's path A
// is (2^20 x 4) and B (4 x 4) (project-out, compress) or (4 x 8) (Ritz
// vectors), C0 and C (2^20 x 4 or 8): 50 MB moved at (4, 4) for 2*m flops
// per output, 15 us at 3.35 TB/s.
//
// Design: one thread per row of C, one launch, a grid that covers n.
// Every CTA copies B into shared memory, and each thread reads it into
// registers. For the compiled widths, (m, b) = (4, 4) and (4, 8), a row
// of A is one float4 load, a row of C0 one or two float4 loads and a row
// of C one or two float4 stores, neighbouring threads on neighbouring
// rows; the row index is the thread's global index, with no division.
// Any other (m, b), with B up to 48 KB: the same thread-per-row walk with
// scalar loads and stores.
// Arithmetic, kept from the first version of this kernel so that every C
// element keeps its bits: for each output the m-term dot product is an
// fmaf chain in index order from 0, then fmaf(beta, C0, alpha * s) with
// alpha * s rounded first, which is what nvcc made of that version's
// `out = alpha * s; out += beta * c0`. Both kernels below spell it with
// intrinsics (`epilogue`), so no contraction choice of the compiler can
// change it (left to nvcc, the float4 kernel contracted the other product
// and rounded many elements differently). No reductions across threads,
// so no atomics.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// alpha * s + beta * c0 as the first version rounded it
__device__ __forceinline__ float epilogue(float s, float alpha, float beta,
                                          const float* c0) {
  const float out = __fmul_rn(alpha, s);
  return c0 == nullptr ? out : __fmaf_rn(beta, *c0, out);
}

template <int M, int B>
__global__ void __launch_bounds__(kThreads)
tsgemm_vec_kernel(const float4* __restrict__ a, const float* __restrict__ b,
                  const float4* __restrict__ c0, float4* __restrict__ c,
                  long long n, float alpha, float beta) {
  static_assert(M % 4 == 0 && B % 4 == 0, "rows are float4s");
  constexpr int MV = M / 4;
  constexpr int BV = B / 4;
  __shared__ float b_s[M * B];
  for (int e = threadIdx.x; e < M * B; e += kThreads) b_s[e] = b[e];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  float ar[M];
#pragma unroll
  for (int v = 0; v < MV; ++v) {
    const float4 t = __ldg(a + i * MV + v);
    ar[4 * v] = t.x;
    ar[4 * v + 1] = t.y;
    ar[4 * v + 2] = t.z;
    ar[4 * v + 3] = t.w;
  }
  float cr[B];
  if (c0 != nullptr) {
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const float4 t = __ldg(c0 + i * BV + v);
      cr[4 * v] = t.x;
      cr[4 * v + 1] = t.y;
      cr[4 * v + 2] = t.z;
      cr[4 * v + 3] = t.w;
    }
  }
  float o[B];
#pragma unroll
  for (int q = 0; q < B; ++q) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < M; ++p) s = fmaf(ar[p], b_s[p * B + q], s);
    o[q] = epilogue(s, alpha, beta, c0 == nullptr ? nullptr : cr + q);
  }
#pragma unroll
  for (int v = 0; v < BV; ++v)
    c[i * BV + v] = make_float4(o[4 * v], o[4 * v + 1], o[4 * v + 2],
                                o[4 * v + 3]);
}

__global__ void __launch_bounds__(kThreads)
tsgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c0, float* __restrict__ c,
              long long n, int m, int bc, float alpha, float beta) {
  extern __shared__ float b_s[];
  for (int e = threadIdx.x; e < m * bc; e += kThreads) b_s[e] = b[e];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const float* ar = a + i * m;
  for (int q = 0; q < bc; ++q) {
    float s = 0.f;
    for (int p = 0; p < m; ++p) s = fmaf(__ldg(ar + p), b_s[p * bc + q], s);
    c[i * bc + q] = epilogue(s, alpha, beta,
                             c0 == nullptr ? nullptr : c0 + i * bc + q);
  }
}

template <int M, int B>
void launch_vec(const float* a, const float* b, const float* c0, float* c,
                long long n, float alpha, float beta, unsigned int blocks,
                cudaStream_t s) {
  tsgemm_vec_kernel<M, B><<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(a), b,
      reinterpret_cast<const float4*>(c0), reinterpret_cast<float4*>(c), n,
      alpha, beta);
}

}  // namespace

// a (n, m), b (m, bc), c0 (n, bc) or null, c (n, bc); all row-major. The
// caller guarantees n * bc > 0 and m * bc * 4 bytes <= 48 KB; one CTA of
// 256 threads per 256 rows (n below 2^31 * 256).
extern "C" int repro_tsgemm_f32(const float* a, const float* b,
                                const float* c0, float* c, long long n, int m,
                                int bc, float alpha, float beta,
                                int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(a) |
                         reinterpret_cast<std::uintptr_t>(c0) |
                         reinterpret_cast<std::uintptr_t>(c)) & 15) == 0;
  if (aligned && m == 4 && bc == 4) {
    launch_vec<4, 4>(a, b, c0, c, n, alpha, beta, blocks, s);
  } else if (aligned && m == 4 && bc == 8) {
    launch_vec<4, 8>(a, b, c0, c, n, alpha, beta, blocks, s);
  } else {
    const size_t smem = static_cast<size_t>(m) * bc * sizeof(float);
    tsgemm_kernel<<<blocks, kThreads, smem, s>>>(a, b, c0, c, n, m, bc,
                                                 alpha, beta);
  }
  return static_cast<int>(cudaGetLastError());
}
