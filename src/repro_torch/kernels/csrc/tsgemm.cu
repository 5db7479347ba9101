// Tall-skinny GEMM  C = alpha * A @ B + beta * C0  for Hopper (sm_90a),
// float32 throughout.
//
// Replaces: src/repro/kernels/tsgemm.py : tsgemm (Pallas body
// _tsgemm_kernel), which streamed row intervals of A and C0 through VMEM
// with B resident.
//
// What bounds it on an H100: memory traffic, (n*m + m*b + 2*n*b) * 4
// bytes at 3.35 TB/s for 2*m flops per output. Krylov-Schur calls it
// with A (2^20 x 4) and B (4 x 4) (project-out, compress) or (4 x 8)
// (Ritz vectors): 50 MB at (4, 4), 15 us. LOBPCG (b = 8) calls it at
// (8, 8), 100 MB, 30 us; the SVD (b = 2) at (2, 2), 25 MB, 7.5 us.
//
// Design: one launch, a grid that covers n; the wrapper (tsgemm.py:
// variant) names the kernel and this file launches it or refuses it.
// Every CTA copies B into shared memory, and each thread reads it into
// registers.
//   * vec<M>x<B>, (4, 4), (4, 8) and (8, 8): one thread per row of C; a
//     row of A is one or two float4 loads, a row of C0 one or two float4
//     loads and a row of C one or two float4 stores, neighbouring threads
//     on neighbouring rows; the row index is the thread's global index,
//     with no division. At (8, 8) a thread holds 24 floats of rows.
//   * pair2x2, (2, 2): a row is 8 bytes, so each thread takes two
//     neighbouring rows and moves A, C0 and C as one float4 each; an odd
//     last row moves as float2s.
//   * generic, any other (m, b) with B up to 48 KB, and any A, C0 or C off
//     a 16-byte boundary: the same thread-per-row walk with scalar loads
//     and stores.
// Arithmetic, kept from the first version of this kernel so that every C
// element keeps its bits: for each output the m-term dot product is an
// fmaf chain in index order from 0, then fmaf(beta, C0, alpha * s) with
// alpha * s rounded first, which is what nvcc made of that version's
// `out = alpha * s; out += beta * c0`. Every kernel below spells it with
// intrinsics (`epilogue`), so no contraction choice of the compiler can
// change it (left to nvcc, the float4 kernel contracted the other product
// and rounded many elements differently), and every variant gives the
// generic kernel's bits. No reductions across threads, so no atomics.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Variant ids, the same numbers as tsgemm.VARIANTS
constexpr int kGeneric = 0, kVec4x4 = 1, kVec4x8 = 2, kVec8x8 = 3,
              kPair2x2 = 4;

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

// (2, 2): thread i takes rows 2i and 2i + 1
__global__ void __launch_bounds__(kThreads)
tsgemm_pair2_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c0, float* __restrict__ c,
                    long long n, float alpha, float beta) {
  __shared__ float b_s[4];
  if (threadIdx.x < 4) b_s[threadIdx.x] = b[threadIdx.x];
  __syncthreads();
  const long long r = 2 * (static_cast<long long>(blockIdx.x) * kThreads +
                           threadIdx.x);
  if (r >= n) return;
  const float b00 = b_s[0], b01 = b_s[1], b10 = b_s[2], b11 = b_s[3];
  // one row: the fmaf chains of the generic kernel, then its epilogue
  const auto row = [&](float a0, float a1, const float* cr, float* o) {
    o[0] = epilogue(fmaf(a1, b10, fmaf(a0, b00, 0.f)), alpha, beta, cr);
    o[1] = epilogue(fmaf(a1, b11, fmaf(a0, b01, 0.f)), alpha, beta,
                    cr == nullptr ? nullptr : cr + 1);
  };
  if (r + 1 < n) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(a + 2 * r));
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 != nullptr) u = __ldg(reinterpret_cast<const float4*>(c0 + 2 * r));
    const float cr[4] = {u.x, u.y, u.z, u.w};
    float o[4];
    row(t.x, t.y, c0 == nullptr ? nullptr : cr, o);
    row(t.z, t.w, c0 == nullptr ? nullptr : cr + 2, o + 2);
    *reinterpret_cast<float4*>(c + 2 * r) = make_float4(o[0], o[1], o[2],
                                                        o[3]);
  } else {  // the odd last row
    const float2 t = __ldg(reinterpret_cast<const float2*>(a + 2 * r));
    float2 u = make_float2(0.f, 0.f);
    if (c0 != nullptr) u = __ldg(reinterpret_cast<const float2*>(c0 + 2 * r));
    const float cr[2] = {u.x, u.y};
    float o[2];
    row(t.x, t.y, c0 == nullptr ? nullptr : cr, o);
    *reinterpret_cast<float2*>(c + 2 * r) = make_float2(o[0], o[1]);
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
// 256 threads per 256 rows, or per 512 at (2, 2) (n below 2^31 * 256).
// `variant` (tsgemm.VARIANTS) names the kernel; one whose width or
// alignment does not fit the call is refused with cudaErrorInvalidValue
// and nothing is launched.
extern "C" int repro_tsgemm_f32(const float* a, const float* b,
                                const float* c0, float* c, long long n, int m,
                                int bc, float alpha, float beta, int variant,
                                int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(a) |
                         reinterpret_cast<std::uintptr_t>(c0) |
                         reinterpret_cast<std::uintptr_t>(c)) & 15) == 0;
  const auto fits = [&](int want_m, int want_b) {
    return aligned && m == want_m && bc == want_b;
  };
  switch (variant) {
    case kGeneric: {
      const size_t smem = static_cast<size_t>(m) * bc * sizeof(float);
      tsgemm_kernel<<<blocks, kThreads, smem, s>>>(a, b, c0, c, n, m, bc,
                                                   alpha, beta);
      return static_cast<int>(cudaGetLastError());
    }
    case kVec4x4:
      if (!fits(4, 4)) break;
      launch_vec<4, 4>(a, b, c0, c, n, alpha, beta, blocks, s);
      return static_cast<int>(cudaGetLastError());
    case kVec4x8:
      if (!fits(4, 8)) break;
      launch_vec<4, 8>(a, b, c0, c, n, alpha, beta, blocks, s);
      return static_cast<int>(cudaGetLastError());
    case kVec8x8:
      if (!fits(8, 8)) break;
      launch_vec<8, 8>(a, b, c0, c, n, alpha, beta, blocks, s);
      return static_cast<int>(cudaGetLastError());
    case kPair2x2: {
      if (!fits(2, 2)) break;
      const long long pairs = (n + 1) / 2;
      tsgemm_pair2_kernel<<<static_cast<unsigned int>(
                                (pairs + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(a, b, c0, c, n, alpha, beta);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
