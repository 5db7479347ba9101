// Tall-skinny GEMM  C = alpha * A @ B + beta * C0  for Hopper (sm_90a),
// float32 throughout.
//
// Replaces: src/repro/kernels/tsgemm.py : tsgemm (Pallas body
// _tsgemm_kernel), which streamed row intervals of A and C0 through VMEM
// with B resident.
//
// What bounds it on an H100: memory traffic. On the eigensolver's path A
// is (2^20 x 4), B (4 x 4) or (4 x 8), C0 and C (2^20 x 4 or 8): about
// 48 MB moved for 2*m flops per output, about 14 us at 3.35 TB/s.
//
// Design: every CTA copies B (m*b floats) into shared memory once; each
// thread then produces whole output elements C[i, q] over a grid-stride
// loop. Neighbouring threads take neighbouring (i, q), so the writes of C
// and reads of C0 are coalesced and the reads of a row of A are shared
// by the b threads that need it. The m-term dot product runs in index
// order; beta * C0 is added after alpha scales it, as in the Pallas body.
// No reductions across threads, so no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tsgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c0, float* __restrict__ c,
              long long n, int m, int bc, float alpha, float beta) {
  extern __shared__ float b_s[];
  for (int e = threadIdx.x; e < m * bc; e += kThreads) b_s[e] = b[e];
  __syncthreads();
  const long long total = n * bc;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / bc;
    const int q = static_cast<int>(idx - i * bc);
    const float* ar = a + i * m;
    float s = 0.f;
    for (int p = 0; p < m; ++p) s = fmaf(__ldg(ar + p), b_s[p * bc + q], s);
    float out = alpha * s;
    if (c0 != nullptr) out += beta * __ldg(c0 + idx);
    c[idx] = out;
  }
}

}  // namespace

// a (n, m), b (m, bc), c0 (n, bc) or null, c (n, bc); all row-major. The
// caller guarantees n * bc > 0 and m * bc * 4 bytes <= 48 KB.
extern "C" int repro_tsgemm_f32(const float* a, const float* b,
                                const float* c0, float* c, long long n, int m,
                                int bc, float alpha, float beta,
                                int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  int sms = 0;
  const cudaError_t attr_err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  const long long total = n * bc;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 16LL * sms;  // grid-stride beyond 16 CTAs per SM
  if (blocks > cap) blocks = cap;
  const size_t smem = static_cast<size_t>(m) * bc * sizeof(float);
  tsgemm_kernel<<<static_cast<int>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(a, b, c0, c, n, m, bc,
                                                       alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
