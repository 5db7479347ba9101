// Block-sparse SpMM  Y = A @ X  for Hopper (sm_90a), float32 throughout.
//
// Replaces: src/repro/kernels/spmm_tile.py : spmm_blocksparse (Pallas body
// _spmm_kernel). The TPU kernel walked the block stream one block per
// sequential grid step and kept the output tile of the current block row
// resident in VMEM across the row.
//
// What bounds it on an H100: reading the dense blocks. With k = 4 columns
// each 64x64 block (16 KB) feeds 32 KFLOP, two operations per byte, far
// below both the float32 and the tensor-core ridge points. One matmat over
// the n = 2^20 R-MAT image reads 12.86 GB of blocks: about 3.8 ms at
// 3.35 TB/s.
//
// Design:
//   * one CTA per block row walks row_ptr[r] .. row_ptr[r+1] in order, so
//     each output element has one fixed order of summation (blocks in CSR
//     order, columns in order inside a block) and no atomics or
//     cross-CTA reduction are needed;
//   * a block is read with 16-byte coalesced loads into registers one
//     block ahead of the product (software pipelining: the next block's
//     loads are in flight while the current block is multiplied), then
//     stored to shared memory with a padded row stride (bn + 1) so the
//     threads of a warp that read different rows hit different banks;
//   * the (bn x k) slab of X at block_cols[j] is gathered one block ahead
//     too, from the same registers-then-shared-memory path;
//   * the (bm x k) outputs stay in registers for the whole row and are
//     written once; a block row with no blocks writes zeros, which does
//     the job of the reference's empty-row mask.
// Not done here: splitting the heaviest block rows over several CTAs with
// a fixed-order second reduction. On the R-MAT image one block row holds
// 7,635 blocks (125 MB) and runs on one SM.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 8;    // outputs per thread: bm * k <= 2048
constexpr int kMaxXVec = 4;   // X-slab floats per thread: bn * k <= 1024

template <int VEC>  // float4 loads per thread per block: bm*bn <= 1024*VEC
__global__ void __launch_bounds__(kThreads)
spmm_blocksparse_kernel(const float* __restrict__ blocks,
                        const int* __restrict__ block_cols,
                        const int* __restrict__ row_ptr,
                        const float* __restrict__ x,
                        float* __restrict__ y, int bm, int bn, int k) {
  extern __shared__ float smem[];
  const int ld = bn + 1;
  float* a_s = smem;                // bm rows of stride ld
  float* x_s = smem + bm * ld;      // bn x k, row-major
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int lo = row_ptr[r];
  const int hi = row_ptr[r + 1];
  const int blk_vec = (bm * bn) / 4;
  const int x_elems = bn * k;
  const int n_out = bm * k;

  float acc[kMaxOut];
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) acc[t] = 0.f;

  float4 a_pre[VEC];
  float x_pre[kMaxXVec];
  auto fetch = [&](int j) {
    const float4* blk = reinterpret_cast<const float4*>(
        blocks + static_cast<size_t>(j) * bm * bn);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int e4 = tid + v * kThreads;
      if (e4 < blk_vec) a_pre[v] = __ldg(blk + e4);
    }
    const float* xs = x + static_cast<size_t>(__ldg(block_cols + j)) * x_elems;
#pragma unroll
    for (int v = 0; v < kMaxXVec; ++v) {
      const int e = tid + v * kThreads;
      if (e < x_elems) x_pre[v] = __ldg(xs + e);
    }
  };

  if (lo < hi) fetch(lo);
  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the previous block's products are done with smem
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int e4 = tid + v * kThreads;
      if (e4 < blk_vec) {
        const int e = e4 * 4;           // bn % 4 == 0: the 4 share a row
        float* dst = a_s + (e / bn) * ld + (e % bn);
        dst[0] = a_pre[v].x;
        dst[1] = a_pre[v].y;
        dst[2] = a_pre[v].z;
        dst[3] = a_pre[v].w;
      }
    }
#pragma unroll
    for (int v = 0; v < kMaxXVec; ++v) {
      const int e = tid + v * kThreads;
      if (e < x_elems) x_s[e] = x_pre[v];
    }
    __syncthreads();
    if (j + 1 < hi) fetch(j + 1);  // in flight during this block's product
#pragma unroll
    for (int t = 0; t < kMaxOut; ++t) {
      const int o = tid + t * kThreads;
      if (o < n_out) {
        const int i = o / k;
        const int q = o - i * k;
        const float* arow = a_s + i * ld;
        float s = acc[t];
        for (int c = 0; c < bn; ++c) s = fmaf(arow[c], x_s[c * k + q], s);
        acc[t] = s;
      }
    }
  }

  float* yr = y + static_cast<size_t>(r) * n_out;
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) {
    const int o = tid + t * kThreads;
    if (o < n_out) yr[o] = acc[t];
  }
}

template <int VEC>
cudaError_t launch(const float* blocks, const int* block_cols,
                   const int* row_ptr, const float* x, float* y,
                   int n_block_rows, int bm, int bn, int k,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bm * (bn + 1) + bn * k) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_blocksparse_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  spmm_blocksparse_kernel<VEC><<<n_block_rows, kThreads, smem, stream>>>(
      blocks, block_cols, row_ptr, x, y, bm, bn, k);
  return cudaGetLastError();
}

}  // namespace

// Shape limits the caller checks first: bn % 4 == 0, bm * bn <= 4096,
// bm * k <= 2048, bn * k <= 1024; blocks and x 16-byte aligned.
extern "C" int repro_spmm_blocksparse_f32(const float* blocks,
                                          const int* block_cols,
                                          const int* row_ptr, const float* x,
                                          float* y, int n_block_rows, int bm,
                                          int bn, int k, int device,
                                          void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int vec = (bm * bn / 4 + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec <= 1)
    err = launch<1>(blocks, block_cols, row_ptr, x, y, n_block_rows, bm, bn, k, s);
  else if (vec <= 2)
    err = launch<2>(blocks, block_cols, row_ptr, x, y, n_block_rows, bm, bn, k, s);
  else if (vec <= 4)
    err = launch<4>(blocks, block_cols, row_ptr, x, y, n_block_rows, bm, bn, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
