// Block-sparse SpMM  Y = A @ X  for Hopper (sm_90a): blocks in float32 or
// bf16, X and Y in float32, every product and sum in float32.
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
// 3.35 TB/s. What kept the first design (one CTA per block row) far from
// that was skew, not bytes: the image's heaviest block row holds 7,635
// blocks, 160 times the mean, and one SM walked it alone for 0.87 of the
// launch.
//
// Design:
//   * a work plan (spmm_tile.plan, built once per image on the host) cuts
//     every block row longer than `chunk` blocks into contiguous chunks of
//     near-equal length; one CTA takes one work item (block row, [lo, hi),
//     partial slot), and the items are ordered longest first, so the long
//     chunks start while the short rows fill the tail;
//   * a CTA walks its blocks in CSR order; a block is read with 16-byte
//     coalesced loads into registers one block ahead of the product
//     (software pipelining: the next block's loads are in flight while the
//     current block is multiplied), then stored to shared memory with a
//     padded row stride (bn + 1) so the threads of a warp that read
//     different rows hit different banks;
//   * the (bn x k) slab of X at block_cols[j] is gathered one block ahead
//     too, from the same registers-then-shared-memory path;
//   * the (bm x k) outputs stay in registers for the whole item and are
//     written once: straight to Y for an unsplit row (zeros for an empty
//     one, which does the job of the reference's empty-row mask), or to
//     the item's slot of a partials scratch for a split row;
//   * a second launch sums each split row's partials in chunk order and
//     writes Y. Every sum runs in an order fixed by the plan, with no
//     atomics, so Y is bit-identical from run to run.
//
// bf16 images (the reference kernel's contract takes bf16 blocks): the
// kernel is a template on the block type. A bf16 block is read as 16-byte
// loads of 8 values each and widened with __bfloat162float into the same
// float32 shared-memory tile, so the product, the plan, the partial slots
// and the combine are the float32 image's, and a float32 image compiles to
// the code it always had. The bf16 image halves the bytes (6.43 GB for
// the n = 2^20 image, a 1.93 ms bound), but the inner loop still issues
// two warp-wide shared-memory loads per column of every block, so this
// first bf16 kernel is not expected to reach that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 8;    // outputs per thread: bm * k <= 2048
constexpr int kMaxXVec = 4;   // X-slab floats per thread: bn * k <= 1024

// One 16-byte load of a block: kElems consecutive values of one row,
// widened to float32 for the shared-memory tile.
template <typename T>
struct BlockVec;

template <>
struct BlockVec<float> {
  static constexpr int kElems = 4;
  using Load = float4;
  __device__ __forceinline__ static void widen(const float4& v, float* out) {
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct BlockVec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  using Load = uint4;
  __device__ __forceinline__ static void widen(const uint4& v, float* out) {
    __nv_bfloat16 h[8];
    memcpy(h, &v, sizeof(h));
#pragma unroll
    for (int u = 0; u < 8; ++u) out[u] = __bfloat162float(h[u]);
  }
};

// VEC: 16-byte loads per thread per block, bm*bn <= 256*VEC*kElems
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_blocksparse_kernel(const T* __restrict__ blocks,
                        const int* __restrict__ block_cols,
                        const int4* __restrict__ items,
                        const float* __restrict__ x, float* __restrict__ y,
                        float* __restrict__ partials, int bm, int bn, int k) {
  using V = BlockVec<T>;
  using Load = typename V::Load;
  constexpr int kE = V::kElems;
  extern __shared__ float smem[];
  const int ld = bn + 1;
  float* a_s = smem;                // bm rows of stride ld
  float* x_s = smem + bm * ld;      // bn x k, row-major
  const int tid = threadIdx.x;
  const int4 item = items[blockIdx.x];  // block row, lo, hi, slot or -1
  const int lo = item.y;
  const int hi = item.z;
  const int blk_vec = (bm * bn) / kE;
  const int x_elems = bn * k;
  const int n_out = bm * k;

  float acc[kMaxOut];
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) acc[t] = 0.f;

  Load a_pre[VEC];
  float x_pre[kMaxXVec];
  auto fetch = [&](int j) {
    const Load* blk = reinterpret_cast<const Load*>(
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
        const int e = e4 * kE;          // bn % kE == 0: the kE share a row
        float* dst = a_s + (e / bn) * ld + (e % bn);
        float w[kE];
        V::widen(a_pre[v], w);
#pragma unroll
        for (int u = 0; u < kE; ++u) dst[u] = w[u];
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

  float* yr = item.w < 0 ? y + static_cast<size_t>(item.x) * n_out
                         : partials + static_cast<size_t>(item.w) * n_out;
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) {
    const int o = tid + t * kThreads;
    if (o < n_out) yr[o] = acc[t];
  }
}

// Y rows of the split block rows: the sum of their chunks' partials in
// chunk order. splits: (n_split, 3) of block row, first slot, chunks.
__global__ void __launch_bounds__(kThreads)
spmm_blocksparse_combine_kernel(const int* __restrict__ splits,
                                const float* __restrict__ partials,
                                float* __restrict__ y, int n_out) {
  const int row = splits[3 * blockIdx.x];
  const int slot0 = splits[3 * blockIdx.x + 1];
  const int n = splits[3 * blockIdx.x + 2];
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const float* part = partials + static_cast<size_t>(slot0) * n_out + o;
    float s = part[0];
    for (int c = 1; c < n; ++c) s += part[static_cast<size_t>(c) * n_out];
    y[static_cast<size_t>(row) * n_out + o] = s;
  }
}

template <typename T, int VEC>
cudaError_t launch(const T* blocks, const int* block_cols, const int4* items,
                   int n_items, const float* x, float* y, float* partials,
                   int bm, int bn, int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bm * (bn + 1) + bn * k) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_blocksparse_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  spmm_blocksparse_kernel<T, VEC><<<n_items, kThreads, smem, stream>>>(
      blocks, block_cols, items, x, y, partials, bm, bn, k);
  return cudaGetLastError();
}

template <typename T>
int spmm(const T* blocks, const int* block_cols, const int* items,
         int n_items, const int* splits, int n_split, const float* x,
         float* y, float* partials, int bm, int bn, int k, int device,
         void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int vec = (bm * bn / BlockVec<T>::kElems + kThreads - 1) / kThreads;
  const int4* it = reinterpret_cast<const int4*>(items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec <= 1)
    err = launch<T, 1>(blocks, block_cols, it, n_items, x, y, partials, bm,
                       bn, k, s);
  else if (vec <= 2)
    err = launch<T, 2>(blocks, block_cols, it, n_items, x, y, partials, bm,
                       bn, k, s);
  else if (vec <= 4)
    err = launch<T, 4>(blocks, block_cols, it, n_items, x, y, partials, bm,
                       bn, k, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
  spmm_blocksparse_combine_kernel<<<n_split, kThreads, 0, s>>>(
      splits, partials, y, bm * k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape limits the caller checks first: bn % 4 == 0 (float32 blocks) or
// bn % 8 == 0 (bf16 blocks), bm * bn <= 4096, bm * k <= 2048,
// bn * k <= 1024; blocks, x and items 16-byte aligned. items (n_items, 4)
// and splits (n_split, 3) are a plan of the image (spmm_tile.plan): every
// block row is covered, and partials holds one (bm x k) slot per chunk of
// a split row.
extern "C" int repro_spmm_blocksparse_f32(const float* blocks,
                                          const int* block_cols,
                                          const int* items, int n_items,
                                          const int* splits, int n_split,
                                          const float* x, float* y,
                                          float* partials, int bm, int bn,
                                          int k, int device, void* stream) {
  return spmm(blocks, block_cols, items, n_items, splits, n_split, x, y,
              partials, bm, bn, k, device, stream);
}

// The same with bf16 blocks (raw 16-bit words); X and Y stay float32.
extern "C" int repro_spmm_blocksparse_bf16(const void* blocks,
                                           const int* block_cols,
                                           const int* items, int n_items,
                                           const int* splits, int n_split,
                                           const float* x, float* y,
                                           float* partials, int bm, int bn,
                                           int k, int device, void* stream) {
  return spmm(static_cast<const __nv_bfloat16*>(blocks), block_cols, items,
              n_items, splits, n_split, x, y, partials, bm, bn, k, device,
              stream);
}
