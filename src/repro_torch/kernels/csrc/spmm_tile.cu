// Block-sparse SpMM  Y = A @ X  for Hopper (sm_90a): blocks in float32 or
// bf16, X and Y in float32, every product and sum in float32.
//
// Replaces: src/repro/kernels/spmm_tile.py : spmm_blocksparse (Pallas body
// _spmm_kernel). The TPU kernel walked the block stream one block per
// sequential grid step and kept the output tile of the current block row
// resident in VMEM across the row.
//
// What bounds it on an H100: reading the dense blocks. With k = 4 columns
// each 64x64 float32 block (16 KB) feeds 32 KFLOP, two operations per
// byte, far below both the float32 and the tensor-core ridge points. One
// matmat over the n = 2^20 R-MAT image reads 12.86 GB of blocks, about
// 3.8 ms at 3.35 TB/s; its bf16 image reads 6.43 GB, a 1.93 ms bound.
// Skew is the plan's job: the image's heaviest block row holds 7,635
// blocks, 160 times the mean, so no block row may be walked by one CTA.
// Below that, an SM has ~5,950 blocks to stream, which leaves ~1,100
// clocks a block at the float32 bound and ~560 at the bf16 bound for the
// shared-memory traffic and the FMAs.
//
// Design:
//   * a work plan (spmm_tile.plan, built once per image on the host) cuts
//     every block row longer than `chunk` blocks into contiguous chunks of
//     near-equal length; one CTA takes one work item (block row, [lo, hi),
//     partial slot), and the items are ordered longest first, so the long
//     chunks start while the short rows fill the tail;
//   * the copy engine streams the blocks: one thread issues bulk copies
//     (cp.async.bulk, completing on an mbarrier) of each block, one run of
//     bm*bn values, and of its X slab into a ring of kStages stages, so
//     kStages - 1 blocks are in flight behind the one being multiplied and
//     no block passes through registers on its way to shared memory. The
//     X slab is copied one column group at a time, each group's rows
//     x_stride = 32k + 16 bytes apart, so the lanes of different groups
//     that read the same row of their group hit different banks. The
//     issuing thread reads the next block column while the current block
//     is multiplied; a __syncthreads per block releases the stage before
//     it is refilled;
//   * the products run from register tiles: a thread owns one column group
//     g (8 columns: one 16-byte load a row of bf16, two of float32; 4
//     columns of float32 blocks whose bn is not a multiple of 8) and up to
//     kMaxRows rows of the block. Per block it loads its rows' values of
//     the group (conflict-free: neighbouring lanes read neighbouring 16
//     bytes), then for each column of the group one row of X (k floats,
//     shared by the threads of that group), and does rows x 8 x k FMAs
//     into float32 accumulators that live for the whole item. At 64x64
//     and k = 4 that is 16 shared loads for 128 FMAs a thread, where the
//     earlier design (blocks through registers into a padded tile, each
//     FMA reading both operands from shared memory) read two per FMA;
//   * once per item, each row's partials are summed over the column groups
//     in group order through shared memory (the ring is free by then) and
//     the (bm x k) tile is written once: straight to Y for an unsplit row
//     (zeros for an empty one, which does the job of the reference's
//     empty-row mask), or to the item's slot of a partials scratch;
//   * a second launch sums each split row's partials in chunk order and
//     writes Y. Every sum runs in an order fixed by the plan and the shape,
//     with no atomics, so Y is bit-identical from run to run.
//
// X widths: the kernel is built for k = 1, 2, 4, 8 and 16 (a template on
// k, so the accumulators are registers); the wrapper pads any other width
// to the next of these with zero columns, and runs a wider X in slabs of
// 16 columns. The launch shape (threads, group width, shared bytes) comes
// from shape_of; spmm_tile.launch_config computes the same in Python.
//
// Order: every output sums its terms block by block in CSR order, within a
// block column by column of the group, then over the groups in order.
// float32 blocks with bn % 8 == 0 and bf16 blocks share the group width,
// so a bf16 image gives the bits of the float32 image of its widened
// values. bf16 values are widened exactly in registers (__bfloat1622float2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kStages = 4;        // the ring's stages
constexpr int kMaxRows = 4;       // block rows a thread owns in its group
constexpr int kMinThreads = 32;
constexpr int kMaxThreads = 512;
constexpr int kBarBytes = 128;    // the stages' mbarriers, before the ring
constexpr int kXPad = 16;         // bytes between two groups' X rows
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have
constexpr int kThreads = 256;     // the combine kernel's

// The launch shape of (bm x bn) blocks of `elem`-byte values against an X
// of width k.
struct Shape {
  int gw;           // columns of a group
  int groups;       // bn / gw
  int gpad;         // groups rounded up to a power of two
  int threads;      // a CTA's: the fewest that cover bm rows in kMaxRows
  int a_bytes;      // one block
  int x_stride;     // bytes from one group's X rows to the next's
  int stage_bytes;  // a block and its X slab
  int smem_bytes;   // barriers + max(ring, the group partials of the tile)
};

bool shape_of(int elem, int bm, int bn, int k, Shape* s) {
  if (bm < 1 || bn < 1 || (k != 1 && k != 2 && k != 4 && k != 8 && k != 16))
    return false;
  s->gw = (elem == 2 || bn % 8 == 0) ? 8 : 4;
  if (bn % s->gw != 0) return false;
  s->groups = bn / s->gw;
  s->gpad = 1;
  while (s->gpad < s->groups) s->gpad *= 2;
  s->threads = kMinThreads;
  while (s->threads <= kMaxThreads &&
         (s->gpad > s->threads || bm > kMaxRows * (s->threads / s->gpad)))
    s->threads *= 2;
  if (s->threads > kMaxThreads) return false;
  s->a_bytes = bm * bn * elem;
  s->x_stride = s->gw * k * 4 + kXPad;
  s->stage_bytes = s->a_bytes + s->groups * s->x_stride;
  const int ring = kStages * s->stage_bytes;
  const int red = bm * s->groups * k * 4;
  s->smem_bytes = kBarBytes + (ring > red ? ring : red);
  return s->smem_bytes <= kMaxSmem;
}

// One row's values of a column group, widened to float32.
template <typename T, int GW>
struct GroupRow;

template <>
struct GroupRow<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* a) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
};

template <>
struct GroupRow<float, 8> {
  __device__ __forceinline__ static void load(const float* p, float* a) {
    GroupRow<float, 4>::load(p, a);
    GroupRow<float, 4>::load(p + 4, a + 4);
  }
};

template <>
struct GroupRow<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* a) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      __nv_bfloat162 h;
      memcpy(&h, &w[u], sizeof(h));
      const float2 f = __bfloat1622float2(h);  // .x: column 2u, .y: 2u + 1
      a[2 * u] = f.x;
      a[2 * u + 1] = f.y;
    }
  }
};

// One row of the X slab: K floats.
template <int K>
__device__ __forceinline__ void load_x(const float* p, float* v) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else if constexpr (K == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 u = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = u.x;
      v[4 * j + 1] = u.y;
      v[4 * j + 2] = u.z;
      v[4 * j + 3] = u.w;
    }
  }
}

template <typename T, int GW, int K>
__global__ void __launch_bounds__(kMaxThreads)
spmm_blocksparse_kernel(const T* __restrict__ blocks,
                        const int* __restrict__ block_cols,
                        const int4* __restrict__ items,
                        const float* __restrict__ x, float* __restrict__ y,
                        float* __restrict__ partials, int bm, int bn,
                        int groups, int gpad, int a_bytes, int x_stride,
                        int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + kBarBytes;
  const uint32_t bars = smem_u32(smem);  // stage s's at bars + 8 s
  const int tid = threadIdx.x;
  const int4 item = items[blockIdx.x];   // block row, lo, hi, slot or -1
  const int lo = item.y;
  const int n = item.z - item.y;

  // This thread's column group g and rows r0, r0 + step, ... below bm.
  const int g = tid & (gpad - 1);
  const int r0 = tid / gpad;
  const int step = blockDim.x / gpad;
  int my_rows = 0;
  if (g < groups)
    while (my_rows < kMaxRows && r0 + my_rows * step < bm) ++my_rows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Block lo + t, of block column col, and its X slab into stage
  // t % kStages, the slab one group's rows at a time.
  const uint32_t tx_bytes = a_bytes + groups * GW * K * 4;
  auto issue = [&](int t, int col) {
    const int s = t % kStages;
    const uint32_t bar = bars + 8 * s;
    const uint32_t dst = smem_u32(ring) + s * stage_bytes;
    mbar_expect_tx(bar, tx_bytes);
    bulk_load(dst, blocks + static_cast<size_t>(lo + t) * bm * bn, a_bytes,
              bar);
    const float* xs = x + static_cast<size_t>(col) * bn * K;
    for (int q = 0; q < groups; ++q)
      bulk_load(dst + a_bytes + q * x_stride, xs + q * GW * K, GW * K * 4,
                bar);
  };
  if (tid == 0)
    for (int t = 0; t < n && t < kStages; ++t)
      issue(t, __ldg(block_cols + lo + t));

  float acc[kMaxRows][K];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i)
#pragma unroll
    for (int q = 0; q < K; ++q) acc[i][q] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int s = t % kStages;
    const bool refill = tid == 0 && t + kStages < n;
    // in flight while this block is multiplied
    const int next_col = refill ? __ldg(block_cols + lo + t + kStages) : 0;
    mbar_wait(bars + 8 * s, (t / kStages) & 1);
    if (my_rows > 0) {
      const unsigned char* st = ring + s * stage_bytes;
      const T* a_s = reinterpret_cast<const T*>(st) + r0 * bn + g * GW;
      float a[kMaxRows][GW];
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i)
        if (i < my_rows) GroupRow<T, GW>::load(a_s + i * step * bn, a[i]);
      const float* x_s =
          reinterpret_cast<const float*>(st + a_bytes + g * x_stride);
#pragma unroll
      for (int c = 0; c < GW; ++c) {
        float xv[K];
        load_x<K>(x_s + c * K, xv);
#pragma unroll
        for (int i = 0; i < kMaxRows; ++i) {
          if (i < my_rows) {
#pragma unroll
            for (int q = 0; q < K; ++q)
              acc[i][q] = fmaf(a[i][c], xv[q], acc[i][q]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (refill) issue(t + kStages, next_col);
  }

  // Each row's group partials, summed in group order; the ring is free
  // (every copy issued has landed and been read).
  float* red = reinterpret_cast<float*>(ring);  // (bm, groups, K)
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < my_rows) {
      float* p = red + (static_cast<size_t>(r0 + i * step) * groups + g) * K;
#pragma unroll
      for (int q = 0; q < K; ++q) p[q] = acc[i][q];
    }
  }
  __syncthreads();
  const int n_out = bm * K;
  float* out = item.w < 0 ? y + static_cast<size_t>(item.x) * n_out
                          : partials + static_cast<size_t>(item.w) * n_out;
  for (int o = tid; o < n_out; o += blockDim.x) {
    const float* p = red + static_cast<size_t>(o / K) * groups * K + o % K;
    float v = p[0];
    for (int j = 1; j < groups; ++j) v += p[j * K];
    out[o] = v;
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

template <typename T>
using KernelFn = void (*)(const T*, const int*, const int4*, const float*,
                          float*, float*, int, int, int, int, int, int, int);

template <typename T, int GW>
KernelFn<T> kernel_of_width(int k) {
  switch (k) {
    case 1: return spmm_blocksparse_kernel<T, GW, 1>;
    case 2: return spmm_blocksparse_kernel<T, GW, 2>;
    case 4: return spmm_blocksparse_kernel<T, GW, 4>;
    case 8: return spmm_blocksparse_kernel<T, GW, 8>;
    case 16: return spmm_blocksparse_kernel<T, GW, 16>;
    default: return nullptr;
  }
}

// The kernel for a shape of shape_of, with its dynamic shared memory
// allowed; nullptr if there is none or the attribute is refused.
template <typename T>
KernelFn<T> kernel_for(const Shape& sh, int k, cudaError_t* err) {
  KernelFn<T> kernel = nullptr;
  if (sh.gw == 8) {
    kernel = kernel_of_width<T, 8>(k);
  } else if constexpr (std::is_same<T, float>::value) {
    kernel = kernel_of_width<T, 4>(k);
  }
  if (kernel == nullptr) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  *err = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sh.smem_bytes);
  return *err == cudaSuccess ? kernel : nullptr;
}

template <typename T>
int spmm(const T* blocks, const int* block_cols, const int* items,
         int n_items, const int* splits, int n_split, const float* x,
         float* y, float* partials, int bm, int bn, int k, int device,
         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape sh;
  if (!shape_of(sizeof(T), bm, bn, k, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  KernelFn<T> kernel = kernel_for<T>(sh, k, &err);
  if (kernel == nullptr || n_items == 0) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<n_items, sh.threads, sh.smem_bytes, s>>>(
      blocks, block_cols, reinterpret_cast<const int4*>(items), x, y,
      partials, bm, bn, sh.groups, sh.gpad, sh.a_bytes, sh.x_stride,
      sh.stage_bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
  spmm_blocksparse_combine_kernel<<<n_split, kThreads, 0, s>>>(
      splits, partials, y, bm * k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int config(int bm, int bn, int k, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape sh;
  if (!shape_of(sizeof(T), bm, bn, k, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  KernelFn<T> kernel = kernel_for<T>(sh, k, &err);
  if (kernel == nullptr) return static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel, sh.threads, sh.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[] = {sh.threads, kStages, sh.smem_bytes, ctas, sh.gw,
                        attr.numRegs, static_cast<int>(attr.localSizeBytes),
                        sh.stage_bytes};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
}

}  // namespace

// Shape limits the caller checks first: bn % 4 == 0 (float32 blocks) or
// bn % 8 == 0 (bf16 blocks), bm * bn <= 4096, k one of 1, 2, 4, 8, 16;
// blocks, x and items 16-byte aligned. items (n_items, 4) and splits
// (n_split, 3) are a plan of the image (spmm_tile.plan): every block row
// is covered, and partials holds one (bm x k) slot per chunk of a split
// row. A shape the kernel does not take returns cudaErrorInvalidValue.
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

// The launch the kernel makes for (bm x bn) blocks, float32 (bf16 = 0) or
// bf16, against an X of width k, on `device`: out[0..7] = threads a CTA,
// the ring's stages, shared bytes a CTA, CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the column group's
// width, registers a thread, local (spilled) bytes a thread, bytes a stage.
extern "C" int repro_spmm_blocksparse_config(int bf16, int bm, int bn, int k,
                                             int device, int* out) {
  return bf16 ? config<__nv_bfloat16>(bm, bn, k, device, out)
              : config<float>(bm, bn, k, device, out);
}
