// Flash attention (online softmax) for Hopper (sm_90a), in two routes by
// input type: bf16 on the tensor cores (wgmma, TMA, a producer warp), and
// float32 on the CUDA cores. Output in the input type.
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
// peak, while Q, K, V and O are 151 MB, 0.045 ms at 3.35 TB/s.
//
// Common to both routes:
//   * a CTA per (query tile, head, batch) walks its KV tiles in order in a
//     loop of its own, which takes the place of the TPU's sequential grid
//     axis; under `causal` the loop stops at the diagonal tile (the TPU
//     kernel's pl.when skip), and the heaviest query tiles launch first;
//   * grouped-query attention in the kernel: head h reads KV head
//     h / (H / Hkv); K and V are never repeated in memory;
//   * strides in elements for batch, head and sequence (the last dim is
//     contiguous), so callers pass views of (B, S, H, d) projections;
//   * ragged Sq and Sk: rows past Sq are not stored, keys past Sk are
//     masked; no divisibility rule on either;
//   * scores, running max, denominator and accumulator in float32, the
//     denominator floored at 1e-30. No atomics and no split of the KV loop
//     over CTAs: every sum runs in a fixed order (per-thread loops and
//     fixed shuffle trees), so the output is bit-identical run to run.
//
// bf16 route (flash_wgmma_kernel), what it does about the bound:
//   * 128 query rows per CTA as two consumer warpgroups of 64 rows, plus
//     one producer warp: 288 threads, one CTA per SM;
//   * the producer issues TMA loads of Q (once) and of 128-key K and V
//     tiles into a 2-stage shared-memory ring guarded by mbarriers ("full"
//     when the bytes have landed, "empty" when both warpgroups are done).
//     The tensor maps are rank 4 over (d, S, H, B), encoded on the host
//     per call from the strides, with 64-column boxes and the 128-byte
//     swizzle that the wgmma descriptors name; rows past Sq or Sk and
//     columns past d land as zeros, so head dims 16 and 32 share the
//     64-column instantiation and 80 (hubert's) the 128-column one: its
//     second box holds columns 64-79 and 48 zero columns, which add
//     nothing to S, and the PV product's columns past d are never stored;
//   * S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//     (K-major); the products of bf16 values are exact in float32;
//   * the online softmax runs on the accumulator fragment in registers:
//     exp2 with the scale folded into log2(e); a row's max and sum go over
//     the 4 lanes that hold it in a fixed xor tree;
//   * O += P V by wgmma with V from shared memory as an MN-major
//     (transposed) B operand and P as the register A operand, split into
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products per step:
//     1.5 times the flops of one bf16 P, and 16 bits of each weight.
//     P_hi alone leaves the rounding of every weight in the output on
//     top of the output's own bf16 rounding, which alone comes close to
//     the 2^-8 limit (PERF.md). Defining REPRO_FLASH_PV_HI_ONLY builds
//     that design instead, for `python -m repro_torch.kernels.flash_pv`,
//     which compares the two in a build of its own; the library never
//     holds it. The denominator sums the float32 weights.
//
// float32 route (flash_attention_kernel): the products on the CUDA cores,
// instantiated at d = 16, 32, 64, 80 and 128 (any multiple of 16 fits:
// a thread owns d/16 output columns tx + 16 c, and the float4 reads go
// along the query rows, not along d).
// 64 query rows by 64 keys per step, 256 threads as a 16 x 16 grid: a
// thread owns 4 query rows and 4 score columns (tx + 16 j), and the same 4
// rows by d/16 output columns (tx + 16 c). Q (once), then K (transposed),
// then V (same buffer) and the weights P (transposed) are staged in shared
// memory; masked scores are -1e30 and P stays float32 into the PV product.
#include <cuda.h>  // CUtensorMap and its enums (no link against libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;
};

// ------------------------------------------------------------ float32 route

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per step
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = 4;         // query rows per thread: 4 ty .. 4 ty + 3
constexpr int kCols = kBK / 16;  // score columns per thread: tx + 16 j
constexpr int kQPad = kBQ + 4;   // row length of Q^T and P^T (float4 reads)
constexpr int kKPad = kBK + 1;   // row length of K^T (conflict-free stores)
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  Strides sq, sk, sv, so;
  int batch, heads, kv_heads, len_q, len_k, causal;
  float scale;
};

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

// Stage rows [r0, r0 + 64) of a (len, D) matrix, zeros past len:
// transposed to dst[c * ld + r] or row-major dst[r * D + c].
template <int D, bool kTranspose>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long stride, int r0, int len) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    const float x = g < len ? src[g * stride + c] : 0.f;
    if (kTranspose)
      dst[c * ld + r] = x;
    else
      dst[r * D + c] = x;
  }
}

template <int D>
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
  const float* qg = p.q + b * p.sq.b + h * p.sq.h;
  const float* kg = p.k + b * p.sk.b + hk * p.sk.h;
  const float* vg = p.v + b * p.sv.b + hk * p.sv.h;
  float* og = p.o + b * p.so.b + h * p.so.h;

  stage<D, true>(qt, kQPad, qg, p.sq.s, q0, p.len_q);

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
    stage<D, true>(kv, kKPad, kg, p.sk.s, k0, p.len_k);
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
    stage<D, false>(kv, D, vg, p.sv.s, k0, p.len_k);
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
      og[qi * p.so.s + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.len_q + kBQ - 1) / kBQ, p.heads, p.batch);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 route

constexpr int kWBM = 128;         // query rows per CTA: two warpgroups of 64
constexpr int kWBK = 128;         // keys per KV tile
constexpr int kWConsumers = 256;  // two consumer warpgroups
constexpr int kWThreads = kWConsumers + 32;  // and one producer warp
constexpr int kStages = 2;        // K/V ring depth
constexpr int kBox = 64;          // TMA box columns: 128 B, the swizzle span
constexpr int kRowBytes = kBox * 2;
constexpr float kLog2e = 1.4426950408889634f;

// A (B, H, S, d) tensor as a tensor map: pos[0..2] is the map dim (1..3)
// of S, H and B; dim 0 is d.
struct TmaView {
  CUtensorMap map;
  int pos[3];
};

struct WParams {
  TmaView q, k, v;
  __nv_bfloat16* o;
  Strides so;
  int heads, kv_heads, len_q, len_k, head_dim, causal;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of (64 columns, rows) of a (B, H, S, d) view into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const TmaView& t,
                                         int col, int row, int head,
                                         int batch, uint32_t bar) {
  int c[4];
  c[0] = col;
  c[t.pos[0]] = row;
  c[t.pos[1]] = head;
  c[t.pos[2]] = batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&t.map)), "r"(c[0]), "r"(c[1]),
      "r"(c[2]), "r"(c[3]), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching wgmma accumulators across the async
// window: each register is "written" here, after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// m64n128k16, A and B from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// m64n64k16, A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// m64n128k16, A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}


template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t desc_b) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, desc_b, 1);
  else
    wgmma_rs_n128(d, a, desc_b, 1);
}

// Max and sum over the 4 lanes of a quad (the lanes that hold one row of
// an accumulator fragment); every lane ends with the same bits.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two weights (the lower key first) as a bf16 pair P_hi = bf16(P) and
// the remainder P_lo = bf16(P - P_hi): P_hi + P_lo carries 16 bits of P.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// NP: head dim padded to whole 64-column boxes (64 for d <= 64, or 128).
// Shared memory, 1024-byte aligned: Q as NP/64 boxes of [128 rows][64],
// then the K ring and the V ring, each stage NP/64 boxes of [128 keys][64],
// then the mbarriers.
template <int NP>
constexpr int wgmma_smem_bytes() {
  return kWBM * NP * 2 + 2 * kStages * kWBK * NP * 2 + 64 + 1024;
}

template <int NP>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ WParams p) {
  constexpr int kSub = NP / kBox;
  constexpr uint32_t kQBytes = kWBM * NP * 2;
  constexpr uint32_t kTileBytes = kWBK * NP * 2;
  extern __shared__ __align__(1024) unsigned char w_smem[];
  const uint32_t q_s = (smem_u32(w_smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;                // + stage * kTileBytes
  const uint32_t v_s = k_s + kStages * kTileBytes;   // + stage * kTileBytes
  const uint32_t bars = v_s + kStages * kTileBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                    // + 8 * stage
  const uint32_t v_full = bars + 8 + 8 * kStages;      // + 8 * stage
  const uint32_t kv_empty = bars + 8 + 16 * kStages;   // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWBM;  // heaviest first
  const int hk = h / (p.heads / p.kv_heads);
  int n_tiles = (p.len_k + kWBK - 1) / kWBK;
  if (p.causal)  // no key past the tile's last query row is needed
    n_tiles = min(n_tiles, (min(q0 + kWBM, p.len_q) - 1) / kWBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWConsumers) {  // the producer warp: one lane issues
    if (threadIdx.x == kWConsumers) {
      mbar_expect_tx(q_full, kQBytes);
      for (int j = 0; j < kSub; ++j)
        tma_load(q_s + j * kWBM * kRowBytes, p.q, j * kBox, q0, h, b,
                 q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // wait for both warpgroups to release the stage
          mbar_wait(kv_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        for (int j = 0; j < kSub; ++j)
          tma_load(k_s + s * kTileBytes + j * kWBK * kRowBytes, p.k,
                   j * kBox, t * kWBK, hk, b, k_full + 8 * s);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        for (int j = 0; j < kSub; ++j)
          tma_load(v_s + s * kTileBytes + j * kWBK * kRowBytes, p.v,
                   j * kBox, t * kWBK, hk, b, v_full + 8 * s);
      }
    }
    return;
  }

  // Consumers. Warpgroup wg owns query rows q0 + 64 wg .. + 63; a thread
  // holds rows row_a and row_a + 8 and, in every 8-column chunk i of a
  // fragment, columns 8 i + col_t and 8 i + col_t + 1.
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row_a = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const int wg_row0 = q0 + wg * 64;
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;

  float o[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_full, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t ks = k_s + s * kTileBytes, vs = v_s + s * kTileBytes;

    // S = Q K^T: NP/16 steps of 16 columns; a step moves 32 bytes inside a
    // 128-byte swizzled row, or on to the next box.
    float sc[kWBK / 2];
    mbar_wait(k_full + 8 * s, parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      wgmma_ss_n128(sc,
                    wgmma_desc(q_wg + (kk >> 2) * kWBM * kRowBytes + col, 16,
                               1024),
                    wgmma_desc(ks + (kk >> 2) * kWBK * kRowBytes + col, 16,
                               1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kWBK / 2>(sc);

    // Online softmax on the fragment, in log2 units.
    const int k0 = t * kWBK;
    const bool masked =
        k0 + kWBK > p.len_k || (p.causal && k0 + kWBK - 1 > wg_row0);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWBK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * p.scale_log2;
        if (masked) {
          const int kj = k0 + 8 * i + col_t + (e & 1);
          const int qi = e < 2 ? row_a : row_a + 8;
          if (kj >= p.len_k || (p.causal && kj > qi)) x = -INFINITY;
        }
        sc[4 * i + e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - base_a);
    const float alpha_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
    // P as the A operand, 16 keys per step, split into bf16 hi and lo
    uint32_t p_hi[kWBK / 16][4], p_lo[kWBK / 16][4];
#pragma unroll
    for (int i = 0; i < kWBK / 8; ++i) {
      const float p0 = exp2f(sc[4 * i] - base_a);
      const float p1 = exp2f(sc[4 * i + 1] - base_a);
      const float p2 = exp2f(sc[4 * i + 2] - base_b);
      const float p3 = exp2f(sc[4 * i + 3] - base_b);
      rs_a += p0 + p1;
      rs_b += p2 + p3;
      const int j = i >> 1, r = (i & 1) * 2;
      split_bf16(p0, p1, p_hi[j][r], p_lo[j][r]);
      split_bf16(p2, p3, p_hi[j][r + 1], p_lo[j][r + 1]);
    }
    l_a = l_a * alpha_a + rs_a;  // per lane; the quad is summed at the end
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      o[4 * i] *= alpha_a;
      o[4 * i + 1] *= alpha_a;
      o[4 * i + 2] *= alpha_b;
      o[4 * i + 3] *= alpha_b;
    }

    // O += P_hi V + P_lo V: 8 steps of 16 keys, 2 KB apart in every box
    // of V, each step the hi product then the lo one.
    mbar_wait(v_full + 8 * s, parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kWBK / 16; ++j) {
      const uint64_t desc_v =
          wgmma_desc(vs + j * 16 * kRowBytes, kWBK * kRowBytes, 1024);
      wgmma_pv<NP>(o, p_hi[j], desc_v);
#ifndef REPRO_FLASH_PV_HI_ONLY
      wgmma_pv<NP>(o, p_lo[j], desc_v);
#endif
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NP / 2>(o);
    mbar_arrive(kv_empty + 8 * s);
  }

  const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
  __nv_bfloat16* og = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < NP / 8; ++i) {
    const int col = 8 * i + col_t;
    if (col >= p.head_dim) continue;
    if (row_a < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(og + row_a * p.so.s + col) =
          __floats2bfloat162_rn(o[4 * i] / den_a, o[4 * i + 1] / den_a);
    if (row_a + 8 < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(og + (row_a + 8) * p.so.s + col) =
          __floats2bfloat162_rn(o[4 * i + 2] / den_b, o[4 * i + 3] / den_b);
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Error codes of the bf16 launcher beyond cudaError_t (the wrapper names
// them): no encoder in the driver, and 20000 + the CUresult of a failed
// encode.
constexpr int kErrNoEncoder = 19999;
constexpr int kErrEncode = 20000;

// A (B, H, S, d) bf16 view as a rank-4 tensor map with boxes of 64
// columns by `rows` sequence positions: d innermost, then S, H and B in
// the order of their strides (the wrapper has checked that each stride of
// a dim longer than 1 is a multiple of 16 bytes and the base is 16-byte
// aligned). A dim of size 1 is never stepped, so it takes the largest span
// as its stride.
int encode_view(TmaView* view, const void* ptr, int batch, int heads,
                int len, int head_dim, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  long long size[3] = {len, heads, batch};
  long long stride[3] = {st.s, st.h, st.b};
  long long span = head_dim;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * size[i] > span) span = stride[i] * size[i];
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = span;
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), 0, 0, 0};
  cuuint64_t strides[3];
  for (int r = 0; r < 3; ++r) {
    dims[r + 1] = static_cast<cuuint64_t>(size[order[r]]);
    strides[r] = static_cast<cuuint64_t>(stride[order[r]]) * 2;
    view->pos[order[r]] = r + 1;
  }
  cuuint32_t box[4] = {kBox, 1, 1, 1};  // rows along S, wherever it sorts
  box[view->pos[0]] = static_cast<cuuint32_t>(rows);
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      &view->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

template <int NP>
cudaError_t launch_bf16(const WParams& p, int batch, cudaStream_t stream) {
  constexpr int bytes = wgmma_smem_bytes<NP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.heads, batch, (p.len_q + kWBM - 1) / kWBM);
  flash_wgmma_kernel<NP><<<grid, kWThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

void unpack_strides(const long long* strides, Strides* out[4]) {
  for (int i = 0; i < 4; ++i)
    *out[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// q (B, H, Sq, d), k/v (B, Hkv, Sk, d), o (B, H, Sq, d) of one type, each
// addressed by its (batch, head, sequence) strides in elements, in this
// order in `strides` (a host array of 12): q, k, v, o. The last dim is
// contiguous. The caller guarantees B, H, Hkv, Sq, Sk >= 1, H % Hkv == 0,
// d in {16, 32, 64, 80, 128}.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides, int batch,
                                         int heads, int kv_heads, int len_q,
                                         int len_k, int head_dim, int causal,
                                         float scale, int device,
                                         void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  Strides* all[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  unpack_strides(strides, all);
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch_f32<16>(p, s));
    case 32: return static_cast<int>(launch_f32<32>(p, s));
    case 64: return static_cast<int>(launch_f32<64>(p, s));
    case 80: return static_cast<int>(launch_f32<80>(p, s));
    case 128: return static_cast<int>(launch_f32<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same contract in bf16; besides, q, k and v are 16-byte aligned and
// each of their strides of a dim longer than 1 is a multiple of 8
// elements (TMA's rule, checked by the wrapper).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* strides, int batch,
                                          int heads, int kv_heads, int len_q,
                                          int len_k, int head_dim, int causal,
                                          float scale, int device,
                                          void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (head_dim % 16 != 0 || head_dim < 16 || head_dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  WParams p;
  Strides sq, sk, sv;
  Strides* all[4] = {&sq, &sk, &sv, &p.so};
  unpack_strides(strides, all);
  int err = encode_view(&p.q, q, batch, heads, len_q, head_dim, sq, kWBM);
  if (err == 0)
    err = encode_view(&p.k, k, batch, kv_heads, len_k, head_dim, sk, kWBK);
  if (err == 0)
    err = encode_view(&p.v, v, batch, kv_heads, len_k, head_dim, sv, kWBK);
  if (err != 0) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.head_dim = head_dim;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim <= 64 ? launch_bf16<64>(p, batch, s)
                                         : launch_bf16<128>(p, batch, s));
}
