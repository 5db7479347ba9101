// Gram / projection  G = alpha * A^T @ B  for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/gram.py : gram (Pallas body _gram_kernel),
// which streamed row intervals through one TPU core and accumulated the
// (m x b) result in VMEM across sequential grid steps.
//
// What bounds it on an H100: reading A and B once, (n*m + n*b) * 4 bytes
// at 3.35 TB/s. Krylov-Schur calls it at (m, b) = (4, 4): A and B are
// (2^20 x 4), 32 MB, 10 us. LOBPCG (b = 8) calls it at 8, 16 and 24
// columns, the SVD (b = 2) at 2: at (24, 24) 201 MB, 60 us, for 1.2
// GFLOP (18 us at 67 TFLOP/s), so the bytes bound every width.
//
// Design: one launch per call; the wrapper (gram.py: variant) names the
// kernel and this file launches it or refuses it.
//   * Rows are cut into n_parts contiguous intervals (gram.row_partition:
//     a function of n alone), one CTA each.
//   * vec4x4, (4, 4) only (Krylov-Schur): a row of A and a row of B are
//     one float4 each; neighbouring threads take neighbouring rows,
//     kUnroll rows per thread are loaded before any is used, and each
//     thread keeps its 16 sums in registers.
//   * tile<M>x<B>, (2, 2), (8, 8), (16, 16) and (24, 24) (the rest of the
//     solver family): every row of A and B is read once per call. The R
//     rows of a tile of a row-major tensor are one contiguous run of R*m
//     floats, staged into shared memory as flat 16-byte cp.async copies
//     through a ring of kStages tiles (72 KB), the next tiles' copies in
//     flight while this one is consumed. gram(S, S) stages S once. The
//     256 threads are (T output tiles) x (L row lanes): a thread holds a
//     TR x TS register tile of G and takes the staged rows j = lane
//     (mod L), reading TR values of A's row and TS of B's from shared
//     memory (float2 or float4 loads; a warp holds all T tiles and 32/T
//     neighbouring rows, so its loads are broadcasts on distinct banks).
//     Its R / L rows of a tile are summed apart, then added to its total:
//     two short chains, not one of rows_per_part / L products, whose
//     float32 error would grow with n.
//     At the end the row lanes are summed by a warp shuffle tree, then
//     the warps in index order. At 2 columns a row is 8 bytes: a CTA
//     stages from the even row at or before its first, and a copy that
//     would run past the tensor's end reads only what is there and
//     zero-fills the rest; rows outside the interval are masked.
//   * generic, any (m, b) and any pointer off a 16-byte boundary: grid.y
//     tiles the m*b outputs in chunks of 16; the same walk as vec4x4 with
//     scalar loads, the (p, q) of each of the chunk's outputs computed
//     once before the row loop.
//   * Each CTA reduces its threads' sums in a fixed order into its partial
//     in scratch.
//   * Cross-CTA reduction in the same launch by a last-CTA ticket: each
//     CTA fences its partial and draws a ticket from an integer counter
//     (atomicAdd on an unsigned int, the only atomic here); the CTA that
//     draws the last ticket sums the partials in a fixed order (256 /
//     (m*b) interleaved strands of parts per output, one from m*b = 256
//     on, then the strands in index order), scales by alpha once, and
//     sets the counter back to 0.
//     A ticket rather than a cooperative launch: the grid may exceed what
//     is co-resident, and a grid-wide sync would pin the partition to the
//     card's SM count. The counter is one int per (device, stream), held
//     by the wrapper (gram.py); launches on one stream run in order, so
//     the next call finds it at 0, and two streams never share one.
// No float atomics: every sum's order depends on n, m, b and the variant
// only, so G is bit-identical from run to run on any card. In every
// kernel G[p, q] and G[q, p] are the same products summed in the same
// order, so gram(S, S) is exactly symmetric. Ragged n is handled by the
// last interval; there is no divisibility rule on n.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // outputs per CTA of the generic kernel
constexpr int kUnroll = 4;  // rows in flight per thread (vec4x4)
constexpr int kStages = 3;  // tiles in the shared-memory ring (tile kernels)

// Variant ids, the same numbers as gram.VARIANTS
constexpr int kGeneric = 0, kVec4x4 = 1, kTile2x2 = 2, kTile8x8 = 3,
              kTile16x16 = 4, kTile24x24 = 5;

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

// vec4x4: M and B multiples of 4, rows read as float4s.
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

// The tile kernels' shapes: each thread holds a TR x TS tile of G, and a
// tile of R rows (a multiple of the row lanes) is 24 KB of A and B.
template <int M, int B>
struct TileShape;
template <>
struct TileShape<2, 2> { static constexpr int TR = 2, TS = 2, R = 1536; };
template <>
struct TileShape<8, 8> { static constexpr int TR = 4, TS = 4, R = 384; };
template <>
struct TileShape<16, 16> { static constexpr int TR = 4, TS = 4, R = 192; };
template <>
struct TileShape<24, 24> { static constexpr int TR = 6, TS = 6, R = 128; };

template <int M, int B>
constexpr int tile_smem_bytes() {
  return kStages * TileShape<M, B>::R * (M + B) * 4;
}

// 16 bytes global -> shared, of which the first src_bytes are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K consecutive floats from shared memory, as float4s or float2s
template <int K>
__device__ __forceinline__ void load_seg(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
    static_assert(K % 2 == 0, "segments are float2s or float4s");
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  }
}

// Rows [row0, row_end) of x (n_rows, W) row-major into dst, as flat
// 16-byte copies; row0 * W * 4 is a multiple of 16. A copy past the
// tensor's end reads only the bytes that are there.
template <int W>
__device__ __forceinline__ void stage_rows(float* dst, const float* x,
                                           long long row0, long long row_end,
                                           long long n_rows) {
  const long long f0 = row0 * W;
  const long long total = n_rows * W;
  const int chunks = static_cast<int>(((row_end - row0) * W + 3) / 4);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const long long off = f0 + 4LL * c;
    const int bytes = static_cast<int>(min(16LL, (total - off) * 4));
    cp_async16(dst + 4 * c, x + off, bytes);
  }
}

// tile<M>x<B>: the CTA's interval walked once in tiles of R rows staged
// through a kStages ring; a and b 16-byte aligned.
template <int M, int B>
__global__ void __launch_bounds__(kThreads, 2)
gram_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ partials, float* __restrict__ out,
                 unsigned int* __restrict__ counter, long long n,
                 long long rows_per_part, float alpha) {
  using S = TileShape<M, B>;
  constexpr int TR = S::TR, TS = S::TS, R = S::R;
  constexpr int TQ = B / TS;
  constexpr int T = (M / TR) * TQ;  // output tiles
  constexpr int L = kThreads / T;   // row lanes
  constexpr int MB = M * B;
  // rows per 16 bytes: a CTA's first staged row starts on a boundary
  constexpr int G = (M % 4 == 0 && B % 4 == 0) ? 1 : 2;
  static_assert(M % TR == 0 && B % TS == 0 && 32 % T == 0, "tiling");
  static_assert(M % 2 == 0 && B % 2 == 0, "rows of 8 bytes or more");
  static_assert(R % L == 0 && R % 4 == 0, "a tile is whole row lanes");
  static_assert(kWarps * MB <= kStages * R * (M + B), "reduction fits");

  extern __shared__ __align__(16) float smem[];
  float* const sa = smem;                      // [kStages][R * M]
  float* const sb = smem + kStages * R * M;    // [kStages][R * B]
  const bool same = a == b;                    // gram(S, S): stage S once

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long r1 = min(n, r0 + rows_per_part);
  const long long tb = r0 - r0 % G;            // first staged row
  const int n_tiles = static_cast<int>((r1 - tb + R - 1) / R);

  auto load_tile = [&](int k) {
    const int st = k % kStages;
    const long long row0 = tb + static_cast<long long>(k) * R;
    const long long row_end = min(r1, row0 + R);
    stage_rows<M>(sa + st * R * M, a, row0, row_end, n);
    if (!same) stage_rows<B>(sb + st * R * B, b, row0, row_end, n);
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_tiles) load_tile(k);
    cp_async_commit();
  }

  const int t = threadIdx.x % T;
  const int lane = threadIdx.x / T;
  const int tp = t / TQ;
  const int tq = t % TQ;
  float acc[TR][TS];
#pragma unroll
  for (int p = 0; p < TR; ++p)
#pragma unroll
    for (int q = 0; q < TS; ++q) acc[p][q] = 0.f;

  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();  // tile k has landed (this thread's part)
    __syncthreads();               // ... every thread's; tile k-1 consumed
    if (k + kStages - 1 < n_tiles) load_tile(k + kStages - 1);
    cp_async_commit();
    const int st = k % kStages;
    const float* ta = sa + st * R * M + tp * TR;
    const float* tbs = (same ? sa + st * R * M : sb + st * R * B) + tq * TS;
    const long long row0 = tb + static_cast<long long>(k) * R;
    const int lo = static_cast<int>(max(0LL, r0 - row0));
    const int hi = static_cast<int>(min(static_cast<long long>(R),
                                        r1 - row0));
    float sum[TR][TS];  // this tile's R / L rows of the lane
#pragma unroll
    for (int p = 0; p < TR; ++p)
#pragma unroll
      for (int q = 0; q < TS; ++q) sum[p][q] = 0.f;
#pragma unroll
    for (int i = 0; i < R / L; ++i) {
      const int j = lane + i * L;
      if (j >= lo && j < hi) {
        float av[TR];
        float bv[TS];
        load_seg<TR>(ta + j * M, av);
        load_seg<TS>(tbs + j * B, bv);
#pragma unroll
        for (int p = 0; p < TR; ++p)
#pragma unroll
          for (int q = 0; q < TS; ++q)
            sum[p][q] = fmaf(av[p], bv[q], sum[p][q]);
      }
    }
#pragma unroll
    for (int p = 0; p < TR; ++p)
#pragma unroll
      for (int q = 0; q < TS; ++q) acc[p][q] += sum[p][q];
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile consumed: the ring becomes the warps' sums

  // row lanes of a warp (lanes t, t + T, ...) by a shuffle tree, then the
  // warps in index order
  float* const red = smem;  // [kWarps][MB]
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < TR; ++p)
#pragma unroll
    for (int q = 0; q < TS; ++q) {
      float v = acc[p][q];
#pragma unroll
      for (int off = 16; off >= T; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (wl < T) red[warp * MB + (tp * TR + p) * B + tq * TS + q] = v;
    }
  __syncthreads();
  float* const part = partials + static_cast<size_t>(blockIdx.x) * MB;
  for (int e = threadIdx.x; e < MB; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * MB + e];
    part[e] = s;
  }
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

template <int M, int B>
int launch_tile(const float* a, const float* b, float* partials,
                unsigned int* counter, float* out, long long n, int n_parts,
                long long rows_per_part, float alpha, cudaStream_t s) {
  constexpr int smem = tile_smem_bytes<M, B>();
  const cudaError_t err = cudaFuncSetAttribute(
      gram_tile_kernel<M, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_tile_kernel<M, B><<<n_parts, kThreads, smem, s>>>(
      a, b, partials, out, counter, n, rows_per_part, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (n, m) and b (n, bc) row-major; partials holds n_parts * m * bc floats
// of scratch; counter is an unsigned int at 0, owned by this stream; out
// is (m, bc). The caller guarantees n > 0, m * bc > 0 and
// n_parts * rows_per_part >= n. `variant` (gram.VARIANTS) names the
// kernel; one whose width or alignment does not fit the call is refused
// with cudaErrorInvalidValue and nothing is launched.
extern "C" int repro_gram_f32(const float* a, const float* b, float* partials,
                              unsigned int* counter, float* out, long long n,
                              int m, int bc, int n_parts,
                              long long rows_per_part, float alpha,
                              int variant, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(a) |
        reinterpret_cast<std::uintptr_t>(b)) & 15) == 0;
  const auto fits = [&](int want_m, int want_b) {
    return aligned && m == want_m && bc == want_b;
  };
  switch (variant) {
    case kGeneric: {
      const dim3 grid(n_parts, (m * bc + kChunk - 1) / kChunk);
      gram_kernel<<<grid, kThreads, 0, s>>>(a, b, partials, out, counter, n,
                                            m, bc, rows_per_part, alpha);
      return static_cast<int>(cudaGetLastError());
    }
    case kVec4x4:
      if (!fits(4, 4)) break;
      gram_vec_kernel<4, 4><<<n_parts, kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(a),
          reinterpret_cast<const float4*>(b), partials, out, counter, n,
          rows_per_part, alpha);
      return static_cast<int>(cudaGetLastError());
    case kTile2x2:
      if (!fits(2, 2)) break;
      return launch_tile<2, 2>(a, b, partials, counter, out, n, n_parts,
                               rows_per_part, alpha, s);
    case kTile8x8:
      if (!fits(8, 8)) break;
      return launch_tile<8, 8>(a, b, partials, counter, out, n, n_parts,
                               rows_per_part, alpha, s);
    case kTile16x16:
      if (!fits(16, 16)) break;
      return launch_tile<16, 16>(a, b, partials, counter, out, n, n_parts,
                                 rows_per_part, alpha, s);
    case kTile24x24:
      if (!fits(24, 24)) break;
      return launch_tile<24, 24>(a, b, partials, counter, out, n, n_parts,
                                 rows_per_part, alpha, s);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
