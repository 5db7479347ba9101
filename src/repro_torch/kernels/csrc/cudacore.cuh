// Float32 tiles on the CUDA cores, shared by the float32 routes of flash
// attention (flashattn.cu, the forward, and flashattn_bwd.cu, its
// backward): 16-byte cp.async staging of row-major tiles into a swizzled
// shared-memory layout, and the two register-tiled products the kernels
// are built from. The port's numerics rule allows no TF32, so the float32
// routes leave the tensor cores alone.
//
// Layouts. A staged tile is [rows][NP] floats, NP the head dim padded to
// 64 or 128 columns, its float4 chunk c of row r stored at chunk
// c ^ (r % 8): eight rows read at one chunk hit eight different 16-byte
// bank groups, with no padding (the backward's tiles fill 227 KB of shared
// memory as it is). The kernels give each thread rows 8 or 16 apart, which
// share their swizzle, so a step of a product costs one XOR per operand.
// Tiles written by the threads themselves (P and dS) are padded to rows
// of kLdP = 68 floats instead: read one row at a time by every lane, they
// need no swizzle, and a scalar store from the product layout below is
// conflict-free.
//
// Every sum runs in a fixed order (over the head dim in `dot_rows`, over
// the rows in `acc_rows`), so the kernels are bit-identical run to run.
//
// Like hopper.cuh, everything sits in an anonymous namespace.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int kFThreads = 256;  // every float32 kernel: 8 warps
constexpr int kLdP = 68;        // row length of the P and dS tiles

// Offset in floats of float4 chunk c4 of row `row` in a swizzled tile of
// NP columns.
template <int NP>
__device__ __forceinline__ int swz(int row, int c4) {
  return row * NP + ((c4 ^ (row & 7)) << 2);
}

// 16 bytes from global to shared memory, asynchronously; zeros if !in
// (src is then never read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for every cp.async group this thread committed (the caller then
// syncs the block before anyone reads the tiles).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A barrier over `threads` threads (a multiple of 32) under id 1..15.
__device__ __forceinline__ void bar_named(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Rows [r0, r0 + R) of a (len, d) matrix with row stride `stride`
// elements (16-byte aligned rows, d a multiple of 4) into the swizzled
// [R][NP] tile `dst`, by the whole block: a coalesced 16-byte copy a
// chunk, zeros past len and past d. Not committed.
template <int R, int NP>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long stride, int r0,
                                           int len, int d) {
  constexpr int kCh = NP / 4;
  static_assert((R * kCh) % kFThreads == 0, "whole copies a thread");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int n = 0; n < R * kCh / kFThreads; ++n) {
    const int i = n * kFThreads + static_cast<int>(threadIdx.x);
    const int r = i / kCh, c4 = i % kCh;
    const bool in = r0 + r < len && 4 * c4 < d;
    const float* g = in ? src + (r0 + r) * stride + 4 * c4 : src;
    cp_async16(base + 4 * swz<NP>(r, c4), g, in);
  }
}

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][j] += sum over c < NP of A[a0 + SA i][c] * B[b0 + SB j][c], A and
// B swizzled tiles of NP columns, SA and SB multiples of 8. The thread's
// tile of the product is RA x RB; the sum over c runs in order.
template <int NP, int RA, int SA, int RB, int SB>
__device__ __forceinline__ void dot_rows(float (&acc)[RA][RB],
                                         const float* a, int a0,
                                         const float* b, int b0) {
  static_assert(SA % 8 == 0 && SB % 8 == 0, "rows share their swizzle");
  const float* pa = a + a0 * NP;
  const float* pb = b + b0 * NP;
  const int xa = a0 & 7, xb = b0 & 7;
#pragma unroll 2
  for (int c = 0; c < NP / 4; ++c) {
    float4 av[RA], bv[RB];
    const int ca = (c ^ xa) << 2, cb = (c ^ xb) << 2;
#pragma unroll
    for (int i = 0; i < RA; ++i)
      av[i] = *reinterpret_cast<const float4*>(pa + i * SA * NP + ca);
#pragma unroll
    for (int j = 0; j < RB; ++j)
      bv[j] = *reinterpret_cast<const float4*>(pb + j * SB * NP + cb);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j)
          acc[i][j] = fmaf(f4(av[i], e), f4(bv[j], e), acc[i][j]);
  }
}

// acc[4 m + x][4 n + y] += sum over rows r < R of A[r][4 ca[m] + x] *
// B[r][4 cb[n] + y]: A a padded tile of kLdP floats a row, B a swizzled
// tile of NP columns; the thread's columns are the float4 chunks ca of A
// and cb of B. The sum over r runs in order.
template <int R, int NP, int NA, int NB>
__device__ __forceinline__ void acc_rows(float (&acc)[4 * NA][4 * NB],
                                         const float* a, const int (&ca)[NA],
                                         const float* b,
                                         const int (&cb)[NB]) {
  static_assert(R % 8 == 0, "whole swizzle periods");
  for (int r8 = 0; r8 < R; r8 += 8)
#pragma unroll
  for (int u = 0; u < 8; ++u) {  // row r8 + u: its swizzle is u
    const int r = r8 + u;
    float4 av[NA], bv[NB];
#pragma unroll
    for (int m = 0; m < NA; ++m)
      av[m] = *reinterpret_cast<const float4*>(a + r * kLdP + 4 * ca[m]);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      bv[n] = *reinterpret_cast<const float4*>(b + r * NP +
                                               ((cb[n] ^ u) << 2));
#pragma unroll
    for (int m = 0; m < NA; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[4 * m + x][4 * n + y] = fmaf(f4(av[m], x), f4(bv[n], y),
                                             acc[4 * m + x][4 * n + y]);
  }
}

}  // namespace
