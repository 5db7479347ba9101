// The backward of flash attention for Hopper (sm_90a): dQ, dK and dV of
// softmax attention from Q, K, V, the forward's output O, its row
// log-sum-exp LSE (csrc/flashattn.cu stores it) and dO. bf16 or float32
// inputs, gradients in the input type.
//
// Replaces: no Pallas kernel. The TPU package trains by JAX's autodiff of
// its plain attention (src/repro/models/attention.py : _attend, and
// src/repro/kernels/flashattn_ref.py : attention_ref); its Pallas forward
// (src/repro/kernels/flashattn.py : flash_attention_single) has no
// backward. The port's forward is the hand-written kernel, so its
// gradient is one too (kernels/ops.py wraps both in an autograd.Function).
//
// What bounds it on an H100: operations. With s = scale * Q K^T,
// P = exp(s - LSE), D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,
// plus the recomputed S: 5 products of 2 B H Sq Sk d flop, halved under
// causal. qwen2-1.5b's training layer (B 2, H 12, Hkv 2, S 4096, d 128,
// causal, bf16) needs 2.58e11 flop, 0.261 ms at the 989 TFLOP/s bf16
// tensor-core peak; its Q, K, V, O, dO, LSE in and dQ, dK, dV out are
// 118 MB, 0.035 ms at 3.35 TB/s. qwen2's layer in float32 at 1,024
// tokens (chip_smoke.py's phase 32b: B 1, H 12, Hkv 2, S 1024, d 128,
// causal) needs 8.06e9 flop, 0.120 ms at the 67 TFLOP/s float32 peak of
// the CUDA cores.
//
// No atomics in either route: dQ is summed over the keys by the CTA of its
// query tile, dK and dV over the queries by the CTAs of their key tile,
// each in a fixed order, so the gradients are bit-identical run to run.
// That costs the recomputation of S and dP for dQ: 7 products where an
// atomic dQ (FlashAttention-2) needs 5 (3.61e11 flop at qwen2's layer,
// 0.365 ms at the peak; 1.13e10 flop, 0.168 ms at phase 32b's layer).
//
// Both routes start with flash_bwd_prep_kernel: D = rowsum(dO o O) (one
// warp per row, each lane over columns lane, lane + 32, ... then a fixed
// xor tree) and LSE log2(e), into (B, H, Sq_pad) scratch padded to whole
// 64-row tiles; a padded row has LSE = +inf and D = 0, so its P and dS
// come out 0 with no mask. With G = H / Hkv > 1 the key-tile CTAs store
// float32 partials (B, H, Sk, d) of dK and dV per query head, and
// flash_bwd_reduce_kernel sums a KV head's G partials in order
// g = 0 .. G-1, scales dK and stores both in the input type; with G = 1
// the key-tile CTAs store the gradients themselves. A CTA per query head,
// not per KV head: per KV head qwen2's layer would be 128 CTAs of 64 keys
// on 132 SMs, the first walking 6 x 64 query tiles and the last 6; per
// query head it is 1,536 CTAs, and its partials (100.7 MB there) cost
// ~0.06 ms to write and read. A key tile that no query sees (causal,
// Sq < Sk) stores zeros.
//
// bf16 route, on the tensor cores (wgmma, TMA loads; the helpers are in
// hopper.cuh, shared with the forward), four launches on the caller's
// stream (three when H = Hkv): prep, dK/dV, the reduction, dQ.
//   * flash_bwd_dkdv_wgmma_kernel: a CTA per (64-key tile, query head,
//     batch) of one warpgroup, two CTAs per SM. Thread 0 loads the K and V
//     tiles once by TMA and streams the 64-query tiles of Q and dO, with
//     their LSE and D by bulk copies, through a 2-stage ring on mbarriers;
//     under causal the CTA walks the query tiles from the diagonal on, and
//     the key tiles launch heaviest first. In the transposed orientation
//     (FlashAttention-3's), per query tile: S^T = K Q^T and dP^T = V dO^T
//     by wgmma m64n64k16 with both operands in shared memory (K-major);
//     P^T = exp2(S^T scale log2(e) - LSE log2(e)) and
//     dS^T = P^T o (dP^T - D) on the accumulator fragments in registers,
//     which are the layout of wgmma's register A operand; dV += P^T dO and
//     dK += dS^T Q by wgmma with dO and Q as MN-major B operands (as the
//     forward's V);
//   * flash_bwd_dq_wgmma_kernel: a CTA per (64-query tile, head, batch),
//     one warpgroup, Q and dO loaded once, 64-key tiles of K and V through
//     a 2-stage ring up to the diagonal, heaviest tiles first: S = Q K^T
//     and dP = dO V^T from shared memory, dS in registers, and dQ += dS K
//     with K as the MN-major B operand.
//   Every accumulator is float32; P and dS are rounded to bf16 once for
//   their products (tests/test_torch_flash_bwd.py models that rounding
//   against the gates). Rows past Sq and keys past Sk arrive as TMA zeros,
//   and so do columns past d (d = 16 and 32 run on 64 columns, 80 on 128,
//   as in the forward): they add nothing to S or dP. Keys past Sk and the
//   pairs causal masks get P = 0, and nothing past Sq, Sk or d is stored.
//
// float32 route, on the CUDA cores (the port's numerics rule allows no
// TF32, so the tensor cores are not used; the tile helpers are in
// cudacore.cuh, shared with the forward), three launches on the caller's
// stream (two when H = Hkv): prep, flash_bwd_f32_kernel, the reduction.
// What bounds it in practice is the CUDA cores' issue rate: 7 products of
// float32 FMAs, each FMA needing its operands from shared memory, and a
// causal grid whose CTAs carry from 1 to Sq/64 tiles.
//   * One grid of 256-thread CTAs, one CTA an SM (its tiles take all 227
//     KB of shared memory at d = 128), for both halves of the work: a CTA
//     per (64-key tile, query head, batch) for dK and dV and a CTA per
//     (64-query tile, head, batch) for dQ, interleaved in launch order,
//     each kind heaviest first under causal. At phase 32b's layer: 384
//     CTAs on 132 SMs; one CTA per KV head for dK and dV would be 32, and
//     would leave three quarters of the card idle.
//   * The dK/dV CTA holds K and V and streams Q, dO, LSE log2(e) and D
//     from the diagonal on by 16-byte cp.async copies into two stages:
//     the next query tile's copies are in flight while this one computes.
//     Its two warpgroups split the products: warpgroup 0 computes
//     S^T = K Q^T, P^T = exp2(S^T scale log2(e) - LSE log2(e)), stores P
//     and adds dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, reads
//     P back, stores dS = P o (dP - D) and adds dK += dS^T Q. Two block
//     barriers a tile and one over warpgroup 1.
//   * The dQ CTA holds Q and dO and streams K and V up to the diagonal
//     the same way: warpgroup 0 computes S and stores P (a row per key),
//     warpgroup 1 computes dP and turns P into dS in place, and both add
//     dQ += dS K, each over half of the head dim. Three barriers a tile.
//   * Register tiles: of S^T, dP^T, S and dP a thread owns 8 x 4 (rows 8
//     apart, so that its shared-memory rows share a swizzle), read as
//     float4s along the head dim from row-major tiles; of dK and dV 8 keys
//     x 8 columns at d = 128 (64 accumulators each warpgroup), of dQ 8
//     queries x 4. No tile is stored transposed.
//   * Rows past Sq and Sk and columns past d are staged as zeros (d = 16
//     and 32 run on 64 columns, 80 on 128); keys past Sk and the pairs
//     causal masks get P = 0; nothing past Sq, Sk or d is stored.
//   ptxas (-Xptxas -v, sm_90a): flash_bwd_f32_kernel<128> uses
//   238 registers, flash_bwd_f32_kernel<64> 167, no spills (one CTA of
//   256 threads an SM may use 255).
#include "cudacore.cuh"

namespace {

// ------------------------------------------------------------- both routes

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr int kTile = 64;    // query rows and keys per tile, both routes
constexpr int kRowThreads = 256;  // threads of the prep and reduce kernels

template <typename T>
struct PrepParams {
  const T* o;
  const T* dout;
  const float* lse;  // (B, H, Sq) log-sum-exp, natural units
  float* lse2;       // (B, H, Sq_pad): LSE log2(e), +inf past Sq
  float* delta;      // (B, H, Sq_pad): D, 0 past Sq
  Strides so, sdo;
  int batch, heads, len_q, len_q_pad, head_dim;
};

// D of one row, rowsum(dO o O): lane c sums columns c, c + 32, ... in
// order, then a fixed xor tree; every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ float row_delta(const T* og, const T* dg,
                                           int head_dim, int lane) {
  float acc = 0.f;
  for (int c = lane; c < head_dim; c += 32)
    acc = fmaf(ld_f(og + c), ld_f(dg + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_prep_kernel(const __grid_constant__ PrepParams<T> p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (row >= static_cast<long long>(p.batch) * p.heads * p.len_q_pad) return;
  const int qi = static_cast<int>(row % p.len_q_pad);
  const long long bh = row / p.len_q_pad;
  float dsum = 0.f, lse2 = INFINITY;
  if (qi < p.len_q) {  // the whole warp takes one branch
    const int h = static_cast<int>(bh % p.heads);
    const int b = static_cast<int>(bh / p.heads);
    dsum = row_delta(p.o + b * p.so.b + h * p.so.h + qi * p.so.s,
                     p.dout + b * p.sdo.b + h * p.sdo.h + qi * p.sdo.s,
                     p.head_dim, lane);
    lse2 = p.lse[bh * p.len_q + qi] * kLog2e;
  }
  if (lane == 0) {
    p.delta[row] = dsum;
    p.lse2[row] = lse2;
  }
}

template <typename T>
struct ReduceParams {
  const float* partial;  // (2, B, H, Sk, d): unscaled dK, then dV
  T* dk;
  T* dv;
  Strides sdk, sdv;
  int batch, heads, kv_heads, len_k, head_dim;
  float scale;
};

// dK and dV of (B, Hkv, Sk, d) from the partials: a thread per pair of
// columns sums the G query heads of its KV head in order.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_reduce_kernel(const __grid_constant__ ReduceParams<T> p) {
  const int half = p.head_dim / 2;
  const long long i = static_cast<long long>(blockIdx.x) * kRowThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(p.batch) * p.kv_heads * p.len_k * half)
    return;
  const int c = static_cast<int>(i % half) * 2;
  long long r = i / half;
  const int kj = static_cast<int>(r % p.len_k);
  r /= p.len_k;
  const int hk = static_cast<int>(r % p.kv_heads);
  const int b = static_cast<int>(r / p.kv_heads);
  const int group = p.heads / p.kv_heads;
  const long long head = static_cast<long long>(p.len_k) * p.head_dim;
  const long long plane = static_cast<long long>(p.batch) * p.heads * head;
  const float* at = p.partial +
                    (static_cast<long long>(b) * p.heads + hk * group) * head +
                    static_cast<long long>(kj) * p.head_dim + c;
  float2 sk = *reinterpret_cast<const float2*>(at);
  float2 sv = *reinterpret_cast<const float2*>(at + plane);
  for (int g = 1; g < group; ++g) {
    const float2 gk = *reinterpret_cast<const float2*>(at + g * head);
    const float2 gv = *reinterpret_cast<const float2*>(at + plane + g * head);
    sk.x += gk.x;
    sk.y += gk.y;
    sv.x += gv.x;
    sv.y += gv.y;
  }
  st2(p.dk + b * p.sdk.b + hk * p.sdk.h + kj * p.sdk.s + c, sk.x * p.scale,
      sk.y * p.scale);
  st2(p.dv + b * p.sdv.b + hk * p.sdv.h + kj * p.sdv.s + c, sv.x, sv.y);
}

template <typename T>
cudaError_t launch_prep(const PrepParams<T>& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.batch) * p.heads *
                         p.len_q_pad;
  flash_bwd_prep_kernel<T>
      <<<static_cast<unsigned>((rows + 7) / 8), kRowThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const ReduceParams<T>& p, cudaStream_t stream) {
  const long long n = static_cast<long long>(p.batch) * p.kv_heads *
                      p.len_k * (p.head_dim / 2);
  flash_bwd_reduce_kernel<T><<<static_cast<unsigned>((n + kRowThreads - 1) /
                                                     kRowThreads),
                               kRowThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ float32 route

struct FParams {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse2;   // (B, H, Sq_pad) from the prep kernel
  const float* delta;  // (B, H, Sq_pad)
  float* partial;      // (2, B, H, Sk, d) dK and dV per query head, or null
  float* dq;
  float* dk;
  float* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int batch, heads, kv_heads, len_q, len_k, len_q_pad, head_dim, causal;
  float scale, scale_log2;  // scale, and scale * log2(e)
};

// Shared memory of flash_bwd_f32_kernel, in floats: six [64][NP] tiles
// (the dK/dV CTA's K, V and two stages of Q and dO; the dQ CTA's Q, dO
// and two stages of K and V), LSE log2(e) and D of two query tiles, and
// two [64][kLdP] tiles (P and dS). At NP = 128: 232,448 bytes, the most
// a block may have.
template <int NP>
constexpr int fbwd_smem_floats() {
  return 6 * kTile * NP + 4 * kTile + 2 * kTile * kLdP;
}

// Rows of the 8 x 4 product tiles (S^T, dP^T, S, dP) of thread t of a
// warpgroup: rows a0 + 8 i of the A operand (keys of S^T, queries of S),
// b0 + 8 j of the B operand; a warp holds 32 x 32 of the 64 x 64 tile.
__device__ __forceinline__ int tile_a0(int t) {
  return ((t & 31) >> 3) + 4 * ((t >> 5) & 1);
}
__device__ __forceinline__ int tile_b0(int t) {
  return (t & 7) + 32 * (t >> 6);
}

// dK (warpgroup 1) and dV (warpgroup 0) of key tile kt for query head h.
template <int NP>
__device__ __forceinline__ void dkdv_tile(const FParams& p, float* sm, int h,
                                          int b, int kt) {
  constexpr int kT = kTile * NP;  // floats of a staged tile
  constexpr int kNB = NP / 64;    // column chunks of dK, dV a thread
  float* k_s = sm;
  float* v_s = sm + kT;
  float* qd_s = sm + 2 * kT;      // stage s: Q at 2 s kT, dO at (2 s + 1) kT
  float* rows_s = sm + 6 * kT;    // stage s: LSE log2(e), then D
  float* p_s = rows_s + 4 * kTile;  // P, a row per query
  float* ds_s = p_s + kTile * kLdP;  // dS, a row per query
  const int k0 = kt * kTile;
  const int hk = h / (p.heads / p.kv_heads);
  const int first = p.causal ? k0 / kTile : 0;  // no earlier query sees a key
  const int n_tiles = max((p.len_q + kTile - 1) / kTile - first, 0);
  const long long row0 = (static_cast<long long>(b) * p.heads + h) *
                         p.len_q_pad;
  const float* qg = p.q + b * p.sq.b + h * p.sq.h;
  const float* dg = p.dout + b * p.sdo.b + h * p.sdo.h;

  // Q, dO, LSE log2(e) and D of query tile first + t into stage t % 2
  auto load_q_tile = [&](int t) {
    const int s = t & 1, q0 = (first + t) * kTile;
    stage_tile<kTile, NP>(qd_s + 2 * s * kT, qg, p.sq.s, q0, p.len_q,
                          p.head_dim);
    stage_tile<kTile, NP>(qd_s + (2 * s + 1) * kT, dg, p.sdo.s, q0, p.len_q,
                          p.head_dim);
    if (threadIdx.x < kTile / 2) {  // 2 x 64 floats, 16 bytes a thread
      const int which = threadIdx.x / (kTile / 4);
      const int c4 = threadIdx.x % (kTile / 4);
      cp_async16(smem_u32(rows_s + (2 * s + which) * kTile + 4 * c4),
                 (which ? p.delta : p.lse2) + row0 + q0 + 4 * c4, true);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {  // K and V go with the first query tile's group
    stage_tile<kTile, NP>(k_s, p.k + b * p.sk.b + hk * p.sk.h, p.sk.s, k0,
                          p.len_k, p.head_dim);
    stage_tile<kTile, NP>(v_s, p.v + b * p.sv.b + hk * p.sv.h, p.sv.s, k0,
                          p.len_k, p.head_dim);
    load_q_tile(0);
  }

  const int grp = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int a0 = tile_a0(t), b0 = tile_b0(t);  // keys a0 + 8 i, queries
  // dV (warpgroup 0) or dK (1): keys 4 kc[m] + x, columns 4 cc[n] + y
  const int kc[2] = {t >> 4, (t >> 4) + 8};
  int cc[kNB];
#pragma unroll
  for (int n = 0; n < kNB; ++n) cc[n] = (t & 15) + 16 * n;
  float acc[8][4 * kNB];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kNB; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it & 1, q0 = (first + it) * kTile;
    cp_async_wait_all();
    __syncthreads();  // stage s is in; tile it - 1 is done with s ^ 1, P, dS
    if (it + 1 < n_tiles) load_q_tile(it + 1);
    const float* q_t = qd_s + 2 * s * kT;
    const float* do_t = q_t + kT;
    const float* l2 = rows_s + 2 * s * kTile;
    const float* dl = l2 + kTile;

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1)
    float st[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
    dot_rows<NP, 8, 8, 4, 8>(st, grp ? v_s : k_s, a0, grp ? do_t : q_t, b0);
    if (grp == 0) {  // P, stored a row per query; masked pairs get 0
      const bool edge = k0 + kTile > p.len_k ||
                        (p.causal && k0 + kTile - 1 > q0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = b0 + 8 * j;
        const float lj = l2[ql];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kj = k0 + a0 + 8 * i;
          float x = exp2f(fmaf(st[i][j], p.scale_log2, -lj));
          if (edge && (kj >= p.len_k || (p.causal && kj > q0 + ql))) x = 0.f;
          p_s[ql * kLdP + a0 + 8 * i] = x;
        }
      }
    }
    __syncthreads();  // P is in
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = b0 + 8 * j;
        const float dj = dl[ql];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int at = ql * kLdP + a0 + 8 * i;
          ds_s[at] = p_s[at] * (st[i][j] - dj);
        }
      }
      bar_named(1, 128);  // dS is in
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1)
    acc_rows<kTile, NP, 2, kNB>(acc, grp ? ds_s : p_s, kc, grp ? q_t : do_t,
                                cc);
  }

  float* out;
  long long rs;
  if (p.partial == nullptr) {  // G = 1: the gradients themselves
    out = grp ? p.dk + b * p.sdk.b + hk * p.sdk.h
              : p.dv + b * p.sdv.b + hk * p.sdv.h;
    rs = grp ? p.sdk.s : p.sdv.s;
  } else {  // this query head's partials, summed by the reduction
    const long long head = static_cast<long long>(p.len_k) * p.head_dim;
    out = p.partial + (grp ? 0 : static_cast<long long>(p.batch) * p.heads *
                                     head) +
          (static_cast<long long>(b) * p.heads + h) * head;
    rs = p.head_dim;
  }
  // dK is scaled once: here when G = 1, else in the reduction
  const float m_out = grp && p.partial == nullptr ? p.scale : 1.f;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kj = k0 + 4 * kc[m] + x;
      if (kj >= p.len_k) continue;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        const int col = 4 * cc[n];
        if (col >= p.head_dim) continue;
        const float* a = acc[4 * m + x] + 4 * n;
        *reinterpret_cast<float4*>(out + kj * rs + col) = make_float4(
            a[0] * m_out, a[1] * m_out, a[2] * m_out, a[3] * m_out);
      }
    }
}

// dQ of query tile qt for head h.
template <int NP>
__device__ __forceinline__ void dq_tile(const FParams& p, float* sm, int h,
                                        int b, int qt) {
  constexpr int kT = kTile * NP;
  constexpr int kCg = NP / 8;   // column chunks of dQ a warpgroup
  constexpr int kNA = NP / 64;  // query chunks of dQ a thread
  float* q_s = sm;
  float* do_s = sm + kT;
  float* kv_s = sm + 2 * kT;   // stage s: K at 2 s kT, V at (2 s + 1) kT
  float* ds_s = sm + 6 * kT + 4 * kTile;  // P, then dS in place: a row a key
  const int q0 = qt * kTile;
  const int hk = h / (p.heads / p.kv_heads);
  int n_k = (p.len_k + kTile - 1) / kTile;
  if (p.causal)  // no key past the tile's last query row is needed
    n_k = min(n_k, (min(q0 + kTile, p.len_q) - 1) / kTile + 1);
  const float* kg = p.k + b * p.sk.b + hk * p.sk.h;
  const float* vg = p.v + b * p.sv.b + hk * p.sv.h;

  // K and V of key tile t into stage t % 2
  auto load_k_tile = [&](int t) {
    const int s = t & 1;
    stage_tile<kTile, NP>(kv_s + 2 * s * kT, kg, p.sk.s, t * kTile, p.len_k,
                          p.head_dim);
    stage_tile<kTile, NP>(kv_s + (2 * s + 1) * kT, vg, p.sv.s, t * kTile,
                          p.len_k, p.head_dim);
    cp_async_commit();
  };
  stage_tile<kTile, NP>(q_s, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0,
                        p.len_q, p.head_dim);
  stage_tile<kTile, NP>(do_s, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s,
                        q0, p.len_q, p.head_dim);
  load_k_tile(0);  // Q and dO go with the first key tile's group

  const int grp = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int a0 = tile_a0(t), b0 = tile_b0(t);  // queries a0 + 8 i, keys
  // LSE log2(e) (warpgroup 0) or D (1) of the thread's query rows
  const float* rsrc = (grp ? p.delta : p.lse2) +
                      (static_cast<long long>(b) * p.heads + h) *
                          p.len_q_pad + q0;
  float rowv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rowv[i] = rsrc[a0 + 8 * i];
  // dQ: queries 4 qc[m] + x, columns 4 cq[0] + y (half the head dim a
  // warpgroup)
  int qc[kNA];
#pragma unroll
  for (int m = 0; m < kNA; ++m) qc[m] = t / kCg + (128 / kCg) * m;
  const int cq[1] = {grp * kCg + t % kCg};
  float acc[4 * kNA][4];
#pragma unroll
  for (int i = 0; i < 4 * kNA; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int s = it & 1, k0 = it * kTile;
    cp_async_wait_all();
    __syncthreads();  // stage s is in; tile it - 1 is done with s ^ 1, dS
    if (it + 1 < n_k) load_k_tile(it + 1);
    const float* k_t = kv_s + 2 * s * kT;
    const float* v_t = k_t + kT;

    // S = Q K^T (warpgroup 0) or dP = dO V^T (1)
    float st[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
    dot_rows<NP, 8, 8, 4, 8>(st, grp ? do_s : q_s, a0, grp ? v_t : k_t, b0);
    if (grp == 0) {  // P, stored a row per key; masked pairs get 0
      const bool edge = k0 + kTile > p.len_k ||
                        (p.causal && k0 + kTile - 1 > q0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = b0 + 8 * j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ql = a0 + 8 * i;
          float x = exp2f(fmaf(st[i][j], p.scale_log2, -rowv[i]));
          if (edge && (k0 + kl >= p.len_k ||
                       (p.causal && k0 + kl > q0 + ql)))
            x = 0.f;
          ds_s[kl * kLdP + ql] = x;
        }
      }
    }
    __syncthreads();  // P is in
    if (grp == 1) {   // dS = P o (dP - D), in place
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int at = (b0 + 8 * j) * kLdP + a0 + 8 * i;
          ds_s[at] = ds_s[at] * (st[i][j] - rowv[i]);
        }
    }
    __syncthreads();  // dS is in
    acc_rows<kTile, NP, kNA, 1>(acc, ds_s, qc, k_t, cq);   // dQ += dS K
  }

  float* dqg = p.dq + b * p.sdq.b + h * p.sdq.h;
  const int col = 4 * cq[0];
  if (col >= p.head_dim) return;
#pragma unroll
  for (int m = 0; m < kNA; ++m)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int qi = q0 + 4 * qc[m] + x;
      if (qi >= p.len_q) continue;
      const float* a = acc[4 * m + x];
      *reinterpret_cast<float4*>(dqg + qi * p.sdq.s + col) =
          make_float4(a[0] * p.scale, a[1] * p.scale, a[2] * p.scale,
                      a[3] * p.scale);
    }
}

// Both kinds of CTA in one grid, interleaved in launch order (dK/dV of key
// tile 0, dQ of the last query tile, dK/dV of key tile 1, ...): under
// causal each kind runs heaviest first, and the two together fill the card.
template <int NP>
__global__ void __launch_bounds__(kFThreads, 1)
flash_bwd_f32_kernel(const __grid_constant__ FParams p) {
  extern __shared__ float4 fb_smem[];
  float* sm = reinterpret_cast<float*>(fb_smem);
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int n_kt = (p.len_k + kTile - 1) / kTile;
  const int n_qt = (p.len_q + kTile - 1) / kTile;
  const int both = 2 * min(n_kt, n_qt);
  const bool kv = z < both ? (z & 1) == 0 : n_kt > n_qt;
  const int r = z < both ? z >> 1 : z - both / 2;
  if (kv)
    dkdv_tile<NP>(p, sm, h, b, r);
  else
    dq_tile<NP>(p, sm, h, b, n_qt - 1 - r);
}

template <int NP>
cudaError_t launch_bwd_f32(const FParams& p, const PrepParams<float>& pp,
                           const ReduceParams<float>& rp,
                           cudaStream_t stream) {
  cudaError_t err = launch_prep(pp, stream);
  if (err != cudaSuccess) return err;
  constexpr int bytes = fbwd_smem_floats<NP>() * 4;
  err = cudaFuncSetAttribute(flash_bwd_f32_kernel<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.heads, p.batch, (p.len_k + kTile - 1) / kTile +
                                        (p.len_q + kTile - 1) / kTile);
  flash_bwd_f32_kernel<NP><<<grid, kFThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.partial == nullptr) return err;
  return launch_reduce(rp, stream);
}

// --------------------------------------------------------------- bf16 route

constexpr int kB = kTile;                  // queries and keys per tile
constexpr int kWg = 128;                   // one warpgroup a CTA
constexpr int kBoxBytes = kB * kRowBytes;  // one 64-column box of a tile
constexpr int kRowsBytes = 2 * kB * 4;     // LSE log2(e) and D of a tile

struct BParams {
  TmaView q, k, v, dout;  // boxes of 64 columns by kB rows
  float* lse2;       // (B, H, Sq_pad): LSE log2(e), +inf past Sq
  float* delta;      // (B, H, Sq_pad): D, 0 past Sq
  float* partial;    // (2, B, H, Sk, d) dK and dV per query head, or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides sdq, sdk, sdv;
  int batch, heads, kv_heads, len_q, len_k, len_q_pad, head_dim, causal;
  float scale, scale_log2;  // scale, and scale * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Holds a wgmma's register A operand until the wait that retires it, so
// that no register of it is reused while the product may still read it.
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

// Shared memory, 1024-byte aligned, of both wgmma kernels: six tiles of
// NP/64 boxes of [64 rows][64 columns] (128-byte swizzle), then the LSE
// and D of two query tiles (the dK/dV kernel's), then the mbarriers.
template <int NP>
constexpr int bwd_smem_bytes() {
  return 6 * (NP / kBox) * kBoxBytes + 2 * kRowsBytes + 64 + 1024;
}

template <int NP>
__global__ void __launch_bounds__(kWg, 2)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ BParams p) {
  constexpr int kSub = NP / kBox;
  constexpr uint32_t kTile = kSub * kBoxBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + kTile;
  const uint32_t q_s = base + 2 * kTile;     // + stage * kTile
  const uint32_t do_s = base + 4 * kTile;    // + stage * kTile
  const uint32_t rows_s = base + 6 * kTile;  // + stage * kRowsBytes
  const uint32_t kv_full = rows_s + 2 * kRowsBytes;
  const uint32_t qd_full = kv_full + 8;      // + 8 * stage
  const float* rows = reinterpret_cast<const float*>(wg_smem + (rows_s - raw));

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kB;  // under causal the first key tiles weigh most
  const int hk = h / (p.heads / p.kv_heads);
  const int n_q = (p.len_q + kB - 1) / kB;
  const int first = p.causal ? k0 / kB : 0;  // no earlier query sees a key
  const int n_tiles = max(n_q - first, 0);
  const long long row0 = (static_cast<long long>(b) * p.heads + h) *
                         p.len_q_pad;

  // Q, dO, LSE log2(e) and D of query tile first + t into stage t % 2
  auto load_q_tile = [&](int t) {
    const int s = t & 1, q0 = (first + t) * kB;
    const uint32_t bar = qd_full + 8 * s;
    mbar_expect_tx(bar, 2 * kTile + kRowsBytes);
    for (int j = 0; j < kSub; ++j) {
      tma_load(q_s + s * kTile + j * kBoxBytes, p.q, j * kBox, q0, h, b,
               bar);
      tma_load(do_s + s * kTile + j * kBoxBytes, p.dout, j * kBox, q0, h, b,
               bar);
    }
    bulk_load(rows_s + s * kRowsBytes, p.lse2 + row0 + q0, kB * 4, bar);
    bulk_load(rows_s + s * kRowsBytes + kB * 4, p.delta + row0 + q0, kB * 4,
              bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(qd_full, 1);
    mbar_init(qd_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(kv_full, 2 * kTile);
    for (int j = 0; j < kSub; ++j) {
      tma_load(k_s + j * kBoxBytes, p.k, j * kBox, k0, hk, b, kv_full);
      tma_load(v_s + j * kBoxBytes, p.v, j * kBox, k0, hk, b, kv_full);
    }
    load_q_tile(0);
    if (n_tiles > 1) load_q_tile(1);
  }

  // A thread holds key rows r_a and r_a + 8 of the tile and, in every
  // 8-column chunk i of a fragment, columns 8 i + col_t and 8 i + col_t + 1
  // (queries in S^T and dP^T, head-dim columns in dK and dV).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_a = warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  float dk[NP / 2], dv[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const int q0 = (first + t) * kB;
    const uint32_t qs = q_s + s * kTile, dos = do_s + s * kTile;
    const float* lse2 = rows + s * 2 * kB;
    const float* dl = lse2 + kB;
    mbar_wait(qd_full + 8 * s, (t >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T, one commit group each: NP/16 steps of
    // 16 columns; a step moves 32 bytes inside a 128-byte swizzled row, or
    // on to the next box.
    float st[kB / 2], dpt[kB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(st, wgmma_desc(k_s + off, 16, 1024),
                   wgmma_desc(qs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(dpt, wgmma_desc(v_s + off, 16, 1024),
                   wgmma_desc(dos + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T may still run
    fence_regs<kB / 2>(st);

    // P^T: float32 in st (for dS^T), bf16 as the A operand, 16 queries a
    // step. Under causal a key past a query gets 0.
    const bool diag = p.causal && k0 + kB - 1 > q0;
    uint32_t pa[kB / 16][4];
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(lse2 + 8 * i + col_t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2f(fmaf(st[4 * i + e], p.scale_log2,
                             -((e & 1) ? l2.y : l2.x)));
        if (diag && r_a + 8 * (e >> 1) + k0 > q0 + 8 * i + col_t + (e & 1))
          x = 0.f;
        st[4 * i + e] = x;
      }
      pa[i >> 1][(i & 1) * 2] = pack_bf16(st[4 * i], st[4 * i + 1]);
      pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(st[4 * i + 2], st[4 * i + 3]);
    }

    // dV += P^T dO: kB/16 steps of 16 queries, 2 KB apart in every box of
    // dO (an MN-major B operand)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kB / 16; ++j)
      wgmma_pv<NP>(dv, pa[j],
                   wgmma_desc(dos + j * 16 * kRowBytes, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dV may still run
    fence_regs<kB / 2>(dpt);

    // dS^T = P^T o (dP^T - D), bf16 as the A operand
    uint32_t dsa[kB / 16][4];
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
      const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * i + col_t);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = st[4 * i + e] * (dpt[4 * i + e] - ((e & 1) ? dd.y : dd.x));
      dsa[i >> 1][(i & 1) * 2] = pack_bf16(x[0], x[1]);
      dsa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }

    // dK += dS^T Q (scaled once, at the store or in the reduction)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kB / 16; ++j)
      wgmma_pv<NP>(dk, dsa[j],
                   wgmma_desc(qs + j * 16 * kRowBytes, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs<kB / 4>(&pa[0][0]);
    keep_regs<kB / 4>(&dsa[0][0]);
    fence_regs<NP / 2>(dv);
    fence_regs<NP / 2>(dk);
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && t + 2 < n_tiles) load_q_tile(t + 2);
  }

  const int k_a = k0 + r_a;
  if (p.partial == nullptr) {  // G = 1: the gradients themselves
    __nv_bfloat16* dkg = p.dk + b * p.sdk.b + hk * p.sdk.h;
    __nv_bfloat16* dvg = p.dv + b * p.sdv.b + hk * p.sdv.h;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      const int col = 8 * i + col_t;
      if (col >= p.head_dim) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = k_a + 8 * r;
        if (kj >= p.len_k) continue;
        *reinterpret_cast<__nv_bfloat162*>(dkg + kj * p.sdk.s + col) =
            __floats2bfloat162_rn(dk[4 * i + 2 * r] * p.scale,
                                  dk[4 * i + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + kj * p.sdv.s + col) =
            __floats2bfloat162_rn(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  } else {  // this query head's partials, summed by flash_bwd_reduce_kernel
    const long long head = static_cast<long long>(p.len_k) * p.head_dim;
    const long long plane = static_cast<long long>(p.batch) * p.heads * head;
    float* pk = p.partial + (static_cast<long long>(b) * p.heads + h) * head;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      const int col = 8 * i + col_t;
      if (col >= p.head_dim) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = k_a + 8 * r;
        if (kj >= p.len_k) continue;
        float* at = pk + static_cast<long long>(kj) * p.head_dim + col;
        *reinterpret_cast<float2*>(at) =
            make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(at + plane) =
            make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kWg, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BParams p) {
  constexpr int kSub = NP / kBox;
  constexpr uint32_t kTile = kSub * kBoxBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + kTile;
  const uint32_t k_s = base + 2 * kTile;  // + stage * kTile
  const uint32_t v_s = base + 4 * kTile;  // + stage * kTile
  const uint32_t qd_full = base + 6 * kTile + 2 * kRowsBytes;
  const uint32_t kv_full = qd_full + 8;   // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;  // heaviest first
  const int hk = h / (p.heads / p.kv_heads);
  int n_k = (p.len_k + kB - 1) / kB;
  if (p.causal)  // no key past the tile's last query row is needed
    n_k = min(n_k, (min(q0 + kB, p.len_q) - 1) / kB + 1);

  // K and V of key tile t into stage t % 2
  auto load_k_tile = [&](int t) {
    const int s = t & 1;
    const uint32_t bar = kv_full + 8 * s;
    mbar_expect_tx(bar, 2 * kTile);
    for (int j = 0; j < kSub; ++j) {
      tma_load(k_s + s * kTile + j * kBoxBytes, p.k, j * kBox, t * kB, hk, b,
               bar);
      tma_load(v_s + s * kTile + j * kBoxBytes, p.v, j * kBox, t * kB, hk, b,
               bar);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    mbar_init(kv_full, 1);
    mbar_init(kv_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qd_full, 2 * kTile);
    for (int j = 0; j < kSub; ++j) {
      tma_load(q_s + j * kBoxBytes, p.q, j * kBox, q0, h, b, qd_full);
      tma_load(do_s + j * kBoxBytes, p.dout, j * kBox, q0, h, b, qd_full);
    }
    load_k_tile(0);
    if (n_k > 1) load_k_tile(1);
  }

  // A thread holds query rows row_a and row_a + 8 and, in every 8-column
  // chunk i of a fragment, columns 8 i + col_t and 8 i + col_t + 1 (keys
  // in S and dP, head-dim columns in dQ).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const long long row0 = (static_cast<long long>(b) * p.heads + h) *
                         p.len_q_pad;
  const float l2_a = p.lse2[row0 + row_a], l2_b = p.lse2[row0 + row_a + 8];
  const float d_a = p.delta[row0 + row_a], d_b = p.delta[row0 + row_a + 8];
  float dq[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dq[i] = 0.f;

  mbar_wait(qd_full, 0);
  for (int t = 0; t < n_k; ++t) {
    const int s = t & 1, k0 = t * kB;
    const uint32_t ks = k_s + s * kTile, vs = v_s + s * kTile;
    mbar_wait(kv_full + 8 * s, (t >> 1) & 1);

    // S = Q K^T and dP = dO V^T, one commit group each
    float sc[kB / 2], dp[kB / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(sc, wgmma_desc(q_s + off, 16, 1024),
                   wgmma_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(dp, wgmma_desc(do_s + off, 16, 1024),
                   wgmma_desc(vs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S is in; dP may still run
    fence_regs<kB / 2>(sc);

    // P in place; keys past Sk and, under causal, keys past the query get 0
    const bool masked =
        k0 + kB > p.len_k || (p.causal && k0 + kB - 1 > q0);
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2f(fmaf(sc[4 * i + e], p.scale_log2,
                             -(e < 2 ? l2_a : l2_b)));
        if (masked) {
          const int kj = k0 + 8 * i + col_t + (e & 1);
          const int qi = e < 2 ? row_a : row_a + 8;
          if (kj >= p.len_k || (p.causal && kj > qi)) x = 0.f;
        }
        sc[4 * i + e] = x;
      }
    }
    wgmma_wait<0>();
    fence_regs<kB / 2>(dp);

    // dS = P o (dP - D), bf16 as the A operand, 16 keys a step
    uint32_t dsa[kB / 16][4];
#pragma unroll
    for (int i = 0; i < kB / 8; ++i) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = sc[4 * i + e] * (dp[4 * i + e] - (e < 2 ? d_a : d_b));
      dsa[i >> 1][(i & 1) * 2] = pack_bf16(x[0], x[1]);
      dsa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }

    // dQ += dS K, with K as an MN-major B operand (scaled at the store)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kB / 16; ++j)
      wgmma_pv<NP>(dq, dsa[j],
                   wgmma_desc(ks + j * 16 * kRowBytes, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs<kB / 4>(&dsa[0][0]);
    fence_regs<NP / 2>(dq);
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && t + 2 < n_k) load_k_tile(t + 2);
  }

  __nv_bfloat16* dqg = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < NP / 8; ++i) {
    const int col = 8 * i + col_t;
    if (col >= p.head_dim) continue;
    if (row_a < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(dqg + row_a * p.sdq.s + col) =
          __floats2bfloat162_rn(dq[4 * i] * p.scale, dq[4 * i + 1] * p.scale);
    if (row_a + 8 < p.len_q)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (row_a + 8) * p.sdq.s + col) =
          __floats2bfloat162_rn(dq[4 * i + 2] * p.scale,
                                dq[4 * i + 3] * p.scale);
  }
}

template <int NP>
cudaError_t launch_bwd_bf16(const BParams& p,
                            const PrepParams<__nv_bfloat16>& pp,
                            const ReduceParams<__nv_bfloat16>& rp,
                            cudaStream_t stream) {
  cudaError_t err = launch_prep(pp, stream);
  if (err != cudaSuccess) return err;
  constexpr int bytes = bwd_smem_bytes<NP>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.heads, p.batch, (p.len_k + kB - 1) / kB);
  flash_bwd_dkdv_wgmma_kernel<NP><<<grid_kv, kWg, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.partial != nullptr) {
    err = launch_reduce(rp, stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(p.heads, p.batch, (p.len_q + kB - 1) / kB);
  flash_bwd_dq_wgmma_kernel<NP><<<grid_q, kWg, bytes, stream>>>(p);
  return cudaGetLastError();
}

// What both routes' entry points share: the strides, the scratch and the
// parameters of the prep and reduce kernels.
template <typename T>
struct Call {
  Strides s[8];  // q, k, v, o, dout, dq, dk, dv
  PrepParams<T> prep;
  ReduceParams<T> reduce;
  int len_q_pad;
};

template <typename T>
Call<T> unpack(const void* o, const void* dout, const void* lse, void* rows,
               void* partial, void* dk, void* dv, const long long* strides,
               int batch, int heads, int kv_heads, int len_q, int len_k,
               int head_dim, float scale) {
  Call<T> c;
  for (int i = 0; i < 8; ++i)
    c.s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  c.len_q_pad = (len_q + kTile - 1) / kTile * kTile;
  float* lse2 = static_cast<float*>(rows);
  float* delta = lse2 + static_cast<long long>(batch) * heads * c.len_q_pad;
  c.prep = PrepParams<T>{static_cast<const T*>(o), static_cast<const T*>(dout),
                         static_cast<const float*>(lse), lse2, delta, c.s[3],
                         c.s[4], batch, heads, len_q, c.len_q_pad, head_dim};
  c.reduce = ReduceParams<T>{static_cast<const float*>(partial),
                             static_cast<T*>(dk), static_cast<T*>(dv), c.s[6],
                             c.s[7], batch, heads, kv_heads, len_k, head_dim,
                             scale};
  return c;
}

bool bad_args(int heads, int kv_heads, int head_dim, const void* partial) {
  return head_dim % 16 != 0 || head_dim < 16 || head_dim > 128 ||
         (heads != kv_heads && partial == nullptr);
}

}  // namespace

// q, o, dout, dq (B, H, Sq, d) and k, v, dk, dv (B, Hkv, Sk, d) of one type,
// each addressed by its (batch, head, sequence) strides in elements, in
// this order in `strides` (a host array of 24): q, k, v, o, dout, dq, dk,
// dv. The last dim is contiguous; q, k, v and dout are 16-byte aligned and
// each of their strides of a dim longer than 1 is a multiple of 16 bytes
// (checked by the wrapper). lse (the forward's) is a contiguous (B, H, Sq)
// float32 array. Scratch: `rows` is 2 B H Sq_pad float32 (Sq_pad = Sq
// rounded up to 64), `partial` 2 B H Sk d float32 when H > Hkv (null when
// H = Hkv). The caller guarantees B, H, Hkv, Sq, Sk >= 1, H % Hkv == 0, d
// in {16, 32, 64, 80, 128}. Three launches on `stream` (two when H = Hkv):
// LSE and D, dK, dV and dQ, the reduction of dK and dV.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* partial, void* dq,
    void* dk, void* dv, const long long* strides, int batch, int heads,
    int kv_heads, int len_q, int len_k, int head_dim, int causal,
    float scale, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (bad_args(heads, kv_heads, head_dim, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call<float> c = unpack<float>(o, dout, lse, rows, partial, dk, dv,
                                      strides, batch, heads, kv_heads, len_q,
                                      len_k, head_dim, scale);
  FParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse2 = c.prep.lse2;
  p.delta = c.prep.delta;
  p.partial = heads == kv_heads ? nullptr : static_cast<float*>(partial);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.sq = c.s[0];
  p.sk = c.s[1];
  p.sv = c.s[2];
  p.sdo = c.s[4];
  p.sdq = c.s[5];
  p.sdk = c.s[6];
  p.sdv = c.s[7];
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.len_q_pad = c.len_q_pad;
  p.head_dim = head_dim;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      head_dim <= 64 ? launch_bwd_f32<64>(p, c.prep, c.reduce, s)
                     : launch_bwd_f32<128>(p, c.prep, c.reduce, s));
}

// The same contract in bf16; the 16-byte rule is TMA's, and a failed
// tensor-map encode returns the forward's error codes. Four launches on
// `stream` (three when H = Hkv): LSE and D, dK and dV, their reduction, dQ.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* partial, void* dq,
    void* dk, void* dv, const long long* strides, int batch, int heads,
    int kv_heads, int len_q, int len_k, int head_dim, int causal,
    float scale, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (bad_args(heads, kv_heads, head_dim, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call<__nv_bfloat16> c = unpack<__nv_bfloat16>(
      o, dout, lse, rows, partial, dk, dv, strides, batch, heads, kv_heads,
      len_q, len_k, head_dim, scale);
  BParams p;
  int err = encode_view(&p.q, q, batch, heads, len_q, head_dim, c.s[0], kB);
  if (err == 0)
    err = encode_view(&p.k, k, batch, kv_heads, len_k, head_dim, c.s[1], kB);
  if (err == 0)
    err = encode_view(&p.v, v, batch, kv_heads, len_k, head_dim, c.s[2], kB);
  if (err == 0)
    err = encode_view(&p.dout, dout, batch, heads, len_q, head_dim, c.s[4],
                      kB);
  if (err != 0) return err;
  p.len_q_pad = c.len_q_pad;
  p.lse2 = c.prep.lse2;
  p.delta = c.prep.delta;
  p.partial = heads == kv_heads ? nullptr : static_cast<float*>(partial);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.sdq = c.s[5];
  p.sdk = c.s[6];
  p.sdv = c.s[7];
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.len_q = len_q;
  p.len_k = len_k;
  p.head_dim = head_dim;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      head_dim <= 64 ? launch_bwd_bf16<64>(p, c.prep, c.reduce, s)
                     : launch_bwd_bf16<128>(p, c.prep, c.reduce, s));
}
