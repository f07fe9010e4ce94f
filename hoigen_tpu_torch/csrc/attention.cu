// Fused multi-head attention, forward and backward, for Hopper (sm_90a).
//
// attention_forward replaces hoigen_tpu/ops/attention.py::_attn_kernel:
//   out = softmax(q k^T * scale + key_bias) v
// and, when asked, saves each query row's max and 1/sum as (2, B, H, Lq)
// f32. attention_backward replaces ::_attn_bwd_kernel: dq, dk, dv and
// d(key_bias), from those saved statistics.
//
// Operands. q, out (B, H, Lq, D), k, v (B, H, Lk, D), dout like out, all of
// one dtype T: bf16 (the DETR encoder) or f32 (the CLIP tower in training).
// Each is read or written through its own B, H and L strides (elements; D
// has stride 1 and every row start is 16-byte aligned, which the wrapper
// checks), so the CLIP tower's (B, H, L, D) views of its (B, L, H, D)
// projections are read in place and out, dq, dk and dv are written in the
// caller's layout: no layout copy around a call. key_bias (B, Lk) f32 or
// null. Every product takes bf16 operands (round to nearest even) with f32
// accumulation, as the TPU's Precision.DEFAULT does for both dtypes. An f32
// tile lands in shared memory as f32 and is converted to bf16 rows once per
// block (to_bf16); a bf16 tile is read where it lands. Scores, row max and
// sum, delta and ds stay in f32; p is rounded to bf16 before P V and before
// p^T dout, and ds * scale before ds k and ds^T q, as in the TPU kernels.
//
// Bound on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16, 132 SMs) at
// the CLIP tower's training shape (B=4, H=12, L=197, D=64, f32): the
// forward moves q, k, v and out, 9.7 MB (2.89 us), against two products of
// 0.24 GFLOP (0.48 us) and 1.86 M exponentials (0.45 us); the backward
// moves q, k, v, out, dout, dq, dk and dv, 19.4 MB (5.78 us), against five
// products (1.2 us). Both are bound by bytes, but at this size what holds
// them back is latency: a head's 197 rows make few blocks, and each block
// walks its tiles in series. So every tile streams into shared memory by
// 16-byte cp.async copies through a ring of stages (the next tiles in
// flight while the current one's products run; no warp waits on a global
// load inside a loop), and the blocks are sized so that as many as
// possible are resident. The products stay on mma.sync m16n8k16.
//
// Forward (attn_fwd): one block per (BQ-query tile, head, batch), 16 rows a
// warp; the wrapper's _attn_plan picks BQ (32 or 64) and the ring
// depth (2 or 3). The block streams 64-key tiles of K and V (and the bias)
// through the ring, keeps an online softmax in registers and normalises p
// after the P V product, so the (Lq, Lk) scores never leave the SM. Shared
// memory at the CLIP shape (f32, BQ 64, 2 stages): 18,432 B for the q tile,
// then the converted K and V tiles, and 2 x 35,072 B of ring, 88,576 B in
// all: two blocks an SM, so the 192 blocks run in one wave.
//
// Why the statistics are saved. The TPU kernel saves no logsumexp and its
// backward recomputes the row max and sum, one extra reduction against an
// extra HBM-resident stat. On this card that recompute is a whole extra
// sweep over K in every dq block, while the two statistics are 76 KB at
// the CLIP shape (0.02 us of bytes), so the forward writes them.
//
// Backward: two launches on one stream (three with a key-bias gradient),
// each block the only writer of what it writes:
//  1. attn_bwd_delta: delta = rowsum(dout * out) in f32 from the inputs as
//     given, into a (B, H, Lq) scratch.
//  2. attn_bwd, with two block roles side by side in one grid:
//     - dq blocks (64 queries, a head, an image; bwd_dq): q and dout as A
//       fragments, then 32-key tiles of K and V through a 3-stage ring:
//       p = exp(s - max) / sum from the saved statistics, dp = dout v^T,
//       ds = p (dp - delta), dq += ds k;
//     - dk/dv blocks (64 keys; bwd_dkdv): k as bf16 rows and v as A
//       fragments, then 32-query tiles of q and dout with their max, 1/sum
//       and delta through a 3-stage ring: dv += p^T dout, dk += ds^T q, and
//       the per-head partial sums of ds for the bias gradient.
//     The block's shared memory is the larger role's, 71,808 B at f32 and
//     D 64, and the kernel is held to 168 registers, so that three blocks
//     fit an SM and the 384 blocks at the CLIP shape run in one wave.
//  3. attn_bwd_dbias sums the partials over the heads (only when the bias
//     gradient is asked for).
// The TPU kernel carries dk, dv and d(bias) from one sequential grid step
// to the next; blocks here run in parallel and in no order, so each sum
// has one owner and a fixed order instead: no atomics, and two calls give
// the same bits.
//
// Head dims. The kernels above are instantiated at D = 32 and 64 (the
// wrapper zero-pads a smaller D to one of them), which hold a row's
// operands and accumulators in registers. A D above 64 (zero-padded to a
// multiple of 64) takes the wide kernels at the end of this file instead,
// whose registers do not grow with D: see "head dims above 64" below.
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

using namespace hoigen;

namespace {

constexpr int kBK = 64;           // keys per tile of the forward
constexpr int kBwdRows = 64;      // queries of a dq block, keys of a dk/dv
constexpr int kBwdThreads = 128;  // ... block, 16 a warp
constexpr int kBQ2 = 32;          // keys (dq) or queries (dk/dv) a tile
constexpr int kDqStages = 3;      // the backward's rings
constexpr int kDkdvStages = 3;

// Shared-memory row strides, in elements: R for the rows as staged (f32
// rows padded to D + 4, 16-byte aligned for cp.async; bf16 rows to D + 8),
// B for the bf16 rows the products read (D + 8: 4-byte fragment loads and
// ldmatrix free of bank conflicts). An f32 tile is converted from R rows
// to B rows once per block; a bf16 tile is read where it landed.
template <typename T, int D>
struct Pad {
  static constexpr int R = sizeof(T) == 4 ? D + 4 : D + 8;
  static constexpr int B = D + 8;
  static constexpr bool kConvert = sizeof(T) == 4;
  // bytes of `rows` converted bf16 rows (none for bf16 operands)
  static constexpr int conv(int rows) { return kConvert ? rows * B * 2 : 0; }
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T>
struct Io;

template <>
struct Io<bf16> {
  static __device__ __forceinline__ uint4 load8(const bf16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ float2 load2(const bf16* p) {
    return unpack_bf16(ld32(p));
  }
  static __device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ uint4 load8(const float* p) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                      pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// two consecutive values of a shared-memory row as one register of two
// bf16 (an f32 pair is rounded here)
__device__ __forceinline__ uint32_t pair(const bf16* p) { return ld32(p); }

__device__ __forceinline__ uint32_t pair(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16(x.x, x.y);
}

// rows [r0, r0 + ROWS) of a matrix with row stride ld (elements) into
// shared memory with row stride S, by 16-byte cp.async (each thread keeps
// one column and steps down the rows); rows at or past L are zero-filled
template <typename T, int D, int S, int NT, int ROWS>
__device__ __forceinline__ void stage_async(T* dst, const T* src,
                                            long long ld, int r0, int L,
                                            int tid) {
  constexpr int PER = 16 / sizeof(T), CH = D / PER, STEP = NT / CH;
  static_assert(NT % CH == 0, "whole rows a pass");
  const int c = (tid % CH) * PER, rt = tid / CH;
  const T* from = src + (r0 + rt) * ld + c;
  T* to = dst + rt * S + c;
#pragma unroll
  for (int k = 0; k < (ROWS + STEP - 1) / STEP; ++k) {
    const int r = rt + k * STEP;
    if (ROWS % STEP == 0 || r < ROWS) {
      const bool in = r0 + r < L;
      cp_async16(to + k * STEP * S, in ? from + k * STEP * ld : src, in);
    }
  }
}

// src[i0 .. i0 + N) into shared memory by 4-byte cp.async, zero at or past
// index `valid`
template <int NT, int N>
__device__ __forceinline__ void stage_vec_async(float* dst, const float* src,
                                                int i0, int valid, int tid) {
#pragma unroll
  for (int i = tid; i < N; i += NT) {
    const bool in = i0 + i < valid;
    cp_async4(dst + i, in ? src + i0 + i : src, in);
  }
}

// A fragments of a warp's 16 rows (row stride S) over the whole depth D
template <int D, int S, typename T>
__device__ __forceinline__ void load_afrag(uint32_t a[D / 16][4],
                                           const T* rows, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = pair(rows + g * S + kk * 16 + 2 * t);
    a[kk][1] = pair(rows + (g + 8) * S + kk * 16 + 2 * t);
    a[kk][2] = pair(rows + g * S + kk * 16 + 2 * t + 8);
    a[kk][3] = pair(rows + (g + 8) * S + kk * 16 + 2 * t + 8);
  }
}

// c[j] (n-tile j of N columns) = A (16 x D, fragments a) times B^T, where B
// is stored (n, d) row-major as bf16 in shared memory with row stride S
template <int D, int N, int S>
__device__ __forceinline__ void mma_abt(float c[N / 8][4],
                                        uint32_t a[D / 16][4], const bf16* b,
                                        int g, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const bf16* row = b + (j * 8 + g) * S;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_bf16(c[j], a[kk], ld32(row + kk * 16 + 2 * t),
               ld32(row + kk * 16 + 2 * t + 8));
  }
}

// the A fragment of k-step kk of P (16 x K, the f32 accumulator fragments
// p), rounded to bf16
template <int K>
__device__ __forceinline__ void p_frag(uint32_t pa[4], float p[K / 8][4],
                                       int kk) {
  pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
  pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
  pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// acc (16 x D) += P (16 x K, accumulator fragments) times B, where B is
// stored (k, d) row-major in shared memory with row stride S: bf16 rows by
// ldmatrix.trans
template <int K, int D, int S>
__device__ __forceinline__ void mma_pb(float acc[D / 8][4],
                                       float p[K / 8][4], const bf16* b,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t pa[4];
    p_frag<K>(pa, p, kk);
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t bl[4];
      ldsm_x4_trans(bl, b + (kk * 16 + (lane & 15)) * S + jp * 16 +
                            (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], pa, bl[0], bl[1]);
      mma_bf16(acc[2 * jp + 1], pa, bl[2], bl[3]);
    }
  }
}

// rows x D of an f32 tile staged with row stride D + 4 into bf16 rows with
// row stride D + 8 (round to nearest even), by all NT threads of the block
template <int D, int NT>
__device__ __forceinline__ void to_bf16(bf16* dst, const float* src,
                                        int rows, int tid) {
  constexpr int CH = D / 4;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * (D + 4) + c);
    *reinterpret_cast<uint2*>(dst + r * (D + 8) + c) =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

// the bf16 rows the products read of a staged tile: an f32 tile is
// converted into `conv` by all threads (the caller then waits at a
// barrier), a bf16 tile is read where it landed
template <typename T, int D, int NT>
__device__ __forceinline__ const bf16* as_bf16(const T* tile, bf16* conv,
                                               int rows, int tid) {
  if constexpr (Pad<T, D>::kConvert) {
    to_bf16<D, NT>(conv, tile, rows, tid);
    return conv;
  } else {
    return tile;
  }
}

// s = s * scale + bias for the tile of keys from k0 (sBias null: no bias);
// keys at or past Lk get -inf
template <int N>
__device__ __forceinline__ void bias_scores(float s[N / 8][4],
                                            const float* sBias, int k0,
                                            int Lk, float scale, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j * 8 + 2 * t + e;
      const float b =
          k0 + col < Lk ? (sBias ? sBias[col] : 0.f) : -INFINITY;
      s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), b);
      s[j][e + 2] = __fadd_rn(__fmul_rn(s[j][e + 2], scale), b);
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

// ------------------------------------------------------------- forward
struct FwdArgs {
  const void *q, *k, *v;
  const float* bias;       // (B, Lk) or null
  void* out;
  float* stats;            // (2, B, H, Lq): row max, 1/sum; or null
  long long sq[3], sk[3], sv[3], so[3];   // B, H, L strides (elements)
  int H, Lq, Lk;
  float scale;
};

template <typename T, int D, int NW, int STAGES>
struct FwdSmem {
  using P = Pad<T, D>;
  static constexpr int BQ = NW * 16;
  // the q tile as staged, then (f32) the converted K and V tiles
  static constexpr int A =
      cmax(BQ * P::R * sizeof(T), P::conv(2 * kBK));
  static constexpr int TILE = kBK * P::R * sizeof(T);
  static constexpr int STAGE = 2 * TILE + kBK * 4;       // k, v, bias
  static constexpr int BYTES = A + STAGES * STAGE;
};

template <typename T, int D, int NW, int STAGES>
__global__ void __launch_bounds__(NW * 32) attn_fwd(FwdArgs a) {
  using L = FwdSmem<T, D, NW, STAGES>;
  using P = Pad<T, D>;
  constexpr int NT = NW * 32, SR = P::R, SB = P::B;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  bf16* cK = reinterpret_cast<bf16*>(smem);
  bf16* cV = cK + kBK * SB;
  unsigned char* ring = smem + L::A;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* biasb = a.bias ? a.bias + (size_t)b * a.Lk : nullptr;
  const int n_tiles = (a.Lk + kBK - 1) / kBK;

  auto tile_k = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::STAGE);
  };
  auto tile_v = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::STAGE + L::TILE);
  };
  auto tile_b = [&](int s) {
    return reinterpret_cast<float*>(ring + s * L::STAGE + 2 * L::TILE);
  };
  auto issue = [&](int tile) {
    const int s = tile % STAGES, k0 = tile * kBK;
    stage_async<T, D, SR, NT, kBK>(tile_k(s), kb, a.sk[2], k0, a.Lk, tid);
    stage_async<T, D, SR, NT, kBK>(tile_v(s), vb, a.sv[2], k0, a.Lk, tid);
    if (biasb) stage_vec_async<NT, kBK>(tile_b(s), biasb, k0, a.Lk, tid);
  };

  // group 0: the q tile and key tile 0; then one group a key tile
  stage_async<T, D, SR, NT, L::BQ>(sQ, qb, a.sq[2], q0, a.Lq, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  uint32_t qa[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                     // this thread's partial sums
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();               // tile `it` has landed
    __syncthreads();                           // ... for every thread, and
                                               // tile it - 1 is consumed
    if (it + STAGES - 1 < n_tiles) issue(it + STAGES - 1);
    cp_async_commit();
    if (it == 0) {
      load_afrag<D, SR>(qa, sQ + warp * 16 * SR, g, t);
      if constexpr (P::kConvert) __syncthreads();   // cK overwrites sQ
    }
    const int s = it % STAGES;
    const bf16* kt = as_bf16<T, D, NT>(tile_k(s), cK, kBK, tid);
    const bf16* vt = as_bf16<T, D, NT>(tile_v(s), cV, kBK, tid);
    if constexpr (P::kConvert) __syncthreads();

    float sc[kBK / 8][4];
    mma_abt<D, kBK, SB>(sc, qa, kt, g, t);
    bias_scores<kBK>(sc, biasb ? tile_b(s) : nullptr, it * kBK, a.Lk,
                     a.scale, t);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = m[r] == -INFINITY ? 0.f : __expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[j][0] = __expf(sc[j][0] - m[0]);
      sc[j][1] = __expf(sc[j][1] - m[0]);
      sc[j][2] = __expf(sc[j][2] - m[1]);
      sc[j][3] = __expf(sc[j][3] - m[1]);
      l[0] += sc[j][0] + sc[j][1];
      l[1] += sc[j][2] + sc[j][3];
    }
    mma_pb<kBK, D, SB>(o, sc, vt, lane);
  }

  const float inv0 = 1.f / quad_sum(l[0]), inv1 = 1.f / quad_sum(l[1]);
  T* ob = static_cast<T*>(a.out) + b * a.so[0] + h * a.so[1];
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < a.Lq)
      Io<T>::store2(ob + r0 * a.so[2] + c, o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < a.Lq)
      Io<T>::store2(ob + r1 * a.so[2] + c, o[j][2] * inv1, o[j][3] * inv1);
  }
  if (a.stats && t == 0) {
    const size_t rows = (size_t)gridDim.z * a.H * a.Lq;
    float* st = a.stats + ((size_t)b * a.H + h) * a.Lq;
    if (r0 < a.Lq) { st[r0] = m[0]; st[rows + r0] = inv0; }
    if (r1 < a.Lq) { st[r1] = m[1]; st[rows + r1] = inv1; }
  }
}

// ------------------------------------------------------------ backward
struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* bias;       // (B, Lk) or null
  const float* stats;      // (2, B, H, Lq) from the forward
  float* delta;            // (B, H, Lq): launch 1 writes, launch 2 reads
  void *dq, *dk, *dv;
  float* dbias_part;       // (B, H, Lk) or null
  long long sq[3], sk[3], sv[3], so[3], sd[3], sdq[3], sdk[3], sdv[3];
  int H, Lq, Lk;
  float scale;
};

// rows [r0, r0 + ROWS) of a matrix (row stride ld) into bf16 shared rows
// with row stride SB, rounded; rows at or past L are zero. Plain loads,
// once per block before its streamed loop
template <typename T, int D, int SB, int NT, int ROWS>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const T* src,
                                               long long ld, int r0, int L,
                                               int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < L) val = Io<T>::load8(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * SB + c) = val;
  }
}

// A fragments of a warp's 16 rows [r0, r0 + 16) read straight from global
// memory (row stride ld elements; rows at or past L are zero), rounded to
// bf16: read once per block, before the streamed loop
template <int D, typename T>
__device__ __forceinline__ void load_afrag_global(uint32_t a[D / 16][4],
                                                  const T* base,
                                                  long long ld, int r0,
                                                  int L, int g, int t) {
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const float2 z = make_float2(0.f, 0.f);
    const float2 x0 = ra < L ? Io<T>::load2(base + ra * ld + c) : z;
    const float2 x1 = rb < L ? Io<T>::load2(base + rb * ld + c) : z;
    const float2 x2 = ra < L ? Io<T>::load2(base + ra * ld + c + 8) : z;
    const float2 x3 = rb < L ? Io<T>::load2(base + rb * ld + c + 8) : z;
    a[kk][0] = pack_bf16(x0.x, x0.y);
    a[kk][1] = pack_bf16(x1.x, x1.y);
    a[kk][2] = pack_bf16(x2.x, x2.y);
    a[kk][3] = pack_bf16(x3.x, x3.y);
  }
}

// launch 1: delta = rowsum(dout * out) in f32 from the inputs as given, a
// quad of threads a query row (thread t takes columns 8j + 2t and 8j + 2t
// + 1, then the quad's parts are summed)
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) attn_bwd_delta(BwdArgs a) {
  const int tid = threadIdx.x, t = tid & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * (kBwdThreads / 4) + (tid >> 2);
  float s = 0.f;
  if (row < a.Lq) {
    const T* x = static_cast<const T*>(a.dout) + b * a.sd[0] +
                 h * a.sd[1] + row * a.sd[2];
    const T* y = static_cast<const T*>(a.o) + b * a.so[0] + h * a.so[1] +
                 row * a.so[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 u = Io<T>::load2(x + c), w = Io<T>::load2(y + c);
      s += u.x * w.x + u.y * w.y;
    }
  }
  s = quad_sum(s);
  if (row < a.Lq && t == 0)
    a.delta[((size_t)b * a.H + h) * a.Lq + row] = s;
}

// Shared memory of the backward's block roles; the launch gives every
// block the larger of the two
template <typename T, int D>
struct DqSmem {
  using P = Pad<T, D>;
  static constexpr int CONV = P::conv(2 * kBQ2);        // k, v (f32 only)
  static constexpr int TILE = kBQ2 * P::R * sizeof(T);
  static constexpr int STAGE = 2 * TILE + kBQ2 * 4;     // k, v, bias
  static constexpr int BYTES = CONV + kDqStages * STAGE;
};

template <typename T, int D>
struct DkdvSmem {
  using P = Pad<T, D>;
  static constexpr int CONV = P::conv(2 * kBQ2);        // q, dout
  static constexpr int KEYS = kBwdRows * P::B * 2;      // the block's k
  static constexpr int TILE = kBQ2 * P::R * sizeof(T);
  // q, dout; max, 1/sum, delta
  static constexpr int STAGE = 2 * TILE + 3 * kBQ2 * 4;
  static constexpr int BYTES = CONV + KEYS + kDkdvStages * STAGE;
};

// role 1: dq for 64 query rows (16 a warp), sweeping the keys in tiles of
// kBQ2 through a ring of kDqStages
template <typename T, int D>
__device__ __forceinline__ void bwd_dq(const BwdArgs& a, int q0,
                                       unsigned char* smem) {
  using L = DqSmem<T, D>;
  using P = Pad<T, D>;
  constexpr int NT = kBwdThreads, SR = P::R, SB = P::B, BK = kBQ2;
  bf16* cK = reinterpret_cast<bf16*>(smem);
  bf16* cV = cK + BK * SB;
  unsigned char* ring = smem + L::CONV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* db = static_cast<const T*>(a.dout) + b * a.sd[0] + h * a.sd[1];
  const float* biasb = a.bias ? a.bias + (size_t)b * a.Lk : nullptr;
  const size_t rows = (size_t)gridDim.z * a.H * a.Lq;
  const size_t bh = ((size_t)b * a.H + h) * a.Lq;
  const int n_tiles = (a.Lk + BK - 1) / BK;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  auto tile_k = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::STAGE);
  };
  auto tile_v = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::STAGE + L::TILE);
  };
  auto tile_b = [&](int s) {
    return reinterpret_cast<float*>(ring + s * L::STAGE + 2 * L::TILE);
  };
  auto issue = [&](int tile) {
    const int s = tile % kDqStages, k0 = tile * BK;
    stage_async<T, D, SR, NT, BK>(tile_k(s), kb, a.sk[2], k0, a.Lk, tid);
    stage_async<T, D, SR, NT, BK>(tile_v(s), vb, a.sv[2], k0, a.Lk, tid);
    if (biasb) stage_vec_async<NT, BK>(tile_b(s), biasb, k0, a.Lk, tid);
  };
#pragma unroll
  for (int s = 0; s < kDqStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // while those land: q and dout as A fragments, the forward's row
  // statistics (a query past Lq gets p = exp(x - inf) * 0 = 0) and delta
  // from launch 1
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_afrag_global<D>(qa, qb, a.sq[2], q0 + warp * 16, a.Lq, g, t);
  load_afrag_global<D>(da, db, a.sd[2], q0 + warp * 16, a.Lq, g, t);
  float m[2], inv[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    const bool in = row < a.Lq;
    m[r] = in ? a.stats[bh + row] : INFINITY;
    inv[r] = in ? a.stats[rows + bh + row] : 0.f;
    delta[r] = in ? a.delta[bh + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kDqStages - 2>();            // tile `it` has landed
    __syncthreads();                           // ... for every thread, and
                                               // tile it - 1 is consumed
    if (it + kDqStages - 1 < n_tiles) issue(it + kDqStages - 1);
    cp_async_commit();
    const int s = it % kDqStages;
    const bf16* kt = as_bf16<T, D, NT>(tile_k(s), cK, BK, tid);
    const bf16* vt = as_bf16<T, D, NT>(tile_v(s), cV, BK, tid);
    if constexpr (P::kConvert) __syncthreads();

    float sc[BK / 8][4], dp[BK / 8][4];
    mma_abt<D, BK, SB>(sc, qa, kt, g, t);
    bias_scores<BK>(sc, biasb ? tile_b(s) : nullptr, it * BK, a.Lk,
                    a.scale, t);
    mma_abt<D, BK, SB>(dp, da, vt, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __expf(sc[j][e] - m[r]) * inv[r];
        sc[j][e] = p * (dp[j][e] - delta[r]) * a.scale;   // ds * scale
      }
    }
    mma_pb<BK, D, SB>(acc, sc, kt, lane);
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < a.Lq)
      Io<T>::store2(dqb + r0 * a.sdq[2] + c, acc[j][0], acc[j][1]);
    if (r1 < a.Lq)
      Io<T>::store2(dqb + r1 * a.sdq[2] + c, acc[j][2], acc[j][3]);
  }
}

// role 2: dk, dv and the per-head partial sums of the bias gradient for 64
// keys (16 a warp), sweeping the queries in tiles of kBQ2 through a ring of
// kDkdvStages
template <typename T, int D>
__device__ __forceinline__ void bwd_dkdv(const BwdArgs& a, int k0,
                                         unsigned char* smem) {
  using L = DkdvSmem<T, D>;
  using P = Pad<T, D>;
  constexpr int NT = kBwdThreads, SR = P::R, SB = P::B, BQ = kBQ2;
  bf16* cQ = reinterpret_cast<bf16*>(smem);
  bf16* cDo = cQ + BQ * SB;
  bf16* sK = reinterpret_cast<bf16*>(smem + L::CONV);
  unsigned char* ring = smem + L::CONV + L::KEYS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* db = static_cast<const T*>(a.dout) + b * a.sd[0] + h * a.sd[1];
  const size_t rows = (size_t)gridDim.z * a.H * a.Lq;
  const size_t bh = ((size_t)b * a.H + h) * a.Lq;
  const int n_tiles = (a.Lq + BQ - 1) / BQ;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;   // this thread's keys

  auto tile_q = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::STAGE);
  };
  auto tile_do = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::STAGE + L::TILE);
  };
  auto tile_stat = [&](int s) {        // max, 1/sum, delta: BQ each
    return reinterpret_cast<float*>(ring + s * L::STAGE + 2 * L::TILE);
  };
  auto issue = [&](int tile) {
    const int s = tile % kDkdvStages, q0 = tile * BQ;
    stage_async<T, D, SR, NT, BQ>(tile_q(s), qb, a.sq[2], q0, a.Lq, tid);
    stage_async<T, D, SR, NT, BQ>(tile_do(s), db, a.sd[2], q0, a.Lq, tid);
    float* st = tile_stat(s);
    stage_vec_async<NT, BQ>(st, a.stats + bh, q0, a.Lq, tid);
    stage_vec_async<NT, BQ>(st + BQ, a.stats + rows + bh, q0, a.Lq, tid);
    stage_vec_async<NT, BQ>(st + 2 * BQ, a.delta + bh, q0, a.Lq, tid);
  };
#pragma unroll
  for (int s = 0; s < kDkdvStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // while those land: the block's k as bf16 rows (its A fragments are
  // built from them for each tile, which keeps the role within the
  // registers that three blocks an SM leave), v as A fragments, and this
  // thread's key bias
  load_rows_bf16<T, D, SB, NT, kBwdRows>(sK, kb, a.sk[2], k0, a.Lk, tid);
  uint32_t va[D / 16][4];
  load_afrag_global<D>(va, vb, a.sv[2], k0 + warp * 16, a.Lk, g, t);
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? kr1 : kr0;
    kbias[r] = key < a.Lk
                   ? (a.bias ? a.bias[(size_t)b * a.Lk + key] : 0.f)
                   : -INFINITY;
  }

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dkacc[j][0] = dkacc[j][1] = dkacc[j][2] = dkacc[j][3] = 0.f;
    dvacc[j][0] = dvacc[j][1] = dvacc[j][2] = dvacc[j][3] = 0.f;
  }
  float dbias[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kDkdvStages - 2>();
    __syncthreads();
    if (it + kDkdvStages - 1 < n_tiles) issue(it + kDkdvStages - 1);
    cp_async_commit();
    const int s = it % kDkdvStages, q0 = it * BQ;
    const float* sM = tile_stat(s);
    const float* sInv = sM + BQ;
    const float* sDelta = sM + 2 * BQ;
    const bf16* qt = as_bf16<T, D, NT>(tile_q(s), cQ, BQ, tid);
    const bf16* dt = as_bf16<T, D, NT>(tile_do(s), cDo, BQ, tid);
    if constexpr (P::kConvert) __syncthreads();

    // p^T and dp^T for this warp's 16 keys and the tile's queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
    {
      uint32_t ka[D / 16][4];
      load_afrag<D, SB>(ka, sK + warp * 16 * SB, g, t);
      mma_abt<D, BQ, SB>(st, ka, qt, g, t);
    }
    mma_abt<D, BQ, SB>(dpt, va, dt, g, t);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      // the statistics of this thread's two query columns, as pairs
      const int c0 = j * 8 + 2 * t;
      const float2 mj = *reinterpret_cast<const float2*>(sM + c0);
      const float2 ij = *reinterpret_cast<const float2*>(sInv + c0);
      const float2 dj = *reinterpret_cast<const float2*>(sDelta + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, odd = e & 1;
        const float x = __fadd_rn(__fmul_rn(st[j][e], a.scale), kbias[r]);
        const float p = q0 + c0 + odd < a.Lq
                            ? __expf(x - (odd ? mj.y : mj.x)) *
                                  (odd ? ij.y : ij.x)
                            : 0.f;
        const float ds = p * (dpt[j][e] - (odd ? dj.y : dj.x));
        dbias[r] += ds;
        st[j][e] = p;
        dpt[j][e] = ds * a.scale;
      }
    }
    mma_pb<BQ, D, SB>(dvacc, st, dt, lane);
    mma_pb<BQ, D, SB>(dkacc, dpt, qt, lane);
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.sdk[0] + h * a.sdk[1];
  T* dvb = static_cast<T*>(a.dv) + b * a.sdv[0] + h * a.sdv[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (kr0 < a.Lk) {
      Io<T>::store2(dkb + kr0 * a.sdk[2] + c, dkacc[j][0], dkacc[j][1]);
      Io<T>::store2(dvb + kr0 * a.sdv[2] + c, dvacc[j][0], dvacc[j][1]);
    }
    if (kr1 < a.Lk) {
      Io<T>::store2(dkb + kr1 * a.sdk[2] + c, dkacc[j][2], dkacc[j][3]);
      Io<T>::store2(dvb + kr1 * a.sdv[2] + c, dvacc[j][2], dvacc[j][3]);
    }
  }
  if (a.dbias_part) {
    dbias[0] = quad_sum(dbias[0]);
    dbias[1] = quad_sum(dbias[1]);
    if (t == 0) {
      const size_t base = ((size_t)b * a.H + h) * a.Lk;
      if (kr0 < a.Lk) a.dbias_part[base + kr0] = dbias[0];
      if (kr1 < a.Lk) a.dbias_part[base + kr1] = dbias[1];
    }
  }
}

// launch 2: blocks [0, nq) of x are dq blocks, the rest dk/dv blocks
// at most 168 registers, so that three blocks (and their 62 KB of shared
// memory each at f32, D 64) fit an SM and both roles' 384 blocks at the
// CLIP shape run in one wave
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 3)
    attn_bwd(BwdArgs a, int nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < nq)
    bwd_dq<T, D>(a, blockIdx.x * kBwdRows, smem);
  else
    bwd_dkdv<T, D>(a, (blockIdx.x - nq) * kBwdRows, smem);
}

// launch 3: d(key_bias) = the sum over heads of the dk/dv blocks' partials
__global__ void attn_bwd_dbias(const float* __restrict__ part,
                               float* __restrict__ dbias, int B, int H,
                               int Lk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Lk) return;
  const int b = i / Lk, key = i % Lk;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += part[((size_t)b * H + h) * Lk + key];
  dbias[i] = s;
}

// ------------------------------------------------ head dims above 64
// A head dim D > 64, zero-padded by the wrapper to a multiple of 64, takes
// these kernels, so that every D the TPU kernels take runs on the card.
// Each block owns one 64-column slice of its rows' output (out in the
// forward; dq, or dk and dv, in the backward): it sweeps the scores q k^T,
// and in the backward dout v^T, over the whole depth in 64-column chunks,
// then multiplies only its own slice. A thread's registers are those of
// D = 64 whatever D is; the price is that the D / 64 blocks of a row tile
// each recompute its scores, and that the chunks are staged by plain loads
// (no ring). The rounding points, the online softmax, the saved statistics
// and the backward's launches are those of the kernels above, and a score
// accumulates over the depth in the same order.
constexpr int kW = 64;            // columns of a chunk and of a slice
constexpr int kWS = kW + 8;       // bf16 row stride of a staged chunk

// c (16 x N) += A (16 x kW, fragments a) times B^T, where B is stored
// (n, kW) row-major as bf16 in shared memory with row stride S
template <int N, int S>
__device__ __forceinline__ void mma_abt_acc(float c[N / 8][4],
                                            uint32_t a[kW / 16][4],
                                            const bf16* b, int g, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const bf16* row = b + (j * 8 + g) * S;
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk)
      mma_bf16(c[j], a[kk], ld32(row + kk * 16 + 2 * t),
               ld32(row + kk * 16 + 2 * t + 8));
  }
}

template <int N>
__device__ __forceinline__ void zero_frags(float c[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// forward: one block per (64-query tile x output slice, head, batch)
template <typename T>
__global__ void __launch_bounds__(128) attn_fwd_wide(FwdArgs a, int D) {
  constexpr int NT = 128;
  __shared__ __align__(16) bf16 sK[kBK * kWS];
  __shared__ __align__(16) bf16 sV[kBK * kWS];
  __shared__ float sBias[kBK];

  const int nc = D / kW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int col = (blockIdx.x % nc) * kW;              // the output slice
  const int w0 = (blockIdx.x / nc) * 64 + warp * 16;   // the warp's rows
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* biasb = a.bias ? a.bias + (size_t)b * a.Lk : nullptr;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kW / 8][4];
  zero_frags<kW>(o);

  for (int k0 = 0; k0 < a.Lk; k0 += kBK) {
    float sc[kBK / 8][4];
    zero_frags<kBK>(sc);
    for (int c = 0; c < D; c += kW) {
      uint32_t qa[kW / 16][4];
      load_afrag_global<kW>(qa, qb + c, a.sq[2], w0, a.Lq, g, t);
      __syncthreads();                     // the last chunk is consumed
      load_rows_bf16<T, kW, kWS, NT, kBK>(sK, kb + c, a.sk[2], k0, a.Lk,
                                          tid);
      __syncthreads();
      mma_abt_acc<kBK, kWS>(sc, qa, sK, g, t);
    }
    load_rows_bf16<T, kW, kWS, NT, kBK>(sV, vb + col, a.sv[2], k0, a.Lk,
                                        tid);
    if (biasb)
      for (int i = tid; i < kBK; i += NT)
        sBias[i] = k0 + i < a.Lk ? biasb[k0 + i] : 0.f;
    __syncthreads();
    bias_scores<kBK>(sc, biasb ? sBias : nullptr, k0, a.Lk, a.scale, t);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = m[r] == -INFINITY ? 0.f : __expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kW / 8; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[j][0] = __expf(sc[j][0] - m[0]);
      sc[j][1] = __expf(sc[j][1] - m[0]);
      sc[j][2] = __expf(sc[j][2] - m[1]);
      sc[j][3] = __expf(sc[j][3] - m[1]);
      l[0] += sc[j][0] + sc[j][1];
      l[1] += sc[j][2] + sc[j][3];
    }
    mma_pb<kBK, kW, kWS>(o, sc, sV, lane);
  }

  const float inv0 = 1.f / quad_sum(l[0]), inv1 = 1.f / quad_sum(l[1]);
  T* ob = static_cast<T*>(a.out) + b * a.so[0] + h * a.so[1] + col;
  const int r0 = w0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kW / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < a.Lq)
      Io<T>::store2(ob + r0 * a.so[2] + c, o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < a.Lq)
      Io<T>::store2(ob + r1 * a.so[2] + c, o[j][2] * inv1, o[j][3] * inv1);
  }
  if (a.stats && col == 0 && t == 0) {     // one slice writes the stats
    const size_t rows = (size_t)gridDim.z * a.H * a.Lq;
    float* st = a.stats + ((size_t)b * a.H + h) * a.Lq;
    if (r0 < a.Lq) { st[r0] = m[0]; st[rows + r0] = inv0; }
    if (r1 < a.Lq) { st[r1] = m[1]; st[rows + r1] = inv1; }
  }
}

// backward launch 1 at any D (a multiple of 8): attn_bwd_delta's sum
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_delta_wide(BwdArgs a, int D) {
  const int tid = threadIdx.x, t = tid & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * (kBwdThreads / 4) + (tid >> 2);
  float s = 0.f;
  if (row < a.Lq) {
    const T* x = static_cast<const T*>(a.dout) + b * a.sd[0] +
                 h * a.sd[1] + row * a.sd[2];
    const T* y = static_cast<const T*>(a.o) + b * a.so[0] + h * a.so[1] +
                 row * a.so[2];
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 u = Io<T>::load2(x + c), w = Io<T>::load2(y + c);
      s += u.x * w.x + u.y * w.y;
    }
  }
  s = quad_sum(s);
  if (row < a.Lq && t == 0)
    a.delta[((size_t)b * a.H + h) * a.Lq + row] = s;
}

// role 1: dq's slice [col, col + kW) for 64 query rows, sweeping the keys
// in tiles of kBQ2
template <typename T>
__device__ __forceinline__ void bwd_dq_wide(const BwdArgs& a, int D, int q0,
                                            int col) {
  constexpr int NT = kBwdThreads, BK = kBQ2;
  __shared__ __align__(16) bf16 sK[BK * kWS];     // a chunk of k, of v,
  __shared__ __align__(16) bf16 sV[BK * kWS];
  __shared__ __align__(16) bf16 sKc[BK * kWS];    // ... and k's slice
  __shared__ float sBias[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* db = static_cast<const T*>(a.dout) + b * a.sd[0] + h * a.sd[1];
  const float* biasb = a.bias ? a.bias + (size_t)b * a.Lk : nullptr;
  const size_t rows = (size_t)gridDim.z * a.H * a.Lq;
  const size_t bh = ((size_t)b * a.H + h) * a.Lq;
  const int w0 = q0 + warp * 16, r0 = w0 + g, r1 = r0 + 8;

  float m[2], inv[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    const bool in = row < a.Lq;
    m[r] = in ? a.stats[bh + row] : INFINITY;
    inv[r] = in ? a.stats[rows + bh + row] : 0.f;
    delta[r] = in ? a.delta[bh + row] : 0.f;
  }
  float acc[kW / 8][4];
  zero_frags<kW>(acc);

  for (int k0 = 0; k0 < a.Lk; k0 += BK) {
    float sc[BK / 8][4], dp[BK / 8][4];
    zero_frags<BK>(sc);
    zero_frags<BK>(dp);
    for (int c = 0; c < D; c += kW) {
      uint32_t qa[kW / 16][4], da[kW / 16][4];
      load_afrag_global<kW>(qa, qb + c, a.sq[2], w0, a.Lq, g, t);
      load_afrag_global<kW>(da, db + c, a.sd[2], w0, a.Lq, g, t);
      __syncthreads();
      load_rows_bf16<T, kW, kWS, NT, BK>(sK, kb + c, a.sk[2], k0, a.Lk, tid);
      load_rows_bf16<T, kW, kWS, NT, BK>(sV, vb + c, a.sv[2], k0, a.Lk, tid);
      __syncthreads();
      mma_abt_acc<BK, kWS>(sc, qa, sK, g, t);
      mma_abt_acc<BK, kWS>(dp, da, sV, g, t);
    }
    load_rows_bf16<T, kW, kWS, NT, BK>(sKc, kb + col, a.sk[2], k0, a.Lk,
                                       tid);
    if (biasb)
      for (int i = tid; i < BK; i += NT)
        sBias[i] = k0 + i < a.Lk ? biasb[k0 + i] : 0.f;
    __syncthreads();
    bias_scores<BK>(sc, biasb ? sBias : nullptr, k0, a.Lk, a.scale, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __expf(sc[j][e] - m[r]) * inv[r];
        sc[j][e] = p * (dp[j][e] - delta[r]) * a.scale;   // ds * scale
      }
    }
    mma_pb<BK, kW, kWS>(acc, sc, sKc, lane);
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.sdq[0] + h * a.sdq[1] + col;
#pragma unroll
  for (int j = 0; j < kW / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < a.Lq)
      Io<T>::store2(dqb + r0 * a.sdq[2] + c, acc[j][0], acc[j][1]);
    if (r1 < a.Lq)
      Io<T>::store2(dqb + r1 * a.sdq[2] + c, acc[j][2], acc[j][3]);
  }
}

// role 2: the slices [col, col + kW) of dk and dv for 64 keys, and (the
// block of slice 0) the per-head partial sums of the bias gradient,
// sweeping the queries in tiles of kBQ2
template <typename T>
__device__ __forceinline__ void bwd_dkdv_wide(const BwdArgs& a, int D,
                                              int k0, int col) {
  constexpr int NT = kBwdThreads, BQ = kBQ2;
  __shared__ __align__(16) bf16 sQ[BQ * kWS];     // a chunk of q, of dout,
  __shared__ __align__(16) bf16 sDo[BQ * kWS];
  __shared__ __align__(16) bf16 sQc[BQ * kWS];    // ... and their slices
  __shared__ __align__(16) bf16 sDoc[BQ * kWS];
  __shared__ __align__(16) float sStat[3 * BQ];   // max, 1/sum, delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* db = static_cast<const T*>(a.dout) + b * a.sd[0] + h * a.sd[1];
  const size_t rows = (size_t)gridDim.z * a.H * a.Lq;
  const size_t bh = ((size_t)b * a.H + h) * a.Lq;
  const int w0 = k0 + warp * 16, kr0 = w0 + g, kr1 = kr0 + 8;

  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? kr1 : kr0;
    kbias[r] = key < a.Lk
                   ? (a.bias ? a.bias[(size_t)b * a.Lk + key] : 0.f)
                   : -INFINITY;
  }
  float dkacc[kW / 8][4], dvacc[kW / 8][4];
  zero_frags<kW>(dkacc);
  zero_frags<kW>(dvacc);
  float dbias[2] = {0.f, 0.f};

  for (int q0 = 0; q0 < a.Lq; q0 += BQ) {
    // p^T and dp^T for this warp's 16 keys and the tile's queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
    zero_frags<BQ>(st);
    zero_frags<BQ>(dpt);
    for (int c = 0; c < D; c += kW) {
      uint32_t ka[kW / 16][4], va[kW / 16][4];
      load_afrag_global<kW>(ka, kb + c, a.sk[2], w0, a.Lk, g, t);
      load_afrag_global<kW>(va, vb + c, a.sv[2], w0, a.Lk, g, t);
      __syncthreads();
      load_rows_bf16<T, kW, kWS, NT, BQ>(sQ, qb + c, a.sq[2], q0, a.Lq, tid);
      load_rows_bf16<T, kW, kWS, NT, BQ>(sDo, db + c, a.sd[2], q0, a.Lq,
                                         tid);
      __syncthreads();
      mma_abt_acc<BQ, kWS>(st, ka, sQ, g, t);
      mma_abt_acc<BQ, kWS>(dpt, va, sDo, g, t);
    }
    load_rows_bf16<T, kW, kWS, NT, BQ>(sQc, qb + col, a.sq[2], q0, a.Lq,
                                       tid);
    load_rows_bf16<T, kW, kWS, NT, BQ>(sDoc, db + col, a.sd[2], q0, a.Lq,
                                       tid);
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < a.Lq;
      sStat[i] = in ? a.stats[bh + q0 + i] : 0.f;
      sStat[BQ + i] = in ? a.stats[rows + bh + q0 + i] : 0.f;
      sStat[2 * BQ + i] = in ? a.delta[bh + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c0 = j * 8 + 2 * t;
      const float2 mj = *reinterpret_cast<const float2*>(sStat + c0);
      const float2 ij = *reinterpret_cast<const float2*>(sStat + BQ + c0);
      const float2 dj =
          *reinterpret_cast<const float2*>(sStat + 2 * BQ + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, odd = e & 1;
        const float x = __fadd_rn(__fmul_rn(st[j][e], a.scale), kbias[r]);
        const float p = q0 + c0 + odd < a.Lq
                            ? __expf(x - (odd ? mj.y : mj.x)) *
                                  (odd ? ij.y : ij.x)
                            : 0.f;
        const float ds = p * (dpt[j][e] - (odd ? dj.y : dj.x));
        dbias[r] += ds;
        st[j][e] = p;
        dpt[j][e] = ds * a.scale;
      }
    }
    mma_pb<BQ, kW, kWS>(dvacc, st, sDoc, lane);
    mma_pb<BQ, kW, kWS>(dkacc, dpt, sQc, lane);
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.sdk[0] + h * a.sdk[1] + col;
  T* dvb = static_cast<T*>(a.dv) + b * a.sdv[0] + h * a.sdv[1] + col;
#pragma unroll
  for (int j = 0; j < kW / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (kr0 < a.Lk) {
      Io<T>::store2(dkb + kr0 * a.sdk[2] + c, dkacc[j][0], dkacc[j][1]);
      Io<T>::store2(dvb + kr0 * a.sdv[2] + c, dvacc[j][0], dvacc[j][1]);
    }
    if (kr1 < a.Lk) {
      Io<T>::store2(dkb + kr1 * a.sdk[2] + c, dkacc[j][2], dkacc[j][3]);
      Io<T>::store2(dvb + kr1 * a.sdv[2] + c, dvacc[j][2], dvacc[j][3]);
    }
  }
  if (a.dbias_part && col == 0) {
    dbias[0] = quad_sum(dbias[0]);
    dbias[1] = quad_sum(dbias[1]);
    if (t == 0) {
      const size_t base = ((size_t)b * a.H + h) * a.Lk;
      if (kr0 < a.Lk) a.dbias_part[base + kr0] = dbias[0];
      if (kr1 < a.Lk) a.dbias_part[base + kr1] = dbias[1];
    }
  }
}

// launch 2 at D > 64: block x = tile * (D / kW) + slice; tiles [0, nq) are
// dq tiles, the rest dk/dv tiles
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_wide(BwdArgs a, int D, int nq) {
  const int nc = D / kW;
  const int tile = blockIdx.x / nc, col = (blockIdx.x % nc) * kW;
  if (tile < nq)
    bwd_dq_wide<T>(a, D, tile * kBwdRows, col);
  else
    bwd_dkdv_wide<T>(a, D, (tile - nq) * kBwdRows, col);
}

template <typename T, int D, int NW, int STAGES>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t st) {
  constexpr int bytes = FwdSmem<T, D, NW, STAGES>::BYTES;
  // once per kernel and process
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd<T, D, NW, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Lq + NW * 16 - 1) / (NW * 16), a.H, B);
  attn_fwd<T, D, NW, STAGES><<<grid, NW * 32, bytes, st>>>(a);
  return cudaGetLastError();
}

// bq: query rows a block (32 or 64); stages: ring depth (2 or 3)
template <typename T, int D>
cudaError_t forward(const FwdArgs& a, int B, int bq, int stages,
                    cudaStream_t st) {
  if (bq == 64 && stages == 2) return launch_fwd<T, D, 4, 2>(a, B, st);
  if (bq == 64 && stages == 3) return launch_fwd<T, D, 4, 3>(a, B, st);
  if (bq == 32 && stages == 2) return launch_fwd<T, D, 2, 2>(a, B, st);
  if (bq == 32 && stages == 3) return launch_fwd<T, D, 2, 3>(a, B, st);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t backward(const BwdArgs& a, int B, float* dbias,
                     cudaStream_t st) {
  constexpr int bytes =
      cmax(DqSmem<T, D>::BYTES, DkdvSmem<T, D>::BYTES);
  // once per kernel and process
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const int nq = (a.Lq + kBwdRows - 1) / kBwdRows;
  const int nk = (a.Lk + kBwdRows - 1) / kBwdRows;
  attn_bwd_delta<T, D><<<dim3((a.Lq + kBwdThreads / 4 - 1) /
                                  (kBwdThreads / 4), a.H, B),
                         kBwdThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd<T, D><<<dim3(nq + nk, a.H, B), kBwdThreads, bytes, st>>>(a, nq);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dbias) return err;
  const int n = B * a.Lk;
  attn_bwd_dbias<<<(n + 255) / 256, 256, 0, st>>>(a.dbias_part, dbias, B,
                                                  a.H, a.Lk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward_wide(const FwdArgs& a, int B, int D, cudaStream_t st) {
  const dim3 grid((a.Lq + 63) / 64 * (D / kW), a.H, B);
  attn_fwd_wide<T><<<grid, 128, 0, st>>>(a, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_wide(const BwdArgs& a, int B, int D, float* dbias,
                          cudaStream_t st) {
  const int nq = (a.Lq + kBwdRows - 1) / kBwdRows;
  const int nk = (a.Lk + kBwdRows - 1) / kBwdRows;
  attn_bwd_delta_wide<T><<<dim3((a.Lq + kBwdThreads / 4 - 1) /
                                    (kBwdThreads / 4), a.H, B),
                           kBwdThreads, 0, st>>>(a, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_wide<T><<<dim3((nq + nk) * (D / kW), a.H, B), kBwdThreads, 0,
                     st>>>(a, D, nq);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dbias) return err;
  const int n = B * a.Lk;
  attn_bwd_dbias<<<(n + 255) / 256, 256, 0, st>>>(a.dbias_part, dbias, B,
                                                  a.H, a.Lk);
  return cudaGetLastError();
}

void copy3(long long dst[3], const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace

// f32 != 0: q, k, v and out are f32, else bf16. stats: (2, B, H, Lq) f32
// or null. strides: the B, H and L strides (elements) of q, k, v and out,
// 12 values. bq and stages as the wrapper's _attn_plan gives them (D of
// 32 or 64; a D above 64, a multiple of 64, takes the wide kernel, which
// reads neither).
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, void* stats,
                                 const long long* strides, int B, int H,
                                 int Lq, int Lk, int D, int f32, int bq,
                                 int stages, float scale, void* stream) {
  FwdArgs a;
  a.q = q; a.k = k; a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.stats = static_cast<float*>(stats);
  copy3(a.sq, strides);
  copy3(a.sk, strides + 3);
  copy3(a.sv, strides + 6);
  copy3(a.so, strides + 9);
  a.H = H; a.Lq = Lq; a.Lk = Lk; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32)
    err = f32 ? forward<float, 32>(a, B, bq, stages, st)
              : forward<bf16, 32>(a, B, bq, stages, st);
  else if (D == 64)
    err = f32 ? forward<float, 64>(a, B, bq, stages, st)
              : forward<bf16, 64>(a, B, bq, stages, st);
  else if (D > 64 && D % kW == 0)
    err = f32 ? forward_wide<float>(a, B, D, st)
              : forward_wide<bf16>(a, B, D, st);
  return static_cast<int>(err);
}

// dq, dk, dv in the inputs' dtype; stats: the forward's (2, B, H, Lq);
// delta: (B, H, Lq) f32 scratch; dbias (B, Lk) f32, or null when no bias
// gradient is asked for; dbias_part: (B, H, Lk) f32 scratch (null with
// dbias). strides: the B, H and L strides of q, k, v, out, dout, dq, dk
// and dv, 24 values.
extern "C" int attention_backward(
    const void* q, const void* k, const void* v, const void* bias,
    const void* o, const void* dout, const void* stats, void* delta,
    void* dq, void* dk, void* dv, void* dbias, void* dbias_part,
    const long long* strides,
    int B, int H, int Lq, int Lk, int D, int f32, float scale,
    void* stream) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.bias = static_cast<const float*>(bias);
  a.stats = static_cast<const float*>(stats);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.dbias_part = dbias ? static_cast<float*>(dbias_part) : nullptr;
  copy3(a.sq, strides);
  copy3(a.sk, strides + 3);
  copy3(a.sv, strides + 6);
  copy3(a.so, strides + 9);
  copy3(a.sd, strides + 12);
  copy3(a.sdq, strides + 15);
  copy3(a.sdk, strides + 18);
  copy3(a.sdv, strides + 21);
  a.H = H; a.Lq = Lq; a.Lk = Lk; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* db = static_cast<float*>(dbias);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32)
    err = f32 ? backward<float, 32>(a, B, db, st)
              : backward<bf16, 32>(a, B, db, st);
  else if (D == 64)
    err = f32 ? backward<float, 64>(a, B, db, st)
              : backward<bf16, 64>(a, B, db, st);
  else if (D > 64 && D % kW == 0)
    err = f32 ? backward_wide<float>(a, B, D, db, st)
              : backward_wide<bf16>(a, B, D, db, st);
  return static_cast<int>(err);
}
