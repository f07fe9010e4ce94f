// Fused multi-head attention, forward and backward, for Hopper (sm_90a).
//
// attention_forward replaces hoigen_tpu/ops/attention.py::_attn_kernel:
//   out = softmax(q k^T * scale + key_bias) v
// attention_backward replaces hoigen_tpu/ops/attention.py::_attn_bwd_kernel:
//   dq, dk, dv and d(key_bias) by recompute, with no logsumexp saved.
// q (B, H, Lq, D), k/v (B, H, Lk, D), out (B, H, Lq, D), all of one dtype T,
// bf16 (the DETR encoder) or f32 (the CLIP tower in training); key_bias
// (B, Lk) f32 or null. Every product takes bf16 operands with f32
// accumulation, as the TPU's Precision.DEFAULT does for both dtypes: an f32
// operand is rounded to bf16 when it is staged into shared memory. Scores,
// row max and sum, delta and ds stay in f32.
//
// Bound on this card, forward: at the DETR encoder shapes (H=8, L=1050,
// D=32) one image does 4*H*L*L*D = 1.13 GFLOP (1.1 us on the tensor cores
// at 989 TFLOP/s) against H*L*L = 8.8 M exponentials (2.1 us at 16 per SM
// per clock, 132 SMs, 1.98 GHz) and 2.2 MB of q, k, v and out (0.6 us at
// 3.35 TB/s): the special-function units bound it. Backward: at the CLIP
// shapes (H=12, L=197, D=64, f32) one image reads q, k, v, out and dout
// and writes dq, dk and dv, 8 x 0.6 MB = 4.8 MB (1.45 us), against 5
// products of 2*H*L*L*D = 0.3 GFLOP each, 1.5 GFLOP (1.5 us): bytes and
// operations are close, bytes a little ahead.
//
// Forward design: flash-style, one block per (64-query tile, head, batch),
// 4 warps of 16 query rows each. The block loops over 64-key tiles held in
// shared memory (V stored transposed so that its B fragments are 4-byte
// loads) and keeps an online softmax in registers: the (Lq, Lk) scores
// never leave the SM. The score accumulator is reused as the A fragment of
// P V, so P is rounded to bf16 once, as the TPU kernel rounds p before its
// PV product. Unlike the TPU kernel, p is normalised after the PV product
// (online softmax); keys past Lk get a -inf bias instead of the TPU's -1e9
// padding.
//
// Backward design. The TPU kernel walks the query blocks in order and
// carries dk, dv and d(bias) in VMEM from one grid step to the next; blocks
// on this card run in parallel and in no order, so no block may carry a
// sum to another. The work is split instead into three launches on one
// stream, each of which owns what it writes:
//  1. attn_bwd_dq, one block per (64-query tile, head, batch): a first
//     sweep over the keys recomputes the row max and sum (no logsumexp was
//     saved, as on the TPU), delta = rowsum(dout * out) is taken in f32
//     from the unrounded inputs, and a second sweep forms the normalised
//     p, dp = dout v^T, ds = p (dp - delta) and accumulates dq = ds k in
//     registers. It writes dq and the row statistics (max, 1/sum, delta).
//  2. attn_bwd_dkdv, one block per (64-key tile, head, batch): it loops over
//     32-query tiles, rebuilds p^T and dp^T from the statistics of launch
//     1, and accumulates dv = p^T dout and dk = ds^T q for its keys in
//     registers, and the per-head partial sums of ds over the queries.
//  3. attn_bwd_dbias sums those partials over the heads.
// No atomics: every sum has one owner and a fixed order, so the gradients
// are the same from run to run. p is rounded to bf16 before p^T dout, and
// ds * scale before ds k and ds^T q, as in _attn_bwd_kernel.
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

using namespace hoigen;

namespace {

constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr int kBQ = 64;         // query rows per forward / dq block
constexpr int kBK = 64;         // keys per tile (and per dk/dv block)
constexpr int kBQ2 = 32;        // query rows per tile of the dk/dv loop

// Loads and stores of the input dtype. load8 reads 8 consecutive values
// and returns them as 8 bf16 (round to nearest even for f32).
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

// rows [r0, r0 + rows) of a (L, D) matrix into shared memory as bf16 with
// row stride S; rows past L are zero
template <typename T, int D, int S>
__device__ __forceinline__ void stage_rows(bf16* dst, const T* src, int r0,
                                           int rows, int L, int tid) {
  constexpr int ROWV = D / 8;
  for (int i = tid; i < rows * ROWV; i += kThreads) {
    const int r = i / ROWV, c = (i % ROWV) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < L) val = Io<T>::load8(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * S + c) = val;
  }
}

// A fragments of a warp's 16 rows (row stride S) over the whole depth D
template <int D, int S>
__device__ __forceinline__ void load_afrag(uint32_t a[D / 16][4],
                                           const bf16* rows, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld32(rows + g * S + kk * 16 + 2 * t);
    a[kk][1] = ld32(rows + (g + 8) * S + kk * 16 + 2 * t);
    a[kk][2] = ld32(rows + g * S + kk * 16 + 2 * t + 8);
    a[kk][3] = ld32(rows + (g + 8) * S + kk * 16 + 2 * t + 8);
  }
}

// c[j] (n-tile j of N columns) = A (16 x D, fragments a) times B^T, where B
// is stored (n, d) row-major in shared memory with row stride S
template <int D, int N, int S>
__device__ __forceinline__ void mma_abt(float c[N / 8][4],
                                        uint32_t a[D / 16][4],
                                        const bf16* b, int g, int t) {
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

// acc (16 x D) += P (16 x K, the f32 accumulator fragments p, rounded to
// bf16 here) times B, where B is stored (k, d) row-major in shared memory
// with row stride S
template <int K, int D, int S>
__device__ __forceinline__ void mma_pb(float acc[D / 8][4],
                                       float p[K / 8][4],
                                       const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
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

// keys [k0, k0 + kBK) of one head into shared memory (v too when given)
// with their bias; keys past Lk get a -inf bias
template <typename T, int D, int S>
__device__ __forceinline__ void stage_keys(bf16* sK, bf16* sV, float* sBias,
                                           const T* k, const T* v,
                                           const float* bias, int k0, int Lk,
                                           int tid) {
  stage_rows<T, D, S>(sK, k, k0, kBK, Lk, tid);
  if (v) stage_rows<T, D, S>(sV, v, k0, kBK, Lk, tid);
  for (int i = tid; i < kBK; i += kThreads)
    sBias[i] = k0 + i < Lk ? (bias ? bias[k0 + i] : 0.f) : -INFINITY;
}

// s (16 x kBK) = q k^T * scale + bias for the staged key tile
template <int D, int S>
__device__ __forceinline__ void biased_scores(float s[kBK / 8][4],
                                              uint32_t qa[D / 16][4],
                                              const bf16* sK,
                                              const float* sBias, float scale,
                                              int g, int t) {
  mma_abt<D, kBK, S>(s, qa, sK, g, t);
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const float b0 = sBias[j * 8 + 2 * t], b1 = sBias[j * 8 + 2 * t + 1];
    s[j][0] = __fadd_rn(__fmul_rn(s[j][0], scale), b0);
    s[j][1] = __fadd_rn(__fmul_rn(s[j][1], scale), b1);
    s[j][2] = __fadd_rn(__fmul_rn(s[j][2], scale), b0);
    s[j][3] = __fadd_rn(__fmul_rn(s[j][3], scale), b1);
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ bias,
         T* __restrict__ out, int H, int Lq, int Lk, float scale) {
  constexpr int QS = D + 8;      // padded row strides: conflict-free frags
  constexpr int VS = kBK + 8;
  __shared__ __align__(16) bf16 sQ[kBQ * QS];
  __shared__ __align__(16) bf16 sK[kBK * QS];
  __shared__ __align__(16) bf16 sVt[D * VS];
  __shared__ float sBias[kBK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const float* biasb = bias ? bias + (size_t)blockIdx.z * Lk : nullptr;

  stage_rows<T, D, QS>(sQ, q + bh * Lq * D, q0, kBQ, Lq, tid);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_afrag<D, QS>(qa, sQ + warp * 16 * QS, g, t);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                     // this thread's partial sums
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  constexpr int ROWV = D / 8;
  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();                           // previous tile consumed
    stage_keys<T, D, QS>(sK, nullptr, sBias, kb, nullptr, biasb, k0, Lk,
                         tid);
    for (int i = tid; i < kBK * ROWV; i += kThreads) {
      const int r = i / ROWV, c = (i % ROWV) * 8;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Lk) vv = Io<T>::load8(vb + (size_t)(k0 + r) * D + c);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * VS + r] = ve[e];
    }
    __syncthreads();

    float s[kBK / 8][4];
    biased_scores<D, QS>(s, qa, sK, sBias, scale, g, t);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mn = fmaxf(m[r], quad_max(mx[r]));
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
      s[j][0] = __expf(s[j][0] - m[0]);
      s[j][1] = __expf(s[j][1] - m[0]);
      s[j][2] = __expf(s[j][2] - m[1]);
      s[j][3] = __expf(s[j][3] - m[1]);
      l[0] += s[j][0] + s[j][1];
      l[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const bf16* vrow = sVt + (j * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(o[j], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

  const float inv0 = 1.f / quad_sum(l[0]), inv1 = 1.f / quad_sum(l[1]);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < Lq)
      Io<T>::store2(out + (bh * Lq + r0) * D + c, o[j][0] * inv0,
                    o[j][1] * inv0);
    if (r1 < Lq)
      Io<T>::store2(out + (bh * Lq + r1) * D + c, o[j][2] * inv1,
                    o[j][3] * inv1);
  }
}

// ------------------------------------------------- backward, launch 1: dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ bias,
            const T* __restrict__ o, const T* __restrict__ dout,
            T* __restrict__ dq, float* __restrict__ row_max,
            float* __restrict__ row_inv, float* __restrict__ row_delta,
            int H, int Lq, int Lk, float scale) {
  constexpr int QS = D + 8;
  __shared__ __align__(16) bf16 sQ[kBQ * QS];   // q tile, then dout tile
  __shared__ __align__(16) bf16 sK[kBK * QS];
  __shared__ __align__(16) bf16 sV[kBK * QS];
  __shared__ float sBias[kBK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const float* biasb = bias ? bias + (size_t)blockIdx.z * Lk : nullptr;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[D / 16][4], da[D / 16][4];
  stage_rows<T, D, QS>(sQ, q + bh * Lq * D, q0, kBQ, Lq, tid);
  __syncthreads();
  load_afrag<D, QS>(qa, sQ + warp * 16 * QS, g, t);
  __syncthreads();
  stage_rows<T, D, QS>(sQ, dout + bh * Lq * D, q0, kBQ, Lq, tid);
  __syncthreads();
  load_afrag<D, QS>(da, sQ + warp * 16 * QS, g, t);

  // delta = rowsum(dout * out) in f32 from the inputs as given
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < Lq) {
      const float2 a = Io<T>::load2(dout + (bh * Lq + r0) * D + c);
      const float2 b = Io<T>::load2(o + (bh * Lq + r0) * D + c);
      delta[0] += a.x * b.x + a.y * b.y;
    }
    if (r1 < Lq) {
      const float2 a = Io<T>::load2(dout + (bh * Lq + r1) * D + c);
      const float2 b = Io<T>::load2(o + (bh * Lq + r1) * D + c);
      delta[1] += a.x * b.x + a.y * b.y;
    }
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);

  // sweep 1: row max and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();
    stage_keys<T, D, QS>(sK, sV, sBias, kb, nullptr, biasb, k0, Lk, tid);
    __syncthreads();
    float s[kBK / 8][4];
    biased_scores<D, QS>(s, qa, sK, sBias, scale, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      l[r] *= m[r] == -INFINITY ? 0.f : __expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      l[0] += __expf(s[j][0] - m[0]) + __expf(s[j][1] - m[0]);
      l[1] += __expf(s[j][2] - m[1]) + __expf(s[j][3] - m[1]);
    }
  }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};

  // sweep 2: p, dp, ds, dq
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();
    stage_keys<T, D, QS>(sK, sV, sBias, kb, vb, biasb, k0, Lk, tid);
    __syncthreads();
    float s[kBK / 8][4], dp[kBK / 8][4];
    biased_scores<D, QS>(s, qa, sK, sBias, scale, g, t);
    mma_abt<D, kBK, QS>(dp, da, sV, g, t);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __expf(s[j][e] - m[r]) * inv[r];
        s[j][e] = p * (dp[j][e] - delta[r]) * scale;   // ds * scale
      }
    }
    mma_pb<kBK, D, QS>(acc, s, sK, lane);
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < Lq)
      Io<T>::store2(dq + (bh * Lq + r0) * D + c, acc[j][0], acc[j][1]);
    if (r1 < Lq)
      Io<T>::store2(dq + (bh * Lq + r1) * D + c, acc[j][2], acc[j][3]);
  }
  if (t == 0) {
    if (r0 < Lq) {
      row_max[bh * Lq + r0] = m[0];
      row_inv[bh * Lq + r0] = inv[0];
      row_delta[bh * Lq + r0] = delta[0];
    }
    if (r1 < Lq) {
      row_max[bh * Lq + r1] = m[1];
      row_inv[bh * Lq + r1] = inv[1];
      row_delta[bh * Lq + r1] = delta[1];
    }
  }
}

// ------------------------------------------- backward, launch 2: dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias,
              const T* __restrict__ dout, const float* __restrict__ row_max,
              const float* __restrict__ row_inv,
              const float* __restrict__ row_delta, T* __restrict__ dk,
              T* __restrict__ dv, float* __restrict__ dbias_part, int H,
              int Lq, int Lk, float scale) {
  constexpr int QS = D + 8;
  __shared__ __align__(16) bf16 sK[kBK * QS];   // k tile, then v tile
  __shared__ __align__(16) bf16 sQ[kBQ2 * QS];
  __shared__ __align__(16) bf16 sDo[kBQ2 * QS];
  __shared__ float sM[kBQ2], sInv[kBQ2], sDelta[kBQ2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qb = q + bh * Lq * D;
  const T* db = dout + bh * Lq * D;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;   // this thread's keys
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? kr1 : kr0;
    kbias[r] = key < Lk ? (bias ? bias[(size_t)blockIdx.z * Lk + key] : 0.f)
                        : -INFINITY;
  }

  uint32_t ka[D / 16][4], va[D / 16][4];
  stage_rows<T, D, QS>(sK, k + bh * Lk * D, k0, kBK, Lk, tid);
  __syncthreads();
  load_afrag<D, QS>(ka, sK + warp * 16 * QS, g, t);
  __syncthreads();
  stage_rows<T, D, QS>(sK, v + bh * Lk * D, k0, kBK, Lk, tid);
  __syncthreads();
  load_afrag<D, QS>(va, sK + warp * 16 * QS, g, t);

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dkacc[j][0] = dkacc[j][1] = dkacc[j][2] = dkacc[j][3] = 0.f;
    dvacc[j][0] = dvacc[j][1] = dvacc[j][2] = dvacc[j][3] = 0.f;
  }
  float dbias[2] = {0.f, 0.f};

  for (int q0 = 0; q0 < Lq; q0 += kBQ2) {
    __syncthreads();                              // previous tile consumed
    stage_rows<T, D, QS>(sQ, qb, q0, kBQ2, Lq, tid);
    stage_rows<T, D, QS>(sDo, db, q0, kBQ2, Lq, tid);
    for (int i = tid; i < kBQ2; i += kThreads) {
      const bool in = q0 + i < Lq;
      // a query past Lq gets p = exp(x - inf) * 0 = 0
      sM[i] = in ? row_max[bh * Lq + q0 + i] : INFINITY;
      sInv[i] = in ? row_inv[bh * Lq + q0 + i] : 0.f;
      sDelta[i] = in ? row_delta[bh * Lq + q0 + i] : 0.f;
    }
    __syncthreads();

    // p^T and dp^T for this warp's 16 keys and the tile's 32 queries
    float st[kBQ2 / 8][4], dpt[kBQ2 / 8][4];
    mma_abt<D, kBQ2, QS>(st, ka, sQ, g, t);
    mma_abt<D, kBQ2, QS>(dpt, va, sDo, g, t);
#pragma unroll
    for (int j = 0; j < kBQ2 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + 2 * t + (e & 1);
        const float x = __fadd_rn(__fmul_rn(st[j][e], scale), kbias[r]);
        const float p = __expf(x - sM[col]) * sInv[col];
        const float ds = p * (dpt[j][e] - sDelta[col]);
        dbias[r] += ds;
        st[j][e] = p;
        dpt[j][e] = ds * scale;
      }
    }
    mma_pb<kBQ2, D, QS>(dvacc, st, sDo, lane);
    mma_pb<kBQ2, D, QS>(dkacc, dpt, sQ, lane);
  }

  const size_t base = bh * Lk;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (kr0 < Lk) {
      Io<T>::store2(dk + (base + kr0) * D + c, dkacc[j][0], dkacc[j][1]);
      Io<T>::store2(dv + (base + kr0) * D + c, dvacc[j][0], dvacc[j][1]);
    }
    if (kr1 < Lk) {
      Io<T>::store2(dk + (base + kr1) * D + c, dkacc[j][2], dkacc[j][3]);
      Io<T>::store2(dv + (base + kr1) * D + c, dvacc[j][2], dvacc[j][3]);
    }
  }
  if (dbias_part) {
    dbias[0] = quad_sum(dbias[0]);
    dbias[1] = quad_sum(dbias[1]);
    if (t == 0) {
      if (kr0 < Lk) dbias_part[base + kr0] = dbias[0];
      if (kr1 < Lk) dbias_part[base + kr1] = dbias[1];
    }
  }
}

// ---------------------------------------- backward, launch 3: d(key_bias)
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

template <typename T, int D>
int forward(const void* q, const void* k, const void* v, const void* bias,
            void* out, int B, int H, int Lq, int Lk, float scale,
            cudaStream_t st) {
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  attn_fwd<T, D><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), H, Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int backward(const void* q, const void* k, const void* v, const void* bias,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             void* dbias, float* stats, float* dbias_part, int B, int H,
             int Lq, int Lk, float scale, cudaStream_t st) {
  const size_t rows = (size_t)B * H * Lq;
  float* row_max = stats;
  float* row_inv = stats + rows;
  float* row_delta = stats + 2 * rows;
  const float* bp = static_cast<const float*>(bias);
  attn_bwd_dq<T, D><<<dim3((Lq + kBQ - 1) / kBQ, H, B), kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bp, static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq), row_max, row_inv,
      row_delta, H, Lq, Lk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv<T, D><<<dim3((Lk + kBK - 1) / kBK, H, B), kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bp, static_cast<const T*>(dout), row_max,
      row_inv, row_delta, static_cast<T*>(dk), static_cast<T*>(dv),
      dbias ? dbias_part : nullptr, H, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dbias) return static_cast<int>(err);
  const int n = B * Lk;
  attn_bwd_dbias<<<(n + 255) / 256, 256, 0, st>>>(
      dbias_part, static_cast<float*>(dbias), B, H, Lk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: q, k, v and out are f32, else bf16
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int H,
                                 int Lq, int Lk, int D, int f32, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return f32 ? forward<float, 32>(q, k, v, bias, out, B, H, Lq, Lk, scale, st)
               : forward<bf16, 32>(q, k, v, bias, out, B, H, Lq, Lk, scale, st);
  if (D == 64)
    return f32 ? forward<float, 64>(q, k, v, bias, out, B, H, Lq, Lk, scale, st)
               : forward<bf16, 64>(q, k, v, bias, out, B, H, Lq, Lk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq, dk, dv in the inputs' dtype; dbias (B, Lk) f32, or null when there is
// no key bias; stats: 3 * B * H * Lq f32 scratch; dbias_part: B * H * Lk
// f32 scratch (unused when dbias is null)
extern "C" int attention_backward(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* o, const void* dout, void* dq,
                                  void* dk, void* dv, void* dbias,
                                  void* stats, void* dbias_part, int B,
                                  int H, int Lq, int Lk, int D, int f32,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  float* dp = static_cast<float*>(dbias_part);
#define HOIGEN_BWD(T, DD)                                                    \
  return backward<T, DD>(q, k, v, bias, o, dout, dq, dk, dv, dbias, sp, dp,  \
                         B, H, Lq, Lk, scale, st)
  if (D == 32) {
    if (f32) HOIGEN_BWD(float, 32);
    HOIGEN_BWD(bf16, 32);
  }
  if (D == 64) {
    if (f32) HOIGEN_BWD(float, 64);
    HOIGEN_BWD(bf16, 64);
  }
#undef HOIGEN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
