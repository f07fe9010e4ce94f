// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces hoigen_tpu/ops/attention.py::_attn_kernel (the Pallas forward):
//   out = softmax(q k^T * scale + key_bias) v
// q (B, H, Lq, D), k/v (B, H, Lk, D) bf16; key_bias (B, Lk) f32 or null;
// out (B, H, Lq, D) bf16. Scores, max and sum stay in f32.
//
// Bound on this card: at the DETR encoder shapes (H=8, L=1050, D=32) one
// image does 4*H*L*L*D = 1.13 GFLOP (1.1 us on the tensor cores at 989
// TFLOP/s) against H*L*L = 8.8 M exponentials (2.1 us at 16 per SM per
// clock, 132 SMs, 1.98 GHz) and 2.2 MB of q, k, v and out (0.6 us at 3.35
// TB/s). With D=32 the special-function units bound the kernel.
//
// Design: flash-style, one block per (64-query tile, head, batch), 4 warps
// of 16 query rows each. The block loops over 64-key tiles held in shared
// memory (V stored transposed so that its B fragments are 4-byte loads)
// and keeps an online softmax in registers: the (Lq, Lk) scores never leave
// the SM. The score accumulator is reused as the A fragment of P V, so P
// is rounded to bf16 once, as the TPU kernel rounds p before its PV product.
// Unlike the TPU kernel, p is normalised after the PV product (online
// softmax); keys past Lk get a -inf bias instead of the TPU's -1e9 padding.
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

using namespace hoigen;

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const float* __restrict__ bias,
         bf16* __restrict__ out, int H, int Lq, int Lk, float scale) {
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
  const bf16* qb = q + bh * Lq * D;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const float* biasb = bias ? bias + (size_t)blockIdx.z * Lk : nullptr;

  constexpr int VEC = 8;                       // bf16 per 16-byte load
  constexpr int ROWV = D / VEC;
  for (int i = tid; i < kBQ * ROWV; i += kThreads) {
    int r = i / ROWV, c = (i % ROWV) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Lq)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * QS + c) = val;
  }
  __syncthreads();

  uint32_t qa[D / 16][4];
  const bf16* qrow = sQ + (warp * 16 + g) * QS;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld32(qrow + kk * 16 + 2 * t);
    qa[kk][1] = ld32(qrow + 8 * QS + kk * 16 + 2 * t);
    qa[kk][2] = ld32(qrow + kk * 16 + 2 * t + 8);
    qa[kk][3] = ld32(qrow + 8 * QS + kk * 16 + 2 * t + 8);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                     // this thread's partial sums
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();                           // previous tile consumed
    for (int i = tid; i < kBK * ROWV; i += kThreads) {
      int r = i / ROWV, c = (i % ROWV) * VEC;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(sK + r * QS + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sVt[(c + e) * VS + r] = ve[e];
    }
    for (int i = tid; i < kBK; i += kThreads)
      sBias[i] = k0 + i < Lk ? (biasb ? biasb[k0 + i] : 0.f) : -INFINITY;
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = sK + (j * 8 + g) * QS;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[j], qa[kk], ld32(krow + kk * 16 + 2 * t),
                 ld32(krow + kk * 16 + 2 * t + 8));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float b0 = sBias[j * 8 + 2 * t], b1 = sBias[j * 8 + 2 * t + 1];
      s[j][0] = __fadd_rn(__fmul_rn(s[j][0], scale), b0);
      s[j][1] = __fadd_rn(__fmul_rn(s[j][1], scale), b1);
      s[j][2] = __fadd_rn(__fmul_rn(s[j][2], scale), b0);
      s[j][3] = __fadd_rn(__fmul_rn(s[j][3], scale), b1);
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      float mn = fmaxf(m[r], mx[r]);
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(out + (bh * Lq + r0) * D + c) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(out + (bh * Lq + r1) * D + c) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

}  // namespace

extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int H,
                                 int Lq, int Lk, int D, float scale,
                                 void* stream) {
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  if (D == 32)
    attn_fwd<32><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, op, H, Lq, Lk,
                                            scale);
  else if (D == 64)
    attn_fwd<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, bp, op, H, Lq, Lk,
                                            scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
