// Fused Tip-Adapter cache scoring for Hopper (sm_90a).
//
// Replaces hoigen_tpu/ops/pallas_cache.py::_kernel (the Pallas forward):
//   out = ((X W^T + b) L) / s
// X (N, D) f32, W (R, D) bf16, b (R,) f32, L (R, C) bf16 stored with row
// stride LC (C rounded up to a multiple of 8, the tail columns zero, so
// that every 16-byte copy of a row of L stays inside it), s (C,) f32;
// out (N, C) f32: only the first C columns are written. X enters the
// tensor cores as bf16 (round to nearest even, as the TPU path's
// astype(bfloat16)); W and L come as bf16, cast (and L padded) once by the
// wrapper as the TPU path casts them before its kernel. The
// affinity phi = X W^T + b is accumulated in f32 and rounded to bf16
// before the second product, as the TPU kernel rounds phi to L's dtype.
//
// Bound on this card: at the HICO-DET eval shapes (N = 450 per image,
// D = 512, R = 1200, C = 600) one image's branch is 2 N R (D + C) = 1.2
// GFLOP against 1.8 MB of X and out: about 300 FLOP per byte, so the
// tensor cores bound it. W and L (2.4 MB in bf16) stay in L2.
//
// Design: one block per (64-row tile of X, 128-column tile of C), 8 warps.
// X's tile is converted to bf16 into shared memory once. The block walks R
// in chunks of 64. The chunk of W (64 x D) and of L (64 x 128) are copied
// into shared memory with 16-byte cp.async, W's next chunk while the
// current chunk's second product runs and L's chunk while the first
// product runs. Each warp computes a 16x32 piece of the phi chunk into
// shared memory (bf16), then multiplies its 16 rows of phi by 64 columns
// of L (B fragments by ldmatrix.trans from L's row-major chunk) into an f32
// accumulator held in registers. The (tile, R) affinity never leaves the
// SM. The price of this choice is that each of the ceil(C/128) column
// tiles recomputes phi (5x the first product at C = 600); it buys
// ceil(C/128) times more blocks, which a batch of 4 images (29 row tiles)
// needs to fill 132 SMs.
#include <cuda_runtime.h>

#include "mma.cuh"

using namespace hoigen;

namespace {

constexpr int kBN = 64;    // rows of X per block
constexpr int kBC = 128;   // columns of C per block
constexpr int kBR = 64;    // R chunk
constexpr int kThreads = 256;
constexpr int kPS = kBR + 8;   // padded stride of sPhi
constexpr int kLS = kBC + 8;   // padded stride of sL

__global__ void __launch_bounds__(kThreads)
cache_logits_fwd(const float* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ b, const bf16* __restrict__ l,
                 const float* __restrict__ s, float* __restrict__ out, int N,
                 int D, int R, int C, int LC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int XS = D + 8;
  bf16* sX = reinterpret_cast<bf16*>(smem);            // kBN x XS
  bf16* sW = sX + kBN * XS;                            // kBR x XS
  bf16* sL = sW + kBR * XS;                            // kBR x kLS
  bf16* sPhi = sL + kBR * kLS;                         // kBN x kPS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kBC;
  const int rg = warp & 3;          // 16-row group of this warp
  const int half = warp >> 2;       // R half (phase 1) / C half (phase 2)

  // W[r0:r0+64, :] and L[r0:r0+64, c0:c0+128]; rows past R and columns
  // past LC are zero-filled
  auto stage_w = [&](int r0) {
    for (int i = tid; i < kBR * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool in = r0 + r < R;
      cp_async16(sW + r * XS + c, in ? w + (size_t)(r0 + r) * D + c : w, in);
    }
  };
  auto stage_l = [&](int r0) {
    for (int i = tid; i < kBR * (kBC / 8); i += kThreads) {
      const int r = i / (kBC / 8), c = (i % (kBC / 8)) * 8;
      const bool in = r0 + r < R && c0 + c < LC;
      cp_async16(sL + r * kLS + c,
                 in ? l + (size_t)(r0 + r) * LC + c0 + c : l, in);
    }
  };

  stage_w(0);
  cp_async_commit();
  for (int i = tid; i < kBN * (D / 2); i += kThreads) {
    int r = i / (D / 2), c = (i % (D / 2)) * 2;
    float2 val = make_float2(0.f, 0.f);
    if (n0 + r < N)
      val = *reinterpret_cast<const float2*>(x + (size_t)(n0 + r) * D + c);
    *reinterpret_cast<uint32_t*>(sX + r * XS + c) = pack_bf16(val.x, val.y);
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int r0 = 0; r0 < R; r0 += kBR) {
    stage_l(r0);          // sL is free: the last chunk's product is done
    cp_async_commit();
    cp_async_wait<1>();   // this chunk's W has landed
    __syncthreads();      // ... for every thread; sX written (first chunk)

    // phase 1: phi[rg*16 .. +16, half*32 .. +32] = X W^T + b
    float ph[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ph[j][0] = ph[j][1] = ph[j][2] = ph[j][3] = 0.f;
    const bf16* xrow = sX + (rg * 16 + g) * XS;
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4] = {ld32(xrow + kk * 16 + 2 * t),
                       ld32(xrow + 8 * XS + kk * 16 + 2 * t),
                       ld32(xrow + kk * 16 + 2 * t + 8),
                       ld32(xrow + 8 * XS + kk * 16 + 2 * t + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* wr = sW + (half * 32 + j * 8 + g) * XS + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(wr), b1 = ld32(wr + 8);
        mma_bf16(ph[j], a, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int cl = half * 32 + j * 8 + 2 * t;           // column in the chunk
      float bb0 = r0 + cl < R ? b[r0 + cl] : 0.f;
      float bb1 = r0 + cl + 1 < R ? b[r0 + cl + 1] : 0.f;
      bf16* prow = sPhi + (rg * 16 + g) * kPS + cl;
      *reinterpret_cast<uint32_t*>(prow) =
          pack_bf16(__fadd_rn(ph[j][0], bb0), __fadd_rn(ph[j][1], bb1));
      *reinterpret_cast<uint32_t*>(prow + 8 * kPS) =
          pack_bf16(__fadd_rn(ph[j][2], bb0), __fadd_rn(ph[j][3], bb1));
    }
    __syncthreads();      // sW consumed; sPhi written

    if (r0 + kBR < R) stage_w(r0 + kBR);
    cp_async_commit();    // (an empty group after the last chunk)
    cp_async_wait<1>();   // this chunk's L has landed
    __syncthreads();

    // phase 2: acc[rg*16 .. +16, half*64 .. +64] += phi_chunk L_chunk
    const bf16* prow = sPhi + (rg * 16 + g) * kPS;
#pragma unroll
    for (int kk = 0; kk < kBR / 16; ++kk) {
      uint32_t a[4] = {ld32(prow + kk * 16 + 2 * t),
                       ld32(prow + 8 * kPS + kk * 16 + 2 * t),
                       ld32(prow + kk * 16 + 2 * t + 8),
                       ld32(prow + 8 * kPS + kk * 16 + 2 * t + 8)};
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bl[4];
        ldsm_x4_trans(bl, sL + (kk * 16 + (lane & 15)) * kLS + half * 64 +
                              jp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * jp], a, bl[0], bl[1]);
        mma_bf16(acc[2 * jp + 1], a, bl[2], bl[3]);
      }
    }
    __syncthreads();      // sPhi / sL consumed before the next chunk
  }

  const int row0 = n0 + rg * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int c = c0 + half * 64 + j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= C) continue;
      float sc = s[c + e];
      if (row0 < N) out[(size_t)row0 * C + c + e] = acc[j][e] / sc;
      if (row1 < N) out[(size_t)row1 * C + c + e] = acc[j][2 + e] / sc;
    }
  }
}

}  // namespace

extern "C" int cache_logits_forward(const void* x, const void* w,
                                    const void* b, const void* l,
                                    const void* s, void* out, int N, int D,
                                    int R, int C, int LC, void* stream) {
  if (D % 16 != 0 || LC % 8 != 0 || LC < C)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = sizeof(bf16) * ((size_t)(kBN + kBR) * (D + 8) + kBN * kPS +
                                kBR * kLS);
  cudaError_t err = cudaFuncSetAttribute(
      cache_logits_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBN - 1) / kBN, (C + kBC - 1) / kBC);
  cache_logits_fwd<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const bf16*>(l),
      static_cast<const float*>(s), static_cast<float*>(out), N, D, R, C,
      LC);
  return static_cast<int>(cudaGetLastError());
}
