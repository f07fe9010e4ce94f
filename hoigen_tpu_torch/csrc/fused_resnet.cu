// Fused chain of two stride-1 frozen-BN ResNet bottlenecks, NHWC, for
// Hopper (sm_90a).
//
// Replaces hoigen_tpu/ops/fused_resnet.py::_chain_kernel (Pallas) for the
// DETR-R50 layer1 tail (blocks 1-2, C = 256, M = 64). Per block:
//   m1  = relu(x  W1 * s1 + b1)           1x1, C -> M, rounded to bf16
//   m2  = relu(conv3x3(m1) * s2 + b2)     SAME, M -> M, rounded to bf16
//   out = relu(m2 W3 * s3 + b3 + x)       1x1, M -> C, rounded to bf16
// Products take bf16 operands and accumulate in f32; the epilogues are f32.
// Pixels outside the image are zero in m1 (the 3x3's SAME padding), as the
// TPU kernel zeroes its out-of-image halo rows before every 3x3.
//
// Bound on this card: one 200x336 plane moves 2 x 34 MB (x read once,
// out written once: ~20 us at 3.35 TB/s) and needs ~18.7 GFLOP (~19 us at
// 989 TFLOP/s); the two are close to balanced.
//
// Design: one image row (336 pixels x 256 channels, bf16) is 172 KB, so
// the TPU kernel's row tiles do not fit a block's 227 KB of shared memory.
// Each block owns a 16x16 tile of output pixels and computes the whole
// chain for it, recomputing a 2-pixel halo on all four sides:
//   A: m1 of block 1 on the 20x20 region         -> shared (sA)
//   B: m2 of block 1 on the 18x18 region         -> shared (sB)
//   C: x1 = block 1's output on 18x18, 16 channels at a time, fed straight
//      from registers into m1 of block 2         -> shared (sA, reused)
//   D: m2 of block 2 on the 16x16 tile           -> shared (sC)
//   E: x1 on the tile again (from sB) and block 2's output -> global.
// Only M-channel activations (64) live in shared memory; the wide C-channel
// activations exist in registers only. x is read from global memory (with
// L2 catching the halo overlap) and the output written once. x1 is
// recomputed in phase E rather than stored, which costs 9% more FLOPs and
// saves 128 KB of shared memory. Weights are read as B fragments through
// the read-only cache (69 KB per block pair, L2 resident).
#include <cuda_runtime.h>

#include "mma.cuh"

using namespace hoigen;

namespace {

constexpr int kT = 16;             // output tile side
constexpr int kR0 = kT + 4;        // region of block 1's m1
constexpr int kR1 = kT + 2;        // region of block 1's m2 / output
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Block {
  const bf16* w1;   // (M, C)   [out][in]
  const bf16* w2;   // (M, 9M)  [out][tap * M + in], tap = dy * 3 + dx
  const bf16* w3;   // (C, M)   [out][in]
  const float *s1, *b1, *s2, *b2, *s3, *b3;
};

__device__ __forceinline__ float affine(float acc, float s, float b) {
  return __fadd_rn(__fmul_rn(acc, s), b);
}

// load the A fragment for k-step ks of a 3x3 conv over a shared-memory
// region of side `src_side` (pixel stride PS); (pi, pj) are the output
// pixel's coordinates in that region minus the 1-pixel border
template <int M, int PS>
__device__ __forceinline__ void conv_a(uint32_t a[4], const bf16* src,
                                       int src_side, int pi0, int pj0,
                                       int pi1, int pj1, int ks, int t) {
  constexpr int KPT = M / 16;        // k-steps per tap
  const int tap = ks / KPT, c = (ks % KPT) * 16 + 2 * t;
  const int dy = tap / 3, dx = tap % 3;
  const bf16* p0 = src + ((pi0 + dy) * src_side + pj0 + dx) * PS + c;
  const bf16* p1 = src + ((pi1 + dy) * src_side + pj1 + dx) * PS + c;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

template <int C, int M>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_chain2(const bf16* __restrict__ x, bf16* __restrict__ out,
                  Block k1, Block k2, int H, int W) {
  constexpr int PS = M + 8;        // padded pixel stride: conflict-free frags
  constexpr int NT = M / 8;        // n-tiles of an M-wide product
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);          // kR0^2 x PS
  bf16* sB = sA + kR0 * kR0 * PS;                    // kR1^2 x PS
  bf16* sC = sB + kR1 * kR1 * PS;                    // kT^2 x PS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int oy = blockIdx.y * kT, ox = blockIdx.x * kT;
  const bf16* xb = x + (size_t)blockIdx.z * H * W * C;
  bf16* ob = out + (size_t)blockIdx.z * H * W * C;

  auto in_image = [&](int y, int xx) {
    return y >= 0 && y < H && xx >= 0 && xx < W;
  };

  // ---- A: block 1 m1 on the 20x20 region (image origin oy-2, ox-2)
  for (int mt = warp; mt * 16 < kR0 * kR0; mt += kWarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;       // 400 = 25 full tiles
    const int y0 = oy - 2 + r0 / kR0, x0 = ox - 2 + r0 % kR0;
    const int y1 = oy - 2 + r1 / kR0, x1 = ox - 2 + r1 % kR0;
    const bool v0 = in_image(y0, x0), v1 = in_image(y1, x1);
    const bf16* p0 = xb + ((size_t)(v0 ? y0 : 0) * W + (v0 ? x0 : 0)) * C;
    const bf16* p1 = xb + ((size_t)(v1 ? y1 : 0) * W + (v1 ? x1 : 0)) * C;
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kk = 0; kk < C / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t a[4] = {v0 ? ldg32(p0 + c) : 0u, v1 ? ldg32(p1 + c) : 0u,
                       v0 ? ldg32(p0 + c + 8) : 0u, v1 ? ldg32(p1 + c + 8) : 0u};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* wr = k1.w1 + (n * 8 + g) * C + c;
        mma_bf16(acc[n], a, ldg32(wr), ldg32(wr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float s0 = k1.s1[c], s1 = k1.s1[c + 1];
      const float b0 = k1.b1[c], b1 = k1.b1[c + 1];
      *reinterpret_cast<uint32_t*>(sA + r0 * PS + c) = v0
          ? pack_bf16(fmaxf(affine(acc[n][0], s0, b0), 0.f),
                      fmaxf(affine(acc[n][1], s1, b1), 0.f)) : 0u;
      *reinterpret_cast<uint32_t*>(sA + r1 * PS + c) = v1
          ? pack_bf16(fmaxf(affine(acc[n][2], s0, b0), 0.f),
                      fmaxf(affine(acc[n][3], s1, b1), 0.f)) : 0u;
    }
  }
  __syncthreads();

  // ---- B: block 1 m2 on the 18x18 region (3x3 over sA)
  for (int mt = warp; mt * 16 < kR1 * kR1; mt += kWarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int q0 = min(r0, kR1 * kR1 - 1), q1 = min(r1, kR1 * kR1 - 1);
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int ks = 0; ks < 9 * M / 16; ++ks) {
      uint32_t a[4];
      conv_a<M, PS>(a, sA, kR0, q0 / kR1, q0 % kR1, q1 / kR1, q1 % kR1, ks, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* wr = k1.w2 + (n * 8 + g) * 9 * M + ks * 16 + 2 * t;
        mma_bf16(acc[n], a, ldg32(wr), ldg32(wr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float s0 = k1.s2[c], s1 = k1.s2[c + 1];
      const float b0 = k1.b2[c], b1 = k1.b2[c + 1];
      if (r0 < kR1 * kR1)
        *reinterpret_cast<uint32_t*>(sB + r0 * PS + c) =
            pack_bf16(fmaxf(affine(acc[n][0], s0, b0), 0.f),
                      fmaxf(affine(acc[n][1], s1, b1), 0.f));
      if (r1 < kR1 * kR1)
        *reinterpret_cast<uint32_t*>(sB + r1 * PS + c) =
            pack_bf16(fmaxf(affine(acc[n][2], s0, b0), 0.f),
                      fmaxf(affine(acc[n][3], s1, b1), 0.f));
    }
  }
  __syncthreads();

  // ---- C: x1 = block 1 output on 18x18, streamed into block 2's m1 (sA)
  for (int mt = warp; mt * 16 < kR1 * kR1; mt += kWarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int q0 = min(r0, kR1 * kR1 - 1), q1 = min(r1, kR1 * kR1 - 1);
    const int y0 = oy - 1 + q0 / kR1, x0 = ox - 1 + q0 % kR1;
    const int y1 = oy - 1 + q1 / kR1, x1 = ox - 1 + q1 % kR1;
    const bool v0 = in_image(y0, x0), v1 = in_image(y1, x1);
    const bf16* p0 = xb + ((size_t)(v0 ? y0 : 0) * W + (v0 ? x0 : 0)) * C;
    const bf16* p1 = xb + ((size_t)(v1 ? y1 : 0) * W + (v1 ? x1 : 0)) * C;
    uint32_t am[M / 16][4];
#pragma unroll
    for (int kk = 0; kk < M / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      am[kk][0] = ld32(sB + q0 * PS + c);
      am[kk][1] = ld32(sB + q1 * PS + c);
      am[kk][2] = ld32(sB + q0 * PS + c + 8);
      am[kk][3] = ld32(sB + q1 * PS + c + 8);
    }
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int cc = 0; cc < C / 16; ++cc) {
      float xr[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xr[h][0] = xr[h][1] = xr[h][2] = xr[h][3] = 0.f;
        const bf16* wr = k1.w3 + (cc * 16 + h * 8 + g) * M + 2 * t;
#pragma unroll
        for (int kk = 0; kk < M / 16; ++kk)
          mma_bf16(xr[h], am[kk], ldg32(wr + kk * 16), ldg32(wr + kk * 16 + 8));
        const int c = cc * 16 + h * 8 + 2 * t;
        const float s0 = k1.s3[c], s1 = k1.s3[c + 1];
        const float b0 = k1.b3[c], b1 = k1.b3[c + 1];
        const float2 i0 = v0 ? unpack_bf16(ldg32(p0 + c)) : make_float2(0.f, 0.f);
        const float2 i1 = v1 ? unpack_bf16(ldg32(p1 + c)) : make_float2(0.f, 0.f);
        // rounded to bf16 as the block's output; zero outside the image
        xr[h][0] = v0 ? fmaxf(__fadd_rn(affine(xr[h][0], s0, b0), i0.x), 0.f) : 0.f;
        xr[h][1] = v0 ? fmaxf(__fadd_rn(affine(xr[h][1], s1, b1), i0.y), 0.f) : 0.f;
        xr[h][2] = v1 ? fmaxf(__fadd_rn(affine(xr[h][2], s0, b0), i1.x), 0.f) : 0.f;
        xr[h][3] = v1 ? fmaxf(__fadd_rn(affine(xr[h][3], s1, b1), i1.y), 0.f) : 0.f;
      }
      uint32_t a[4] = {pack_bf16(xr[0][0], xr[0][1]), pack_bf16(xr[0][2], xr[0][3]),
                       pack_bf16(xr[1][0], xr[1][1]), pack_bf16(xr[1][2], xr[1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* wr = k2.w1 + (n * 8 + g) * C + cc * 16 + 2 * t;
        mma_bf16(acc[n], a, ldg32(wr), ldg32(wr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float s0 = k2.s1[c], s1 = k2.s1[c + 1];
      const float b0 = k2.b1[c], b1 = k2.b1[c + 1];
      if (r0 < kR1 * kR1)
        *reinterpret_cast<uint32_t*>(sA + r0 * PS + c) = v0
            ? pack_bf16(fmaxf(affine(acc[n][0], s0, b0), 0.f),
                        fmaxf(affine(acc[n][1], s1, b1), 0.f)) : 0u;
      if (r1 < kR1 * kR1)
        *reinterpret_cast<uint32_t*>(sA + r1 * PS + c) = v1
            ? pack_bf16(fmaxf(affine(acc[n][2], s0, b0), 0.f),
                        fmaxf(affine(acc[n][3], s1, b1), 0.f)) : 0u;
    }
  }
  __syncthreads();

  // ---- D: block 2 m2 on the 16x16 tile (3x3 over sA as an 18x18 region)
  for (int mt = warp; mt * 16 < kT * kT; mt += kWarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int ks = 0; ks < 9 * M / 16; ++ks) {
      uint32_t a[4];
      conv_a<M, PS>(a, sA, kR1, r0 / kT, r0 % kT, r1 / kT, r1 % kT, ks, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* wr = k2.w2 + (n * 8 + g) * 9 * M + ks * 16 + 2 * t;
        mma_bf16(acc[n], a, ldg32(wr), ldg32(wr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float s0 = k2.s2[c], s1 = k2.s2[c + 1];
      const float b0 = k2.b2[c], b1 = k2.b2[c + 1];
      *reinterpret_cast<uint32_t*>(sC + r0 * PS + c) =
          pack_bf16(fmaxf(affine(acc[n][0], s0, b0), 0.f),
                    fmaxf(affine(acc[n][1], s1, b1), 0.f));
      *reinterpret_cast<uint32_t*>(sC + r1 * PS + c) =
          pack_bf16(fmaxf(affine(acc[n][2], s0, b0), 0.f),
                    fmaxf(affine(acc[n][3], s1, b1), 0.f));
    }
  }
  __syncthreads();

  // ---- E: out = relu(m2 W3 * s3 + b3 + x1) on the tile, x1 recomputed
  for (int mt = warp; mt * 16 < kT * kT; mt += kWarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int i0 = r0 / kT, j0 = r0 % kT, i1 = r1 / kT, j1 = r1 % kT;
    const int y0 = oy + i0, x0 = ox + j0, y1 = oy + i1, x1 = ox + j1;
    const bool v0 = in_image(y0, x0), v1 = in_image(y1, x1);
    const size_t o0 = ((size_t)(v0 ? y0 : 0) * W + (v0 ? x0 : 0)) * C;
    const size_t o1 = ((size_t)(v1 ? y1 : 0) * W + (v1 ? x1 : 0)) * C;
    const int q0 = (i0 + 1) * kR1 + j0 + 1, q1 = (i1 + 1) * kR1 + j1 + 1;
    uint32_t am[M / 16][4], an[M / 16][4];
#pragma unroll
    for (int kk = 0; kk < M / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      am[kk][0] = ld32(sB + q0 * PS + c);
      am[kk][1] = ld32(sB + q1 * PS + c);
      am[kk][2] = ld32(sB + q0 * PS + c + 8);
      am[kk][3] = ld32(sB + q1 * PS + c + 8);
      an[kk][0] = ld32(sC + r0 * PS + c);
      an[kk][1] = ld32(sC + r1 * PS + c);
      an[kk][2] = ld32(sC + r0 * PS + c + 8);
      an[kk][3] = ld32(sC + r1 * PS + c + 8);
    }
    for (int nt = 0; nt < C / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      float xr[4] = {0.f, 0.f, 0.f, 0.f}, yr[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* wa = k1.w3 + (nt * 8 + g) * M + 2 * t;
      const bf16* wb = k2.w3 + (nt * 8 + g) * M + 2 * t;
#pragma unroll
      for (int kk = 0; kk < M / 16; ++kk) {
        mma_bf16(xr, am[kk], ldg32(wa + kk * 16), ldg32(wa + kk * 16 + 8));
        mma_bf16(yr, an[kk], ldg32(wb + kk * 16), ldg32(wb + kk * 16 + 8));
      }
      const float2 in0 = v0 ? unpack_bf16(ldg32(xb + o0 + c)) : make_float2(0.f, 0.f);
      const float2 in1 = v1 ? unpack_bf16(ldg32(xb + o1 + c)) : make_float2(0.f, 0.f);
      const float sa0 = k1.s3[c], sa1 = k1.s3[c + 1], ba0 = k1.b3[c], ba1 = k1.b3[c + 1];
      const float sb0 = k2.s3[c], sb1 = k2.s3[c + 1], bb0 = k2.b3[c], bb1 = k2.b3[c + 1];
      float x1v[4] = {
          round_bf16(fmaxf(__fadd_rn(affine(xr[0], sa0, ba0), in0.x), 0.f)),
          round_bf16(fmaxf(__fadd_rn(affine(xr[1], sa1, ba1), in0.y), 0.f)),
          round_bf16(fmaxf(__fadd_rn(affine(xr[2], sa0, ba0), in1.x), 0.f)),
          round_bf16(fmaxf(__fadd_rn(affine(xr[3], sa1, ba1), in1.y), 0.f))};
      if (v0)
        *reinterpret_cast<uint32_t*>(ob + o0 + c) =
            pack_bf16(fmaxf(__fadd_rn(affine(yr[0], sb0, bb0), x1v[0]), 0.f),
                      fmaxf(__fadd_rn(affine(yr[1], sb1, bb1), x1v[1]), 0.f));
      if (v1)
        *reinterpret_cast<uint32_t*>(ob + o1 + c) =
            pack_bf16(fmaxf(__fadd_rn(affine(yr[2], sb0, bb0), x1v[2]), 0.f),
                      fmaxf(__fadd_rn(affine(yr[3], sb1, bb1), x1v[3]), 0.f));
    }
  }
}

}  // namespace

// x, out: (B, H, W, 256) bf16 NHWC. w: per block w1, w2, w3 (bf16) and
// s1, b1, s2, b2, s3, b3 (f32), block 1 then block 2 (18 pointers).
extern "C" int bottleneck_chain_forward(const void* x, void* out,
                                        const void* const* w, int B, int H,
                                        int W, int C, int M, void* stream) {
  if (C != 256 || M != 64) return static_cast<int>(cudaErrorInvalidValue);
  Block blk[2];
  for (int i = 0; i < 2; ++i) {
    const void* const* p = w + 9 * i;
    blk[i] = Block{static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[3]),
                   static_cast<const bf16*>(p[6]), static_cast<const float*>(p[1]),
                   static_cast<const float*>(p[2]), static_cast<const float*>(p[4]),
                   static_cast<const float*>(p[5]), static_cast<const float*>(p[7]),
                   static_cast<const float*>(p[8])};
  }
  constexpr int PS = 64 + 8;
  const size_t smem = sizeof(bf16) * PS * (kR0 * kR0 + kR1 * kR1 + kT * kT);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_chain2<256, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, B);
  bottleneck_chain2<256, 64><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), blk[0], blk[1], H, W);
  return static_cast<int>(cudaGetLastError());
}
