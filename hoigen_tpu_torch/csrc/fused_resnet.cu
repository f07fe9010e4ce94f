// Chains of stride-1 frozen-BN ResNet bottlenecks, NHWC bf16, for Hopper
// (sm_90a).
//
// Replaces hoigen_tpu/ops/fused_resnet.py::_chain_kernel (Pallas). Per
// block:
//   m1  = relu(x  W1 * s1 + b1)           1x1, C -> M, rounded to bf16
//   m2  = relu(conv3x3(m1) * s2 + b2)     SAME, M -> M, rounded to bf16
//   out = relu(m2 W3 * s3 + b3 + x)       1x1, M -> C, rounded to bf16
// Products take bf16 operands and accumulate in f32; the epilogues are f32
// (a multiply, then an add, as the plain version). m1 is zero outside the
// image (the 3x3's SAME padding), as the TPU kernel zeroes its out-of-image
// halo rows before every 3x3.
//
// Two routes, chosen by the wrapper (ops/fused_resnet.py::_chain_plan):
//
// 1. Fused (chain2_fused): two blocks with C = 256 and M = 64, the DETR-R50
//    layer1 tail, which the eval step runs once at (4, 200, 336). Bound on
//    this card: x read once and out written once, 275 MB, 0.0822 ms at
//    3.35 TB/s, against 74.9 GFLOP, 0.0757 ms at 989 TFLOP/s.
//    A block of threads owns a TH x TW tile of output pixels and runs the
//    whole chain on it, recomputing a 2-pixel halo (at 8 x 16, 1.37x the
//    chain's products counted in 64-row wgmma tiles):
//      P1  m1  of block 1 on the (TH+4) x (TW+4) region R0   -> sM1
//      P2  m2  of block 1 on the (TH+2) x (TW+2) region R1   -> sM2
//      P3a x1 = block 1's output on R1, written over x in place
//      P3b m1  of block 2 on R1 from x1                        -> sM1
//      P4  m2  of block 2 on the tile                          -> sM2
//      P5  out on the tile, over x1 in place, then copied out.
//    What it does about the bound:
//    - x's R0 box arrives once, by four TMA loads of 64 channels each (a
//      4-D tensor map over (C, W, H, B) with the 128-byte swizzle); TMA's
//      zero fill outside the tensor is the image edge's padding of x.
//      It stays in shared memory for the whole chain (4 x R0 x 128 B), and
//      P1 starts on each chunk as it lands.
//    - Weights pass through a ring of 64 x 64 bf16 tiles in shared memory
//      (8 KB each; `stages` deep), 17 a block (W1 by 64 input channels, W2
//      by tap, W3 by 64 output channels), 34 in all, each read from global
//      memory once per block of threads. Thread 0 loads the first ones;
//      then the last warp to release a slot refills it (a count of
//      releases a slot), so that no warp is kept for loading.
//    - Products run on wgmma.m64n64k16 with B (the weight tile) from
//      shared memory. A comes from shared memory too where a phase's rows
//      are stored in order (P1 over x, P3a and P5 over m2), and otherwise
//      by ldmatrix into registers with one pixel address per lane (P2's
//      and P4's nine tap-shifted tiles, P3b's R1 rows inside x1's R0
//      rows), so no operand is copied. Each warpgroup owns one 64-row
//      group of pixels in a phase (ceil(R0 / 64) warpgroups, 16 warps at
//      8 x 16, up to 128 registers a thread), so one accumulator of 32
//      floats a thread serves a product; in P3a and P5 a second one lets
//      the next 64 output channels' products run during an epilogue.
//    - Both blocks' scales and biases are staged in shared memory, and
//      each epilogue gathers its loads before its first store.
//    Shared memory at 8 x 16 and 4 stages: 217,168 B (one block an SM).
//    What holds it back (PERF.md): the warpgroups step through the same
//    weight tiles together, and each step's fixed costs (its wait for the
//    tile, the products' latency, the release) leave the tensor cores
//    idle most of the time.
//
// 2. Layered (conv_gemm): any other chain, after the wrapper pads C and M
//    to multiples of 64. Each block is three launches of one implicit-GEMM
//    kernel (1x1, 3x3 with zero-filled taps, 1x1 with the residual), whose
//    m1, m2 and block outputs go through global memory in bf16 (the points
//    where the plain version rounds). 128 pixels x 64 output channels a
//    block of threads, cp.async ring of A and B tiles, mma.sync products.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

using namespace hoigen;

namespace {

__device__ __forceinline__ float affine(float acc, float s, float b) {
  return __fadd_rn(__fmul_rn(acc, s), b);
}

// byte offset of 16-byte unit `u` of row `row` in a buffer of 128-byte
// rows stored with the 128-byte swizzle (TMA's SWIZZLE_128B), the buffer
// 1024-byte aligned
__device__ __forceinline__ int swz(int row, int u) {
  return row * 128 + ((u ^ (row & 7)) << 4);
}

__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// ------------------------------------------------------------ fused route
constexpr int kC = 256, kM = 64;
constexpr int kWTile = 64 * 64 * 2;               // one weight tile, bytes
constexpr int kTilesPerBlock = kC / 64 + 9 + kC / 64;
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;

constexpr int round1k(int n) { return (n + 1023) / 1024 * 1024; }

// a block's scales and biases, staged in shared memory: s1, b1, s2, b2
// (M each), s3, b3 (C each)
constexpr int kEpi = 4 * kM + 2 * kC;

template <int TH, int TW>
struct Geo {
  static constexpr int W0 = TW + 4, R0 = (TH + 4) * W0;   // block 1's m1
  static constexpr int W1 = TW + 2, R1 = (TH + 2) * W1;   // block 1's m2
  static constexpr int T = TH * TW;                       // the tile
  static constexpr int G0 = (R0 + 63) / 64, G1 = (R1 + 63) / 64,
                       G2 = (T + 63) / 64;
  static constexpr int NWG = G0;
  static constexpr int kThreads = NWG * 128;
  static constexpr int XCH = round1k(R0 * 128);   // one 64-channel chunk
  static constexpr int OFF_M1 = 4 * XCH;
  static constexpr int OFF_M2 = OFF_M1 + round1k(R0 * 128);
  static constexpr int OFF_EPI = OFF_M2 + round1k(R1 * 128);
  static constexpr int OFF_RING = OFF_EPI + 2 * kEpi * 4;
  static constexpr size_t smem(int stages) {
    return 1024 + OFF_RING + (size_t)stages * (kWTile + 12) + 4 * 8;
  }
};

struct BlockEpi {
  const float *s1, *b1, *s2, *b2, *s3, *b3;
};

struct ChainArgs {
  BlockEpi blk[2];
  int H, W;
};

struct Maps {
  CUtensorMap x;        // (C, W, H, B), box (64, TW + 4, TH + 4, 1)
  CUtensorMap w[6];     // per block: W1 (M, C), W2 (M, 9M), W3 (C, M)
};

constexpr int kTiles = 2 * kTilesPerBlock;

// The weight tiles in the order the phases consume them, through a ring
// of `stages` slots. Thread 0 loads the first `stages`; after that, the
// last of the warps that use a tile to release it loads the tile `stages`
// later into its slot (a count of releases a slot, in shared memory, tells
// it that it was the last). Only the warpgroups active in a phase touch
// its tiles.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  unsigned* released;
  int stages;
  int g0, g1, g2;       // warpgroups active on R0, R1 and the tile
  const Maps* maps;

  // warps that use tile i: per block, m1 on R0 (block 1) or R1 (block 2),
  // m2 and out on R1 (block 1) or the tile (block 2)
  __device__ __forceinline__ unsigned users(int i) const {
    const int kb = i / kTilesPerBlock, r = i % kTilesPerBlock;
    return 4 * (r < 4 ? (kb == 0 ? g0 : g1) : (kb == 0 ? g1 : g2));
  }

  // load weight tile i of the sequence into its slot: per block, W1 by
  // 64 input channels, W2 by tap, W3 by 64 output channels
  __device__ __forceinline__ void load(int i) const {
    const int s = i % stages, kb = i / kTilesPerBlock,
              r = i % kTilesPerBlock;
    int mat = 2, c0 = 0, c1 = 64 * (r - 13);
    if (r < 4) {
      mat = 0; c0 = 64 * r; c1 = 0;
    } else if (r < 13) {
      mat = 1; c0 = 64 * (r - 4); c1 = 0;
    }
    mbar_expect_tx(&full[s], kWTile);
    tma_load(base + s * kWTile,
             reinterpret_cast<uint64_t>(&maps->w[3 * kb + mat]), &full[s],
             c0, c1);
  }
  // wait for weight tile `it` of the sequence; its shared memory
  __device__ __forceinline__ const unsigned char* acquire(int it) const {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    return base + s * kWTile;
  }
  // this warp is done with tile `it` (its products on it have completed)
  __device__ __forceinline__ void release(int it, int lane) const {
    __syncwarp();
    if (lane == 0) {
      // the warp's products on the slot have completed (their wait
      // returned), so the slot may be overwritten once every user counted
      unsigned* n = &released[it % stages];
      if (atomicAdd(n, 1u) == users(it) - 1) {
        atomicExch(n, 0u);
        if (it + stages < kTiles) load(it + stages);
      }
    }
  }
};

// the warp's A fragments of the four k-steps of a 64-channel buffer, this
// lane's row (pixel) `row`
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const unsigned char* buf, int row,
                                       int lane) {
  const uint32_t base = smem_u32(buf);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(a[ks], base + swz(row, 2 * ks + (lane >> 4)));
}

// acc (64 x 64) += A (64 x 64, registers) W^T, W the 64 x 64 weight tile
// at `wt`
__device__ __forceinline__ void mma_tile(float (&acc)[32],
                                         uint32_t (&a)[4][4],
                                         const unsigned char* wt) {
  fence_regs(a);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    Wgmma<64>::mma(acc, a[ks], sw128_desc(wt + ks * 32));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

// issue acc (64 x 64) += A W^T as one wgmma group, with both in shared
// memory: A the 64 x 64 tile of 128-byte rows at `a` (1024-byte aligned,
// 128-byte swizzled, as TMA writes x and the epilogues write m2), W the
// weight tile at `wt`
__device__ __forceinline__ void mma_issue_ss(float (&acc)[32],
                                             const unsigned char* a,
                                             const unsigned char* wt) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    Wgmma<64>::mma(acc, sw128_desc(a + ks * 32), sw128_desc(wt + ks * 32));
  wgmma_commit();
}

// the same, waiting for the products
__device__ __forceinline__ void mma_tile_ss(float (&acc)[32],
                                            const unsigned char* a,
                                            const unsigned char* wt) {
  mma_issue_ss(acc, a, wt);
  wgmma_wait<0>();
  fence_acc(acc);
}

// acc += sum over t < n of A_t W_t^T, the weight tiles it, it + 1, ... of
// the ring, A_t (64 x 64) brought into registers by load(t, a). A
// warpgroup that is not `active` in the phase skips its tiles.
template <class LoadA>
__device__ __forceinline__ void mma_phase(float (&acc)[32], int n, int& it,
                                          const Ring& ring, bool active,
                                          int lane, LoadA load) {
  if (!active) {
    it += n;
    return;
  }
  uint32_t a[4][4];
#pragma unroll 1
  for (int t = 0; t < n; ++t, ++it) {
    load(t, a);
    mma_tile(acc, a, ring.acquire(it));
    ring.release(it, lane);
  }
}

// this lane's scales and biases of columns 8j + 2t and 8j + 2t + 1 of a
// 64-channel chunk, t = lane % 4, for the four j = 4 jh .. 4 jh + 3. The
// epilogues gather their loads for four j before the first store, so that
// the loads overlap, and take the chunk in two halves, to hold the
// registers that gathering costs
__device__ __forceinline__ void load_affine(float2 (&sc)[4], float2 (&bi)[4],
                                            const float* s, const float* b,
                                            int jh, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = *reinterpret_cast<const float2*>(s + 8 * (4 * jh + j) +
                                             2 * (lane & 3));
    bi[j] = *reinterpret_cast<const float2*>(b + 8 * (4 * jh + j) +
                                             2 * (lane & 3));
  }
}

// relu(acc * s + b) in bf16 into the rows of a swizzled 64-channel
// buffer; rows from `rows` on are dropped, and rows for which zero(row)
// holds get zeros
template <class Zero>
__device__ __forceinline__ void store_act(const float (&acc)[32],
                                          unsigned char* dst, int erow,
                                          int rows, const float* s,
                                          const float* b, int lane,
                                          Zero zero) {
  const int t = lane & 3;
  bool z[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) z[h] = erow + 8 * h < rows && zero(erow + 8 * h);
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    float2 sc[4], bi[4];
    load_affine(sc, bi, s, b, jh, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = erow + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jh + jj;
        const uint32_t v =
            z[h] ? 0u
                 : pack_bf16(fmaxf(affine(acc[4 * j + 2 * h], sc[jj].x,
                                          bi[jj].x), 0.f),
                             fmaxf(affine(acc[4 * j + 2 * h + 1], sc[jj].y,
                                          bi[jj].y), 0.f));
        *reinterpret_cast<uint32_t*>(dst + swz(row, j) + 4 * t) = v;
      }
    }
  }
}

// relu(acc * s + b + r) in bf16 over r in place: r is 64-channel chunk
// `chunk` of the x buffer at the R0 pixel map(row) for each row below
// `rows`; s and b are the chunk's 64 values
template <class Map>
__device__ __forceinline__ void residual_in_place(const float (&acc)[32],
                                                  unsigned char* chunk,
                                                  int erow, int rows,
                                                  const float* s,
                                                  const float* b, int lane,
                                                  Map map) {
  const int t = lane & 3;
  int p[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) p[h] = map(min(erow + 8 * h, rows - 1));
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    float2 sc[4], bi[4];
    load_affine(sc, bi, s, b, jh, lane);
    uint32_t r[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        r[h][jj] = *reinterpret_cast<const uint32_t*>(
            chunk + swz(p[h], 4 * jh + jj) + 4 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (erow + 8 * h >= rows) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jh + jj;
        const float2 x = unpack_bf16(r[h][jj]);
        *reinterpret_cast<uint32_t*>(chunk + swz(p[h], j) + 4 * t) =
            pack_bf16(fmaxf(__fadd_rn(affine(acc[4 * j + 2 * h], sc[jj].x,
                                             bi[jj].x), x.x), 0.f),
                      fmaxf(__fadd_rn(affine(acc[4 * j + 2 * h + 1],
                                             sc[jj].y, bi[jj].y), x.y),
                            0.f));
      }
    }
  }
}

template <int TH, int TW>
__global__ void __launch_bounds__(Geo<TH, TW>::kThreads, 1)
chain2_fused(const __grid_constant__ Maps maps, bf16* __restrict__ out,
             const ChainArgs args, int stages) {
  using G = Geo<TH, TW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xbuf = smem;
  unsigned char* sm1 = smem + G::OFF_M1;
  unsigned char* sm2 = smem + G::OFF_M2;
  Ring ring;
  ring.base = smem + G::OFF_RING;
  ring.full = reinterpret_cast<uint64_t*>(ring.base + stages * kWTile);
  uint64_t* xfull = ring.full + stages;      // one for each x chunk
  ring.released = reinterpret_cast<unsigned*>(xfull + 4);
  ring.stages = stages;
  ring.g0 = G::G0;
  ring.g1 = G::G1;
  ring.g2 = G::G2;
  ring.maps = &maps;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int oy = blockIdx.y * TH, ox = blockIdx.x * TW, bz = blockIdx.z;
  const int H = args.H, W = args.W;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&ring.full[s], 1);
      ring.released[s] = 0;
    }
    for (int c = 0; c < 4; ++c) mbar_init(&xfull[c], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    // x's box in four chunks, each after the weight tile that meets it
    // first, then the rest of the ring's first tiles
    const uint64_t xmap = reinterpret_cast<uint64_t>(&maps.x);
    for (int c = 0; c < 4; ++c) {
      if (c < stages) ring.load(c);
      mbar_expect_tx(&xfull[c], G::R0 * 128);
      tma_load_4d(xbuf + c * G::XCH, xmap, &xfull[c], 64 * c, ox - 2,
                  oy - 2, bz);
    }
    for (int i = 4; i < stages && i < kTiles; ++i) ring.load(i);
  }
  // the epilogues' scales and biases, both blocks, while x lands
  float* epi = reinterpret_cast<float*>(smem + G::OFF_EPI);
  for (int i = tid; i < 2 * kEpi; i += G::kThreads) {
    const BlockEpi e = i < kEpi ? args.blk[0] : args.blk[1];
    const int j = i % kEpi;
    const float* src = j < 4 * kM
        ? (j < kM ? e.s1 : j < 2 * kM ? e.b1 : j < 3 * kM ? e.s2 : e.b2) + j % kM
        : (j < 4 * kM + kC ? e.s3 : e.b3) + (j - 4 * kM) % kC;
    epi[i] = __ldg(src);
  }
  __syncthreads();

  const int wg = warp >> 2, wq = warp & 3;
  const int lrow = 64 * wg + 16 * wq + (lane & 15);   // ldmatrix row
  const int erow = 64 * wg + 16 * wq + (lane >> 2);   // epilogue row
  auto outside = [&](int y, int x) { return y < 0 || y >= H || x < 0 || x >= W; };
  int it = 0;

#pragma unroll 1
  for (int kb = 0; kb < 2; ++kb) {
    const float* sb = epi + kb * kEpi;
    const BlockEpi e{sb, sb + kM, sb + 2 * kM, sb + 3 * kM, sb + 4 * kM,
                     sb + 4 * kM + kC};
    // rows of this block's m1 and m2 regions: block 1 has its m1 on R0 and
    // its m2 on R1; block 2 its m1 on R1 and its m2 on the tile
    const int w_in = kb == 0 ? G::W0 : G::W1;        // m1 region width
    const int w_out = kb == 0 ? G::W1 : TW;          // m2 region width
    const int r_in = kb == 0 ? G::R0 : G::R1;
    const int r_out = kb == 0 ? G::R1 : G::T;
    const int g_in = kb == 0 ? G::G0 : G::G1;
    const int g_out = kb == 0 ? G::G1 : G::G2;
    const int off = kb == 0 ? 0 : 1;                 // m1 region's R0 origin
    // R0 pixel of row `row` of a region `w` wide whose origin is (o, o)
    auto r0_of = [&](int row, int w, int o) {
      return (row / w + o) * G::W0 + row % w + o;
    };

    // m1: 1x1 over x (block 1: the rows of R0 in order, so A is read by
    // wgmma from the x buffer itself, each chunk as it lands) or over x1
    // (block 2: the rows of R1 inside R0's, gathered by ldmatrix)
    {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      if (kb == 0) {
#pragma unroll 1
        for (int kt = 0; kt < 4; ++kt, ++it) {
          mbar_wait(&xfull[kt], 0);
          mma_tile_ss(acc, xbuf + kt * G::XCH + wg * 64 * 128,
                      ring.acquire(it));
          ring.release(it, lane);
        }
      } else {
        const int p = r0_of(min(lrow, r_in - 1), w_in, off);
        mma_phase(acc, 4, it, ring, wg < g_in, lane,
                  [&](int kt, uint32_t (&a)[4][4]) {
                    load_a(a, xbuf + kt * G::XCH, p, lane);
                  });
      }
      if (wg < g_in)
        store_act(acc, sm1, erow, r_in, e.s1, e.b1, lane, [&](int row) {
          return outside(oy - 2 + off + row / w_in, ox - 2 + off + row % w_in);
        });
    }
    __syncthreads();

    // m2: the 3x3 over m1, tap by tap
    {
      const int q = min(lrow, r_out - 1);
      const int qi = q / w_out, qj = q % w_out;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      mma_phase(acc, 9, it, ring, wg < g_out, lane,
                [&](int tap, uint32_t (&a)[4][4]) {
                  load_a(a, sm1, (qi + tap / 3) * w_in + qj + tap % 3, lane);
                });
      if (wg < g_out)
        store_act(acc, sm2, erow, r_out, e.s2, e.b2, lane,
                  [](int) { return false; });
      fence_proxy_async();      // m2 is wgmma's A operand next
    }
    __syncthreads();

    // out: 1x1 over m2 (A read by wgmma from m2's rows) plus the residual,
    // 64 output channels at a time, over the residual in place (block 1:
    // x -> x1 on R1; block 2: x1 -> out on the tile). The next chunk's
    // products run while a chunk's epilogue does, in a second accumulator;
    // the weight tile goes back to the ring before the epilogue
    if (wg < g_out) {
      float acc[2][32];
      auto issue = [&](int c, float (&d)[32]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        mma_issue_ss(d, sm2 + wg * 64 * 128, ring.acquire(it + c));
      };
      issue(0, acc[0]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c + 1 < 4) {
          issue(c + 1, acc[(c + 1) & 1]);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_acc(acc[c & 1]);
        ring.release(it + c, lane);
        residual_in_place(
            acc[c & 1], xbuf + c * G::XCH, erow, r_out, e.s3 + 64 * c,
            e.b3 + 64 * c, lane,
            [&](int row) { return r0_of(row, w_out, off + 1); });
      }
    }
    it += 4;
    __syncthreads();
  }

  // the tile's output, 16 bytes a thread at a time, each pixel's 512 bytes
  // by 32 consecutive threads
  for (int i = tid; i < G::T * 32; i += G::kThreads) {
    const int t = i >> 5, c = (i >> 3) & 3, u = i & 7;
    const int y = oy + t / TW, x = ox + t % TW;
    if (y >= H || x >= W) continue;
    const int p = (t / TW + 2) * G::W0 + t % TW + 2;
    *reinterpret_cast<uint4*>(
        out + (((size_t)bz * H + y) * W + x) * kC + 64 * c + 8 * u) =
        *reinterpret_cast<const uint4*>(xbuf + c * G::XCH + swz(p, u));
  }
}

// a (rows, cols) row-major bf16 matrix read in boxes of 64 x 64,
// 128-byte swizzled
bool weight_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (B, H, W, 256) read in boxes of 64 channels x (TW + 4) x (TH + 4)
bool x_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
           int H, int W, int th, int tw) {
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kC * 2, (cuuint64_t)W * kC * 2,
                                 (cuuint64_t)H * W * kC * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)tw + 4, (cuuint32_t)th + 4, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TH, int TW>
cudaError_t launch_fused(const Maps& maps, bf16* out, const ChainArgs& args,
                         int B, int stages, cudaStream_t stream) {
  using G = Geo<TH, TW>;
  if (G::smem(stages) > (size_t)kSmemLimit)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      chain2_fused<TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((args.W + TW - 1) / TW, (args.H + TH - 1) / TH, B);
  chain2_fused<TH, TW><<<grid, G::kThreads, G::smem(stages), stream>>>(
      maps, out, args, stages);
  return cudaGetLastError();
}

// ---------------------------------------------------------- layered route
constexpr int kGM = 128, kGN = 64, kGStages = 3, kGThreads = 256;
constexpr int kGA = kGM * 128, kGStage = kGA + kGN * 128;

// out[p, n] = relu(sum_{tap, k} a[tap(p), k] w[n, tap * cin + k] * s[n] +
// b[n] (+ res[p, n])) in bf16; a (npix, cin), res and out (npix, n), all
// NHWC over (B, H, W); tap(p) is p itself (TAPS 1) or its 3x3 neighbour
// (TAPS 9), zero outside the image. cin and n are multiples of 64.
template <int TAPS>
__global__ void __launch_bounds__(kGThreads, 2)
conv_gemm(const bf16* __restrict__ a, const bf16* __restrict__ w,
          const float* __restrict__ s, const float* __restrict__ b,
          const bf16* __restrict__ res, bf16* __restrict__ out, int npix,
          int H, int W, int cin, int n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kGM, n0 = blockIdx.y * kGN;
  const int kc_tap = cin / 64, ktiles = TAPS * kc_tap;
  const size_t ldw = (size_t)TAPS * cin;
  const int u = tid & 7;

  // the four A rows and two B rows this thread copies, 16 bytes each
  int ay[4], ax[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + (tid >> 3) + 32 * i;
    const int pc = p < npix ? p : 0;
    ay[i] = p < npix ? (pc / W) % H : -1000;
    ax[i] = pc % W;
  }

  auto load = [&](int kt, int stage) {
    unsigned char* sa = smem + stage * kGStage;
    unsigned char* sb = sa + kGA;
    const int tap = kt / kc_tap, k0 = (kt % kc_tap) * 64 + 8 * u;
    const int dy = TAPS == 9 ? tap / 3 - 1 : 0, dx = TAPS == 9 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 3) + 32 * i;
      const int y = ay[i] + dy, x = ax[i] + dx;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      const bf16* src =
          ok ? a + (size_t)(p0 + row + dy * W + dx) * cin + k0 : a;
      cp_async16(sa + swz(row, u), src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 3) + 32 * i;
      cp_async16(sb + swz(row, u),
                 w + (size_t)(n0 + row) * ldw + (size_t)tap * cin + k0, true);
    }
  };

#pragma unroll
  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < ktiles) load(st, st);
    cp_async_commit();
  }
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    const int nxt = kt + kGStages - 1;
    if (nxt < ktiles) load(nxt, nxt % kGStages);
    cp_async_commit();
    const uint32_t sa = smem_u32(smem + (kt % kGStages) * kGStage);
    const uint32_t sb = sa + kGA;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, sa + swz(16 * warp + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        ldsm_x4(bf, sb + swz(16 * jp + (lane & 7) + ((lane >> 4) << 3),
                             2 * ks + ((lane >> 3) & 1)));
        mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
        mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float2 sc = ldg_f2(s + col), bi = ldg_f2(b + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * warp + (lane >> 2) + 8 * h;
      if (p >= npix) continue;
      float v0 = affine(acc[j][2 * h], sc.x, bi.x);
      float v1 = affine(acc[j][2 * h + 1], sc.y, bi.y);
      if (res != nullptr) {
        const float2 r = unpack_bf16(ldg32(res + (size_t)p * n + col));
        v0 = __fadd_rn(v0, r.x);
        v1 = __fadd_rn(v1, r.y);
      }
      *reinterpret_cast<uint32_t*>(out + (size_t)p * n + col) =
          pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    }
  }
}

template <int TAPS>
cudaError_t launch_layer(const bf16* a, const bf16* w, const float* s,
                         const float* b, const bf16* res, bf16* out, int npix,
                         int H, int W, int cin, int n, cudaStream_t stream) {
  constexpr size_t smem = 1024 + (size_t)kGStages * kGStage;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_gemm<TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((npix + kGM - 1) / kGM, n / kGN);
  conv_gemm<TAPS><<<grid, kGThreads, smem, stream>>>(a, w, s, b, res, out,
                                                     npix, H, W, cin, n);
  return cudaGetLastError();
}

}  // namespace

// Fused route. x, out: (B, H, W, 256) bf16 NHWC. w: per block w1 (64,
// 256), s1, b1, w2 (64, 576), s2, b2, w3 (256, 64), s3, b3 (bf16 weights,
// f32 scales and biases), block 1 then block 2 (18 pointers). (th, tw) is
// the tile and `stages` the weight ring's depth (the wrapper's
// _chain_plan). Returns a cudaError_t.
extern "C" int bottleneck_chain_fused(const void* x, void* out,
                                      const void* const* w, int B, int H,
                                      int W, int th, int tw, int stages,
                                      void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (stages < 2 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Maps maps;
  ChainArgs args;
  if (!x_map(encode, &maps.x, x, B, H, W, th, tw))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 2; ++k) {
    const void* const* p = w + 9 * k;
    if (!weight_map(encode, &maps.w[3 * k], p[0], kM, kC) ||
        !weight_map(encode, &maps.w[3 * k + 1], p[3], kM, 9 * kM) ||
        !weight_map(encode, &maps.w[3 * k + 2], p[6], kC, kM))
      return static_cast<int>(cudaErrorInvalidValue);
    args.blk[k] = BlockEpi{
        static_cast<const float*>(p[1]), static_cast<const float*>(p[2]),
        static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
        static_cast<const float*>(p[7]), static_cast<const float*>(p[8])};
  }
  args.H = H;
  args.W = W;
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (th == 8 && tw == 16)
    err = launch_fused<8, 16>(maps, o, args, B, stages, st);
  else if (th == 16 && tw == 8)
    err = launch_fused<16, 8>(maps, o, args, B, stages, st);
  return static_cast<int>(err);
}

// Layered route, one product of a block: out (npix, n) = relu(conv(a) * s
// + b (+ res)) in bf16, with a (npix, cin) NHWC over (B, H, W), w (n,
// taps * cin) (in = tap * cin + channel, tap = dy * 3 + dx), s and b (n,)
// f32, res (npix, n) or null; taps 1 or 9; cin and n multiples of 64.
extern "C" int bottleneck_conv_forward(const void* a, const void* w,
                                       const void* s, const void* b,
                                       const void* res, void* out, int npix,
                                       int H, int W, int cin, int n, int taps,
                                       void* stream) {
  if (npix == 0) return 0;
  if (cin % 64 || n % 64 || (taps != 1 && taps != 9))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *a_ = static_cast<const bf16*>(a), *w_ = static_cast<const bf16*>(w),
             *r_ = static_cast<const bf16*>(res);
  const float *s_ = static_cast<const float*>(s), *b_ = static_cast<const float*>(b);
  bf16* o = static_cast<bf16*>(out);
  return static_cast<int>(
      taps == 1 ? launch_layer<1>(a_, w_, s_, b_, r_, o, npix, H, W, cin, n, st)
                : launch_layer<9>(a_, w_, s_, b_, r_, o, npix, H, W, cin, n, st));
}
