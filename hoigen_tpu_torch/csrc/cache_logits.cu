// Tip-Adapter cache scoring for Hopper (sm_90a): two launches of one bf16
// product kernel, built on TMA and wgmma.
//
// Replaces hoigen_tpu/ops/pallas_cache.py::_kernel (the Pallas forward):
//   out = ((X W^T + b) L) / s
// with the TPU kernel's rounding points: X enters the products as bf16
// (the wrapper casts it, as the JAX package casts it outside its
// pallas_call), phi = X W^T is accumulated in f32, + b in f32, and rounded
// to bf16 (round to nearest even) before the second product, which is
// accumulated in f32 and divided by s.
//
// Bound on this card: at the HICO-DET eval shapes (n = 1800 pair rows for
// a batch of 4, D = 512, R = 1200, C = 600) the function is 2 n R (D + C) =
// 4.80 GFLOP against about 10.7 MB of operands and output, so the tensor
// cores bound it (4.86 us at 989 TFLOP/s; the bytes take 3.2 us at 3.35
// TB/s).
//
// Design. One kernel, out = epilogue(A B^T) with A (M x K) and B (N x K)
// both K-major bf16, launched twice per call:
//   1. phi: A = X (n, D), B = W (R, D); epilogue + b[r] (0 for r >= R),
//      round to bf16; output the phi scratch (n, RP), RP = R rounded up to
//      a multiple of 8. Every one of the RP columns is written: W's rows
//      past R arrive as TMA's zero fill, so columns R..RP-1 are exactly 0
//      (they meet the zero rows of L^T in launch 2, where garbage could
//      make NaN * 0).
//   2. logits: A = phi (n, RP), B = L^T (LC, RP), LC = C rounded up to a
//      multiple of 8; epilogue / s[c]; output (n, C) f32, only the first C
//      columns written.
// phi is computed once per call. The TPU kernel keeps it in VMEM; here it
// makes a round trip through memory instead (4.32 MB of bf16 at the eval
// shapes, which stays in the 50 MB L2 between the launches; at most 2.6 us
// even at HBM rate). Keeping it on chip would need the (64 x 1200) phi
// tile of a block (150 KB) beside the streamed W and L, and either
// recomputing phi for every C tile (2.8x the work, the previous design) or
// splitting R over a cluster with a shared-memory reduction.
//
// A block is one warpgroup (128 threads) and computes a 64 x BN tile with
// wgmma.m64nBNk16 (f32 accumulators in registers, BN = 32, 64 or 128,
// chosen by the wrapper's _gemm_plan so that the grid gives every SM two
// blocks where it can).
// Thread 0 issues TMA loads of 64 x 64 tiles of A and BN x 64 tiles of B
// (64 bf16 = 128 B, the 128-byte swizzle that wgmma's shared-memory
// descriptors read directly) into a ring of `stages` stages; each stage
// has a `full` mbarrier (TMA bytes landed) and an `empty` one (the four
// warps' products on it are done). TMA zero-fills every read past M, N and
// K, so any n, R and C work; the epilogue masks its stores. Each output
// element has one owner and is summed in one fixed order: no atomics, and
// two calls give the same bits.
//
// What holds it back on the card (PERF.md): every block streams its own
// 64-row tile of A and BN-row tile of B from L2, 2 M N K (1/64 + 1/BN)
// bytes a launch, and both launches run at the rate of that L2 traffic,
// well below the tensor cores'. Wider blocks (two consumer warpgroups)
// and TMA multicast across a cluster would cut it.
//
// Shared memory per block: stages x ((64 + BN) x 64 x 2 B + two 8-byte
// barriers), plus 1024 B to align the ring to the swizzle's 1024-byte
// atom. The wrapper runs 3 stages: BN = 128, 74,800 B (three blocks per
// SM, so the 290 blocks of the phi launch at the eval shapes run in one
// wave, where 4 stages, 99,392 B, fit two a SM and need two waves);
// BN = 64, 50,224 B (four); BN = 32, 37,936 B (five). The limit is
// 232,448 B a block.
//
// Host side: the four tensor maps are encoded on every call (pure host
// work) with cuTensorMapEncodeTiled (hopper.cuh), and passed as
// __grid_constant__ parameters. Both launches go on the caller's stream.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hoigen;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64;         // rows of A per block: one wgmma M
constexpr int kBK = 64;         // K per stage: 64 bf16 = one 128-byte row
constexpr int kThreads = 128;   // one warpgroup
constexpr int kMaxStages = 4;
constexpr int kATile = kBM * kBK * 2;

// the ring, 1024 B to align it to the swizzle's atom, and two 8-byte
// barriers a stage
constexpr size_t smem_bytes(int bn, int stages) {
  return 1024 + (size_t)stages * ((kBM + bn) * kBK * 2 + 16);
}

// out = epilogue(A B^T), one 64 x BN tile a block. kLogits false: out is
// bf16 (M, N), value bf16(acc + (col < n_vec ? vec[col] : 0)), N a
// multiple of 8; kLogits true: out is f32 (M, N), value acc / vec[col].
template <int BN, bool kLogits>
__global__ void __launch_bounds__(kThreads, 1)
gemm_bf16_tn(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             void* __restrict__ out, const float* __restrict__ vec, int M,
             int N, int K, int n_vec, int stages) {
  constexpr int kStage = kATile + BN * kBK * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);     // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the maps stay in parameter space: only their addresses are taken
  const uint64_t map_a_addr = reinterpret_cast<uint64_t>(&map_a);
  const uint64_t map_b_addr = reinterpret_cast<uint64_t>(&map_b);
  auto load = [=](int kt, int s) {
    unsigned char* st = smem + s * kStage;
    mbar_expect_tx(&full[s], kStage);
    tma_load(st, map_a_addr, &full[s], kt * kBK, m0);
    tma_load(st + kATile, map_b_addr, &full[s], kt * kBK, n0);
  };
  if (tid == 0)
    for (int kt = 0; kt < k_tiles && kt < stages; ++kt) load(kt, kt);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % stages;
    mbar_wait(&full[s], (kt / stages) & 1);
    const unsigned char* st = smem + s * kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<BN>::mma(acc, sw128_desc(st + kk * 32),
                     sw128_desc(st + kATile + kk * 32));
    wgmma_commit();
    // the previous k-tile's products are done: release its stage, and
    // refill it with the k-tile `stages` ahead
    wgmma_wait<1>();
    if (kt > 0) {
      const int ps = (kt - 1) % stages;
      if (lane == 0) mbar_arrive(&empty[ps]);
      if (tid == 0 && kt - 1 + stages < k_tiles) {
        mbar_wait(&empty[ps], ((kt - 1) / stages) & 1);
        load(kt - 1 + stages, ps);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const int row0 = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (row >= M) continue;
      if constexpr (kLogits) {
        float* o = static_cast<float*>(out) + (size_t)row * N;
        if (col < N) o[col] = v0 / vec[col];
        if (col + 1 < N) o[col + 1] = v1 / vec[col + 1];
      } else if (col < N) {        // N is even: col + 1 < N as well
        const float b0 = col < n_vec ? vec[col] : 0.f;
        const float b1 = col + 1 < n_vec ? vec[col + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                           (size_t)row * N + col) =
            __floats2bfloat162_rn(__fadd_rn(v0, b0), __fadd_rn(v1, b1));
      }
    }
  }
}

// a (rows, cols) row-major bf16 matrix read in boxes of box_rows x 64,
// 128-byte swizzled, reads out of bounds filled with zeros
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kLogits>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b, void* out,
                   const float* vec, int M, int N, int K, int n_vec,
                   int stages, cudaStream_t stream) {
  // once per kernel and process: the largest ring this kernel may get
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_tn<BN, kLogits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(BN, kMaxStages)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  gemm_bf16_tn<BN, kLogits><<<grid, kThreads, smem_bytes(BN, stages),
                              stream>>>(a, b, out, vec, M, N, K, n_vec,
                                        stages);
  return cudaGetLastError();
}

template <bool kLogits>
cudaError_t dispatch(int bn, const CUtensorMap& a, const CUtensorMap& b,
                     void* out, const float* vec, int M, int N, int K,
                     int n_vec, int stages, cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch<32, kLogits>(a, b, out, vec, M, N, K, n_vec, stages,
                                 stream);
    case 64:
      return launch<64, kLogits>(a, b, out, vec, M, N, K, n_vec, stages,
                                 stream);
    case 128:
      return launch<128, kLogits>(a, b, out, vec, M, N, K, n_vec, stages,
                                  stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (N, D) bf16, w (R, D) bf16, b (R,) f32, lt (LC, RP) bf16 (L^T, zero
// padded), s (>= C,) f32, phi (N, RP) bf16 scratch, out (N, C) f32. bn1
// and bn2 are the block widths of the two launches, stages the depth of
// their rings (the wrapper's _gemm_plan). Returns a cudaError_t.
extern "C" int cache_logits_forward(const void* x, const void* w,
                                    const void* b, const void* lt,
                                    const void* s, void* phi, void* out,
                                    int N, int D, int R, int RP, int C,
                                    int LC, int bn1, int bn2, int stages,
                                    void* stream) {
  if (N == 0) return 0;
  if (D % 8 || RP % 8 || LC % 8 || RP < R || LC < C || stages < 2 ||
      stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_x, map_w, map_phi, map_lt;
  if (!tensor_map(encode, &map_x, x, N, D, kBM) ||
      !tensor_map(encode, &map_w, w, R, D, bn1) ||
      !tensor_map(encode, &map_phi, phi, N, RP, kBM) ||
      !tensor_map(encode, &map_lt, lt, LC, RP, bn2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dispatch<false>(bn1, map_x, map_w, phi, static_cast<const float*>(b),
                      N, RP, D, R, stages, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      dispatch<true>(bn2, map_phi, map_lt, out, static_cast<const float*>(s),
                     N, C, RP, C, stages, st));
}
