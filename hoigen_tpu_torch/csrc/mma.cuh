// Warp-level bf16 tensor-core helpers shared by the kernels in this folder.
//
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). With g = lane / 4 and
// t = lane % 4, a thread holds:
//   A (16x16, row-major):  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                          a2 = A[g][2t+8..2t+9]  a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"):       b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C (16x8, f32):         c0,c1 = C[g][2t..2t+1] c2,c3 = C[g+8][2t..2t+1]
// Every kernel stores B as (n, k) row-major, so b0/b1 are 4-byte loads, and
// reuses a C fragment as the A fragment of the next product (the columns of
// two adjacent n-tiles are one 16-wide k-step).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace hoigen {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even);
// `lo` is the element with the smaller column index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// bf16 rounding of an f32 value, returned as f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16-byte asynchronous copy global -> shared; when `pred` is false nothing
// is read and the 16 shared bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4-byte asynchronous copy global -> shared, zero-filled when `pred` is
// false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `n` of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// Four 8x8 b16 matrices from the shared-memory address `s`: lanes
// 8i..8i+7 give the row addresses of matrix i (16 bytes each), and r[i] is
// this lane's fragment of matrix i (row lane / 4, elements 2 (lane % 4)
// and the next). Rows r..r+15 at k..k+15 of a row-major A, with lane
// addresses row r + (lane & 15), column k + (lane >> 4) * 8, give the mma
// A fragment a[0..3].
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i, and r[i] is this lane's fragment of
// matrix i's transpose. For B stored (k, n) row-major, rows k..k+15 at
// columns n..n+15 give the mma B fragments {b0, b1} of the n-tile n..n+7
// in r[0], r[1] and of n+8..n+15 in r[2], r[3], with lane addresses
// row k + (lane & 15), column n + (lane >> 4) * 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

}  // namespace hoigen
