// Frozen-BN convolution epilogue for Hopper (sm_90a): one elementwise pass
// over a convolution's raw NHWC output.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the ResNet-50's folded-BN
// scale and bias, the residual add and the ReLU into the convolutions
// around them (hoigen_tpu/models/detr/resnet.py leaves them to XLA). On the
// card the convolutions are cuDNN's, and the ATen chain after each one
// (y * s, + b, relu; at a block's end also the downsample's y * s + b,
// out + identity and relu) is two to six passes over device memory. This
// kernel is one pass, in one of two modes chosen by the launcher's
// arguments:
//
//   site:      out = relu(r(r(y * s) + b))
//   block end: out = relu(r(r(r(y * s) + b) + id)),
//              id = r(r(yd * sd) + bd)   (the downsample's raw output)
//              or id = x                 (the block input)
//
// where r rounds to the activation dtype (bf16, round to nearest even;
// f32). r falls where the ATen chain rounds: each ATen binary op computes
// in f32 and rounds its result to the tensor's dtype, so the kernel gives
// the chain's bits. __fmul_rn and __fadd_rn keep
// nvcc from contracting a multiply and an add into one FMA, which would
// round once where the chain rounds twice. The ReLU is v < 0 ? 0 : v, as
// ATen's clamp_min(v, 0) (a NaN passes through).
//
// Bound on this card: bytes. A site reads y and writes out (4 B an element
// in bf16); a block end reads y and id (the downsample's epilogue output
// never reaches memory) and writes out (6 B); scales and biases are a few
// KB. At 3.35 TB/s the stem of a (32, 1344, 1344) batch, 0.925 G elements,
// takes 1.10 ms.
//
// Design: each thread moves 16-byte vectors (8 bf16 or 4 f32 lanes; C is a
// multiple of 8, so a vector holds channels of one pixel) in a grid-stride
// loop, two vectors in flight a step, over one wave of blocks (the
// occupancy times the SMs). The scale and bias vectors of a vector's
// channels come through the read-only cache (__ldg), which holds all C of
// them. The output may be y itself (the wrapper writes over the conv
// output, which nothing else reads): each vector is read, then written, by
// one thread. No atomics, no shared memory: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// modes: a site, a block end with the block input, a block end with the
// downsample's raw output
enum Mode { kSite = 0, kIdentity = 1, kDown = 2 };

template <typename T>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float f) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(bits(f[0]) | bits(f[1]) << 16,
                      bits(f[2]) | bits(f[3]) << 16,
                      bits(f[4]) | bits(f[5]) << 16,
                      bits(f[6]) | bits(f[7]) << 16);
  }
  __device__ static float round(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
};

template <>
struct Lanes<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float f) { return f; }
};

// r(r(v * s) + b), lane by lane, in place on v
template <typename T>
__device__ __forceinline__ void scale_bias(float* v, const uint4& sv,
                                           const uint4& bv) {
  using L = Lanes<T>;
  float s[L::kN], b[L::kN];
  L::unpack(sv, s);
  L::unpack(bv, b);
#pragma unroll
  for (int k = 0; k < L::kN; ++k)
    v[k] = L::round(__fadd_rn(L::round(__fmul_rn(v[k], s[k])), b[k]));
}

// the epilogue of one vector: y's lanes and, at a block end, id's (rv, and
// for the downsample its scale and bias vectors)
template <typename T, int kMode>
__device__ __forceinline__ uint4 apply(const uint4& yv, const uint4* s,
                                       const uint4* b, const uint4& rv,
                                       const uint4* sd, const uint4* bd,
                                       int ch) {
  using L = Lanes<T>;
  float v[L::kN];
  L::unpack(yv, v);
  scale_bias<T>(v, __ldg(s + ch), __ldg(b + ch));
  if (kMode != kSite) {
    float id[L::kN];
    L::unpack(rv, id);
    if (kMode == kDown) scale_bias<T>(id, __ldg(sd + ch), __ldg(bd + ch));
#pragma unroll
    for (int k = 0; k < L::kN; ++k) v[k] = L::round(__fadd_rn(v[k], id[k]));
  }
#pragma unroll
  for (int k = 0; k < L::kN; ++k) v[k] = v[k] < 0.f ? 0.f : v[k];
  return L::pack(v);
}

// n 16-byte vectors of y (and of r, out), c vectors a pixel; y and out may
// be one buffer
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const uint4* y, const uint4* __restrict__ s,
                         const uint4* __restrict__ b, const uint4* r,
                         const uint4* __restrict__ sd,
                         const uint4* __restrict__ bd, uint4* out, int64_t n,
                         int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int step = static_cast<int>(stride % c);
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int ci = static_cast<int>(i % c);
  const uint4 none = make_uint4(0, 0, 0, 0);
  // the channel vector of the element one stride on
  auto next = [=](int ch) { return ch + step >= c ? ch + step - c : ch + step; };
  for (; i + stride < n; i += 2 * stride) {
    const int64_t j = i + stride;
    const int cj = next(ci);
    const uint4 y0 = y[i], y1 = y[j];
    const uint4 r0 = kMode != kSite ? r[i] : none;
    const uint4 r1 = kMode != kSite ? r[j] : none;
    out[i] = apply<T, kMode>(y0, s, b, r0, sd, bd, ci);
    out[j] = apply<T, kMode>(y1, s, b, r1, sd, bd, cj);
    ci = next(cj);
  }
  if (i < n)
    out[i] = apply<T, kMode>(y[i], s, b,
                                    kMode != kSite ? r[i] : none, sd, bd, ci);
}

template <typename T, int kMode>
cudaError_t launch(const void* y, const void* s, const void* b, const void* r,
                   const void* sd, const void* bd, void* out, int64_t n,
                   int c, int sms, cudaStream_t stream) {
  auto kernel = conv_epilogue_kernel<T, kMode>;
  // blocks an SM holds, asked once a kernel
  static const int per_sm = [&] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, kThreads, 0);
    return std::max(v, 1);
  }();
  const int64_t blocks = std::min<int64_t>(
      (n + kThreads - 1) / kThreads, static_cast<int64_t>(per_sm) * sms);
  kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint4*>(y), static_cast<const uint4*>(s),
      static_cast<const uint4*>(b), static_cast<const uint4*>(r),
      static_cast<const uint4*>(sd), static_cast<const uint4*>(bd),
      static_cast<uint4*>(out), n, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* y, const void* s, const void* b,
                     const void* r, const void* sd, const void* bd, void* out,
                     int64_t n, int c, int sms, cudaStream_t st) {
  if (r == nullptr)
    return launch<T, kSite>(y, s, b, r, sd, bd, out, n, c, sms, st);
  if (sd == nullptr)
    return launch<T, kIdentity>(y, s, b, r, sd, bd, out, n, c, sms, st);
  return launch<T, kDown>(y, s, b, r, sd, bd, out, n, c, sms, st);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype 0: bf16, 1: f32. y, r, out: n elements, NHWC with c channels; s, b,
// sd, bd: c each. r null: a site; r given: a block end, with sd and bd
// both given for the downsample or both null for the block input. out may
// be y. sms: the card's SMs (the grid is one wave). Returns a cudaError_t.
extern "C" int conv_epilogue(int dtype, const void* y, const void* s,
                             const void* b, const void* r, const void* sd,
                             const void* bd, void* out, long long n, int c,
                             int sms, void* stream) {
  const int lanes = dtype == 0 ? 8 : 4;
  const bool down = sd != nullptr || bd != nullptr;
  if ((dtype != 0 && dtype != 1) || c <= 0 || c % 8 || n < 0 || n % c ||
      (down && (sd == nullptr || bd == nullptr || r == nullptr)) || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {y, s, b, r, sd, bd, static_cast<const void*>(out)})
    if (!aligned(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nv = n / lanes;
  const int cv = c / lanes;
  return static_cast<int>(
      dtype == 0
          ? dispatch<__nv_bfloat16>(y, s, b, r, sd, bd, out, nv, cv, sms, st)
          : dispatch<float>(y, s, b, r, sd, bd, out, nv, cv, sms, st));
}
