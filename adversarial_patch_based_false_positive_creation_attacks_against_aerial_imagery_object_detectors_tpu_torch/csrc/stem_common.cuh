// Helpers shared by the hand-written kernels (stem_fused.cu, stem_bwd.cu,
// planar_conv.cu, res_fused.cu): float conversion of the compute dtype,
// an 8-wide weight load through the read-only cache (load8) and the same
// from shared memory (load8s).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stem {

constexpr int NT = 256;  // threads per block
constexpr int CT = 8;    // output channels per thread
constexpr float LEAKY = 0.1f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(unsigned char v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round to the compute dtype and back (T of the Pallas kernels' stores)
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// 8 consecutive weights (16- or 32-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// 8 consecutive values (16- or 32-byte aligned) of a shared-memory array
__device__ __forceinline__ void load8s(const float* p, float* w) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8s(const __nv_bfloat16* p, float* w) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// n elements (n * sizeof(T) a multiple of 16, both pointers 16-byte
// aligned) from device memory into shared memory, 16 bytes a thread
template <typename T>
__device__ __forceinline__ void copy_to_shared(T* __restrict__ dst,
                                               const T* __restrict__ src,
                                               int n) {
  const int nv = n * (int)sizeof(T) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d[i] = __ldg(s + i);
}

}  // namespace stem
