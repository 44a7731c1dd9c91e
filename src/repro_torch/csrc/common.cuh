// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is compiled by nvcc into its own shared library with a plain
// C interface (see kernels/build.py) and launched through ctypes from
// kernels/ops.py.  Each exported launch function enqueues its kernel on the
// stream it is given, never synchronises, and returns cudaGetLastError() so
// the wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// payload dtype codes shared with kernels/ops.py (scatter_blocks_hkv)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Load 16 bytes (8 bf16 values) and widen them to float.
template <typename T>
__device__ __forceinline__ void load16_f32(const T* src, float* dst);

template <>
__device__ __forceinline__ void load16_f32<__nv_bfloat16>(
    const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
