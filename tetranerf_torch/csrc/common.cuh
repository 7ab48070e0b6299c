// Shared helpers of the tetranerf_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// Maximum that propagates NaN from either side, as jnp.maximum and
// torch.maximum do (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

#include <cuda_bf16.h>

// Vectors of 4, 2 or 1 f32 (float4, float2, float).
template <int kVec>
struct F32Vec;
template <>
struct F32Vec<4> {
  using T = float4;
};
template <>
struct F32Vec<2> {
  using T = float2;
};
template <>
struct F32Vec<1> {
  using T = float;
};

// Columns [kVec c, kVec c + kVec) of a row of `T` (float or bf16), read
// through the read-only path and widened to f32: a bf16 row moves half the
// bytes and widens exactly. The row address must be aligned to kVec
// elements.
template <typename T, int kVec>
struct RowLoad;
template <int kVec>
struct RowLoad<float, kVec> {
  using V = typename F32Vec<kVec>::T;
  __device__ static V load(const float* row, int c) {
    return __ldg(reinterpret_cast<const V*>(row) + c);
  }
};
template <>
struct RowLoad<__nv_bfloat16, 4> {
  __device__ static float4 load(const __nv_bfloat16* row, int c) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row) + c);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
template <>
struct RowLoad<__nv_bfloat16, 2> {
  __device__ static float2 load(const __nv_bfloat16* row, int c) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(row) + c);
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  }
};
template <>
struct RowLoad<__nv_bfloat16, 1> {
  __device__ static float load(const __nv_bfloat16* row, int c) {
    return __bfloat162float(__ldg(row + c));
  }
};

// Two adjacent f32 values stored as f32, or rounded to bf16 (to nearest,
// ties to even, as torch's .to(torch.bfloat16)).
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
