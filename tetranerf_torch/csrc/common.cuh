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
#include <cuda_fp16.h>
#include <cuda_fp8.h>

// The row types of the field stream (`field_stream_dtype`): the code that
// the stream kernels' C entry points take (tetranerf_torch/ops/
// stream_dtypes.py `KERNEL_CODES`).
enum RowType : int {
  kRowF32 = 0,
  kRowBF16 = 1,
  kRowF16 = 2,
  kRowE4M3 = 3,  // float8_e4m3fn
  kRowE5M2 = 4,  // float8_e5m2
};

// Bytes of one element of a row type, 0 for an unknown code.
inline int row_type_size(int code) {
  switch (code) {
    case kRowF32: return 4;
    case kRowBF16:
    case kRowF16: return 2;
    case kRowE4M3:
    case kRowE5M2: return 1;
  }
  return 0;
}

template <typename T>
struct RowTag {
  using type = T;
};

// f(RowTag<T>{}) for the row type `code` names; cudaErrorInvalidValue for
// an unknown code.
template <typename F>
int with_row_type(int code, F&& f) {
  switch (code) {
    case kRowF32: return f(RowTag<float>{});
    case kRowBF16: return f(RowTag<__nv_bfloat16>{});
    case kRowF16: return f(RowTag<__half>{});
    case kRowE4M3: return f(RowTag<__nv_fp8_e4m3>{});
    case kRowE5M2: return f(RowTag<__nv_fp8_e5m2>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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

// The 16-bit and 8-bit row types, each widened to f32 exactly (every bf16,
// f16, e4m3fn and e5m2 value is an f32 value, NaN and infinity included)
// and rounded from f32 to nearest, ties to even, subnormals kept (so no
// --use_fast_math: it would flush them). f16, e4m3fn and e5m2 round as
// ml_dtypes (jnp.astype) does: past the largest value f16 and e5m2 give
// infinity and e4m3fn NaN, and a NaN keeps its sign and takes ml_dtypes'
// payload. `Raw` holds one element, `Pair` two, `Quad` four (two pairs).
template <typename T>
struct Row;
template <>
struct Row<__nv_bfloat16> {
  using Raw = unsigned short;
  using Pair = unsigned;
  using Quad = uint2;
  __device__ static float widen(Raw r) { return __bfloat162float(__ushort_as_bfloat16(r)); }
  __device__ static float2 widen2(Pair p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p));
  }
  // To nearest, ties to even, as torch's .to(torch.bfloat16).
  __device__ static Pair round2(float2 v) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    return *reinterpret_cast<const Pair*>(&h);
  }
};
template <>
struct Row<__half> {
  using Raw = unsigned short;
  using Pair = unsigned;
  using Quad = uint2;
  __device__ static float widen(Raw r) { return __half2float(__ushort_as_half(r)); }
  __device__ static float2 widen2(Pair p) {
    return __half22float2(*reinterpret_cast<const __half2*>(&p));
  }
  __device__ static unsigned short round1(float x) {
    if (x != x) return (__float_as_uint(x) >> 31) ? 0xFE00u : 0x7E00u;
    return __half_as_ushort(__float2half_rn(x));
  }
  __device__ static Pair round2(float2 v) {
    return static_cast<Pair>(round1(v.x)) | (static_cast<Pair>(round1(v.y)) << 16);
  }
};
// The two fp8 types: the hardware's pair conversions (sm_89 and later),
// to f16 (exact) and from f32 with `satfinite`, whose saturation is then
// replaced by ml_dtypes' overflow rule. (`__nv_fp8_e4m3(float)` and
// `__nv_fp8_e5m2(float)` saturate, and so does torch's cast to e4m3fn.)
template <__nv_fp8_interpretation_t kFormat>
struct Fp8Row {
  using Raw = unsigned char;
  using Pair = unsigned short;
  using Quad = unsigned;
  __device__ static float widen(Raw r) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(r, kFormat)));
  }
  __device__ static float2 widen2(Pair p) {
    return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(p, kFormat)));
  }
  // One element's code from its satfinite code `c`.
  __device__ static unsigned overflow(float x, unsigned c) {
    const unsigned sign = (__float_as_uint(x) >> 31) << 7;
    if constexpr (kFormat == __NV_E4M3) {
      // No infinity: NaN past 464, the midpoint above 448 (464 itself ties
      // to 448), and for NaN and infinity.
      return fabsf(x) <= 464.0f ? c : (sign | 0x7Fu);
    } else {
      if (x != x) return sign | 0x7Eu;
      return fabsf(x) >= 61440.0f ? (sign | 0x7Cu) : c;  // 61440 ties up, to infinity
    }
  }
  __device__ static Pair round2(float2 v) {
    const unsigned c = __nv_cvt_float2_to_fp8x2(v, __NV_SATFINITE, kFormat);
    return static_cast<Pair>(overflow(v.x, c & 0xFFu) | (overflow(v.y, c >> 8) << 8));
  }
};
template <>
struct Row<__nv_fp8_e4m3> : Fp8Row<__NV_E4M3> {};
template <>
struct Row<__nv_fp8_e5m2> : Fp8Row<__NV_E5M2> {};

// Columns [kVec c, kVec c + kVec) of a row of `T` (any row type), read
// through the read-only path and widened to f32: a narrow row moves fewer
// bytes and widens exactly. The row address must be aligned to kVec
// elements.
template <typename T, int kVec>
struct RowLoad {
  using R = Row<T>;
  __device__ static typename F32Vec<kVec>::T load(const T* row, int c) {
    if constexpr (kVec == 4) {
      const typename R::Quad raw =
          __ldg(reinterpret_cast<const typename R::Quad*>(row) + c);
      float2 a, b;
      if constexpr (sizeof(T) == 2) {
        a = R::widen2(raw.x);
        b = R::widen2(raw.y);
      } else {
        a = R::widen2(static_cast<typename R::Pair>(raw & 0xFFFFu));
        b = R::widen2(static_cast<typename R::Pair>(raw >> 16));
      }
      return make_float4(a.x, a.y, b.x, b.y);
    } else if constexpr (kVec == 2) {
      return R::widen2(__ldg(reinterpret_cast<const typename R::Pair*>(row) + c));
    } else {
      return R::widen(__ldg(reinterpret_cast<const typename R::Raw*>(row) + c));
    }
  }
};
template <int kVec>
struct RowLoad<float, kVec> {
  using V = typename F32Vec<kVec>::T;
  __device__ static V load(const float* row, int c) {
    return __ldg(reinterpret_cast<const V*>(row) + c);
  }
};

// Two adjacent f32 values stored as f32, or rounded to a narrower row type
// (Row<T>::round2).
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float2 v) {
  *reinterpret_cast<typename Row<T>::Pair*>(p) = Row<T>::round2(v);
}
