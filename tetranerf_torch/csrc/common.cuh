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
// stream_dtypes.py `StreamType.code`).
enum RowType : int {
  kRowF32 = 0,
  kRowBF16 = 1,
  kRowF16 = 2,
  kRowE4M3 = 3,  // float8_e4m3fn
  kRowE5M2 = 4,  // float8_e5m2
  // The 8- and 4-bit types without a CUDA type, one code a byte (ml_dtypes'
  // layout), decoded and rounded in software (MiniRow below).
  kRowE4M3FNUZ = 5,     // float8_e4m3fnuz
  kRowE5M2FNUZ = 6,     // float8_e5m2fnuz
  kRowE4M3B11FNUZ = 7,  // float8_e4m3b11fnuz
  kRowE3M4 = 8,         // float8_e3m4
  kRowE4M3IEEE = 9,     // float8_e4m3
  kRowE8M0FNU = 10,     // float8_e8m0fnu
  kRowE2M1FN = 11,      // float4_e2m1fn
};

// Bytes of one element of a row type, 0 for an unknown code.
inline int row_type_size(int code) {
  switch (code) {
    case kRowF32: return 4;
    case kRowBF16:
    case kRowF16: return 2;
  }
  return code >= kRowE4M3 && code <= kRowE2M1FN ? 1 : 0;
}

// The element types of the software row types: one code a byte. Their
// names are what a profiler shows in the kernels' template arguments
// (stream_dtypes.py `StreamType.cuda_type`).
struct row_e4m3fnuz { unsigned char code; };
struct row_e5m2fnuz { unsigned char code; };
struct row_e4m3b11fnuz { unsigned char code; };
struct row_e3m4 { unsigned char code; };
struct row_e4m3 { unsigned char code; };
struct row_e8m0fnu { unsigned char code; };
struct row_e2m1fn { unsigned char code; };

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
    case kRowE4M3FNUZ: return f(RowTag<row_e4m3fnuz>{});
    case kRowE5M2FNUZ: return f(RowTag<row_e5m2fnuz>{});
    case kRowE4M3B11FNUZ: return f(RowTag<row_e4m3b11fnuz>{});
    case kRowE3M4: return f(RowTag<row_e3m4>{});
    case kRowE4M3IEEE: return f(RowTag<row_e4m3>{});
    case kRowE8M0FNU: return f(RowTag<row_e8m0fnu>{});
    case kRowE2M1FN: return f(RowTag<row_e2m1fn>{});
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
  static constexpr bool kHasZero = true;
  static constexpr unsigned kZeroMask = 0x7FFFu;
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
  static constexpr bool kHasZero = true;
  static constexpr unsigned kZeroMask = 0x7FFFu;
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
  static constexpr bool kHasZero = true;
  static constexpr unsigned kZeroMask = 0x7Fu;
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

// The software row types: no card converts them in hardware (Hopper's
// conversions are e4m3fn's and e5m2's; e2m1 and ue8m0 come with sm_100),
// so a code is decoded by placing its bits in an f32 and one multiply by
// a power of two (exact), and an f32 value rounded in integer arithmetic
// on its bits (one float add below the type's normals), bit for bit as
// jnp.astype (XLA and ml_dtypes) rounds it (stream_dtypes.py `round_to`,
// the same steps in torch ops):
// - kFnuz (float8_e4m3fnuz, _e5m2fnuz, _e4m3b11fnuz): no infinity and no
//   -0; 0x80 is the one NaN, and overflow, infinity and NaN round to it.
// - kIeee (float8_e3m4, float8_e4m3): the top exponent holds the
//   infinities and NaNs; overflow rounds to infinity, NaN keeps its sign.
// - kSat (float4_e2m1fn, in the low 4 bits): no infinity and no NaN;
//   overflow and infinity saturate at +-6, NaN rounds to 0x8 (-0).
// - kPow2 (float8_e8m0fnu): 2^(c - 127), no sign and no zero, 0xFF NaN;
//   zero, negatives, overflow, infinity and NaN round to 0xFF; a value
//   rounds half up to a power of two (a subnormal f32 from just above
//   half, ml_dtypes' rule).
// Finite values round to nearest, ties to even (kPow2: up).
enum MiniKind { kFnuz, kIeee, kSat, kPow2 };

template <int kE, int kM, int kBias, MiniKind kKind>
struct MiniRow {
  using Raw = unsigned char;
  using Pair = unsigned short;
  using Quad = unsigned;
  static constexpr unsigned kSign = kKind == kPow2 ? 0u : 1u << (kE + kM);
  static constexpr unsigned kInf = ((1u << kE) - 1u) << kM;  // kIeee's +infinity
  static constexpr unsigned kMax = kKind == kIeee   ? kInf - 1u
                                   : kKind == kPow2 ? 0xFEu
                                                    : kSign - 1u;
  static constexpr unsigned kNan = kKind == kIeee   ? kInf | (1u << (kM - 1))
                                   : kKind == kPow2 ? 0xFFu
                                                    : kSign;  // kSat: -0
  // The zero codes (ZeroCode below): +0 and -0 but for kFnuz (0x80 is its
  // NaN) and kPow2 (no zero); kSat's bits above its 4 are not read.
  static constexpr bool kHasZero = kKind != kPow2;
  static constexpr unsigned kZeroMask = kKind == kFnuz ? 0xFFu : kSign - 1u;

  // The value of a code that is no NaN and no infinity: its exponent and
  // significand bits placed at f32's make the f32 of the same significand
  // 2^(bias - 127) times the value (a subnormal code an f32 subnormal
  // alike), so one multiply by 2^(127 - bias) gives it (exact: a power of
  // two, no overflow); then the sign bit.
  __device__ static float widen_finite(unsigned c) {
    if constexpr (kKind == kPow2) {
      return __uint_as_float(c == 0u ? 0x400000u : c << 23);  // 2^-127: an f32 subnormal
    } else {
      const float v = __uint_as_float((c & (kSign - 1u)) << (23 - kM)) *
                      __uint_as_float((254u - kBias) << 23);
      return __uint_as_float(__float_as_uint(v) | ((c & kSign) << (31 - kE - kM)));
    }
  }
  // Whether code `c` is a NaN or an infinity, from its bits alone.
  __device__ static bool nonfinite(unsigned c) {
    if constexpr (kKind == kIeee) return (c & (kSign - 1u)) >= kInf;
    if constexpr (kKind == kSat) return false;
    return c == kNan;  // kFnuz: 0x80; kPow2: 0xFF
  }
  __device__ static float widen(unsigned c) {
    if (!nonfinite(c)) return widen_finite(c);
    if constexpr (kKind == kIeee) {
      if ((c & (kSign - 1u)) == kInf) return (c & kSign) ? -CUDART_INF_F : CUDART_INF_F;
    }
    return CUDART_NAN_F;
  }
  __device__ static float2 widen2(Pair p) {
    return make_float2(widen(p & 0xFFu), widen(static_cast<unsigned>(p) >> 8));
  }
  __device__ static float2 widen2_finite(Pair p) {
    return make_float2(widen_finite(p & 0xFFu), widen_finite(static_cast<unsigned>(p) >> 8));
  }

  // The f32 bits rounded to the type's step: at the type's normal
  // exponents the bits themselves (a carry into the exponent is the next
  // binade), below them |x| plus 2^(24 - bias - M), whose step is the
  // type's smallest, so the card's round to nearest even does it; then
  // the type's rules, no branch.
  __device__ static unsigned round1(float x) {
    const unsigned bits = __float_as_uint(x);
    const unsigned a = bits & 0x7FFFFFFFu;
    if constexpr (kKind == kPow2) {
      const unsigned ex = a >> 23;
      if (a == 0u || (bits >> 31) || a >= 0x7F800000u) return kNan;
      const unsigned mag = (a + (ex ? 0x400000u : 0x3FFFFFu)) >> 23;
      return mag > kMax ? kNan : mag;
    } else {
      const unsigned sign = (bits >> 31) ? kSign : 0u;
      constexpr int kShift = 23 - kM;
      const unsigned normal =
          ((a + (1u << (kShift - 1)) - 1u + ((a >> kShift) & 1u)) >> kShift) -
          ((127u - kBias) << kM);
      const float magic = __uint_as_float((151u - kBias - kM) << 23);
      const unsigned sub = __float_as_uint(__uint_as_float(a) + magic) - __float_as_uint(magic);
      const unsigned mag = a >= ((128u - kBias) << 23) ? normal : sub;
      unsigned code = sign | mag;
      if constexpr (kKind == kFnuz) code = mag == 0u ? 0u : code;
      if (mag > kMax || a >= 0x7F800000u) {  // overflow, infinity (and NaN)
        code = kKind == kFnuz ? kNan : kKind == kIeee ? (sign | kInf) : (sign | kMax);
      }
      if (a > 0x7F800000u) code = kKind == kIeee ? (sign | kNan) : kNan;
      return code;
    }
  }
  __device__ static Pair round2(float2 v) {
    return static_cast<Pair>(round1(v.x) | (round1(v.y) << 8));
  }
};
template <>
struct Row<row_e4m3fnuz> : MiniRow<4, 3, 8, kFnuz> {};
template <>
struct Row<row_e5m2fnuz> : MiniRow<5, 2, 16, kFnuz> {};
template <>
struct Row<row_e4m3b11fnuz> : MiniRow<4, 3, 11, kFnuz> {};
template <>
struct Row<row_e3m4> : MiniRow<3, 4, 3, kIeee> {};
template <>
struct Row<row_e4m3> : MiniRow<4, 3, 7, kIeee> {};
template <>
struct Row<row_e8m0fnu> : MiniRow<8, 0, 127, kPow2> {};
template <>
struct Row<row_e2m1fn> : MiniRow<2, 1, 1, kSat> {};

// The codes of a row type that encode +0 or -0, one table a type (the same
// as stream_dtypes.py `StreamType.zero_mask`): a code is +-0 exactly where
// `code & kMask` is 0. float8_e8m0fnu has none (its code 0 is 2^-127):
// +0 rounds to its NaN, kRoundedWord in every byte of a word. kWord is the
// mask of every element of a 32-bit word of codes.
template <typename T>
constexpr unsigned zero_rounded_word() {
  if constexpr (Row<T>::kHasZero) {
    return 0u;
  } else {
    return Row<T>::kNan * 0x01010101u;  // a one-byte type
  }
}
template <typename T>
struct ZeroCode {
  static constexpr bool kHas = Row<T>::kHasZero;
  static constexpr unsigned kMask = Row<T>::kZeroMask;
  static constexpr unsigned kWord = sizeof(T) == 1 ? kMask * 0x01010101u : kMask * 0x00010001u;
  static constexpr unsigned kRoundedWord = zero_rounded_word<T>();
};
template <>
struct ZeroCode<float> {
  static constexpr bool kHas = true;
  static constexpr unsigned kMask = 0x7FFFFFFFu;
  static constexpr unsigned kWord = kMask;
  static constexpr unsigned kRoundedWord = 0u;
};
// ZeroCode's mask of the row type `code` names on the host, -1 where the
// type has no zero, -2 for an unknown code.
inline int row_type_zero_mask(int code) {
  if (row_type_size(code) == 0) return -2;
  return with_row_type(code, [](auto tag) {
    using Z = ZeroCode<typename decltype(tag)::type>;
    return Z::kHas ? static_cast<int>(Z::kMask) : -1;
  });
}

// Whether K2 gives a row type JAX's NaNs (ops/interp.py `dense_nan`): the
// software types with a NaN or an infinity among their codes.
template <typename T>
constexpr bool kDenseNan = false;
template <>
constexpr bool kDenseNan<row_e4m3fnuz> = true;
template <>
constexpr bool kDenseNan<row_e5m2fnuz> = true;
template <>
constexpr bool kDenseNan<row_e4m3b11fnuz> = true;
template <>
constexpr bool kDenseNan<row_e3m4> = true;
template <>
constexpr bool kDenseNan<row_e4m3> = true;
template <>
constexpr bool kDenseNan<row_e8m0fnu> = true;
// kDenseNan of the row type `code` names, on the host.
inline bool row_type_dense_nan(int code) {
  return code >= kRowE4M3FNUZ && code <= kRowE8M0FNU;
}

// Columns [kVec c, kVec c + kVec) of a row of `T` (any row type), read
// through the read-only path and widened to f32: a narrow row moves fewer
// bytes and widens exactly. The row address must be aligned to kVec
// elements. kFinite (a software type's rows known to hold no NaN or
// infinity code) widens without those codes' fixups.
template <typename T, int kVec, bool kFinite = false>
struct RowLoad {
  using R = Row<T>;
  __device__ static float2 widen2(typename R::Pair p) {
    if constexpr (kFinite) {
      return R::widen2_finite(p);
    } else {
      return R::widen2(p);
    }
  }
  __device__ static typename F32Vec<kVec>::T load(const T* row, int c) {
    if constexpr (kVec == 4) {
      const typename R::Quad raw =
          __ldg(reinterpret_cast<const typename R::Quad*>(row) + c);
      float2 a, b;
      if constexpr (sizeof(T) == 2) {
        a = widen2(raw.x);
        b = widen2(raw.y);
      } else {
        a = widen2(static_cast<typename R::Pair>(raw & 0xFFFFu));
        b = widen2(static_cast<typename R::Pair>(raw >> 16));
      }
      return make_float4(a.x, a.y, b.x, b.y);
    } else if constexpr (kVec == 2) {
      return widen2(__ldg(reinterpret_cast<const typename R::Pair*>(row) + c));
    } else {
      return R::widen(__ldg(reinterpret_cast<const typename R::Raw*>(row) + c));
    }
  }
};
template <int kVec, bool kFinite>
struct RowLoad<float, kVec, kFinite> {
  using V = typename F32Vec<kVec>::T;
  __device__ static V load(const float* row, int c) {
    return __ldg(reinterpret_cast<const V*>(row) + c);
  }
};
