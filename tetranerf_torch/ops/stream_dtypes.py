"""The field stream's row types (``field_stream_dtype``): which names the
port takes, the rounding of f32 values to each, and the widening back.

Counterpart of the ``stream_dtype`` argument of
:func:`tetranerf_tpu.ops.fused.endpoint_features` and of ``jnp.astype``
to that type. A row type is a :class:`StreamType`: JAX's name, the torch
dtype its rows are stored in, its code and launch-counter suffix in the
stream kernels (K2, K2b and K7 have an instance for each), and its format.
The blend itself, and the field gradient's sum, stay f32 in every
instance.

Torch names five of the types (float32, bfloat16, float16, float8_e4m3fn,
float8_e5m2): their rows are tensors of that dtype. The seven other 8- and
4-bit floats of ``ml_dtypes`` that JAX runs (``float8_e4m3fnuz``,
``float8_e5m2fnuz``, ``float8_e4m3b11fnuz``, ``float8_e3m4``,
``float8_e4m3``, ``float8_e8m0fnu``, ``float4_e2m1fn``) are stored as
``uint8`` codes, one a byte as ml_dtypes stores them, rounded and widened
here in integer torch ops (:func:`round_to`, :func:`widen`) and in the
kernels in software (``csrc/common.cuh`` ``MiniRow``).

Names are read as JAX reads them (``jnp.dtype(name)``, then ``astype``
with 64-bit types off), with the same exception types for the names it
refuses: ``"float64"`` (and ``"double"``, ``"float"``, ``"f8"``) is the
f32 stream, as JAX computes it with x64 off; integer and bool types raise
``ValueError``; complex types ``NotImplementedError``; unknown names,
``float128``, ``float6_*`` and non-numeric types ``TypeError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch


class StreamType(NamedTuple):
    """A row type of the field stream: its names and its format."""

    name: str
    """JAX's (``ml_dtypes``') name."""
    storage: torch.dtype
    """The dtype of the stored rows: the type itself where torch has it,
    else ``uint8``, one code a byte."""
    code: int
    """The row-type argument of the stream kernels' C entry points
    (``csrc/common.cuh`` ``RowType``)."""
    suffix: str
    """The launch counter of the type's instance: the f32 instance's name
    with this suffix."""
    cuda_type: str
    """The type's name in the template arguments of its kernel instances
    (as a profiler shows them)."""
    exponent_bits: int
    significand_bits: int
    """Stored significand bits: a rounding moves a value by at most
    2^-(bits+1) of it."""
    bias: int
    sign_bit: int
    """The sign bit of a code; 0 for a type without sign."""
    max_code: int
    """The code of the largest finite value."""
    inf_code: Optional[int]
    """The code of +infinity; None for a type without infinities."""
    nan_code: int
    """The code a NaN rounds to (with the sign bit where ``nan_signed``)."""
    nan_signed: bool
    zero: str
    """-0: ``"signed"`` (its own code), ``"unsigned"`` (the code of +0) or,
    for a type without zero, ``"nan"`` (0 rounds to NaN)."""
    overflow: str
    """What a magnitude past the largest value and an infinity round to:
    ``"inf"``, ``"nan"`` (``nan_code``, signed or not as a NaN) or
    ``"saturate"`` (the largest value with its sign)."""
    ties: str
    """``"even"``: to nearest, ties to even; ``"up"``: to nearest, ties
    up in magnitude."""

    @property
    def subnormal_exponent(self) -> int:
        """The exponent of the smallest positive value: near zero a rounding
        moves a value by at most half of it."""
        if self.significand_bits == 0:  # no subnormals: the smallest power of two
            return -self.bias
        return 1 - self.bias - self.significand_bits

    @property
    def zero_mask(self) -> Optional[int]:
        """The codes that encode +0 or -0: those with ``code & zero_mask``
        0 (K7 adds none of them, tested before they are widened:
        ``csrc/common.cuh`` ``ZeroCode``, the same table); None for a type
        without zero (float8_e8m0fnu, whose code 0 is 2^-127). The mask
        leaves out the sign bit where -0 has its own code, and is every bit
        of the fnuz types' codes, whose 0x80 is their NaN; float4_e2m1fn's
        bits above its 4 are not read, as :func:`widen` reads none."""
        if self.zero == "nan":
            return None
        if self.zero == "unsigned":
            return (1 << (8 * self.storage.itemsize)) - 1
        return self.sign_bit - 1

    @property
    def minifloat(self) -> bool:
        """Whether the rows are codes in ``uint8`` (rounded and widened in
        software)."""
        return self.storage == torch.uint8

    @property
    def dense_nan(self) -> bool:
        """Whether K2 gives this type JAX's NaNs (``interp.dense_nan``; the
        kernel's ``kDenseNan``): a software type with a NaN or an infinity
        among its codes (all but float4_e2m1fn, which saturates)."""
        return self.minifloat and self.overflow != "saturate"


def _t(name, storage, code, suffix, cuda_type, e, m, bias, sign, max_code, inf, nan,
       nan_signed=True, zero="signed", overflow="inf", ties="even"):
    return StreamType(name, storage, code, suffix, cuda_type, e, m, bias, sign, max_code,
                      inf, nan, nan_signed, zero, overflow, ties)


_U8 = torch.uint8
STREAM_TYPES = {t.name: t for t in (
    _t("float32", torch.float32, 0, "", "float", 8, 23, 127, 1 << 31, 0x7F7FFFFF,
       0x7F800000, 0x7FC00000),
    _t("bfloat16", torch.bfloat16, 1, "_bf16", "__nv_bfloat16", 8, 7, 127, 0x8000, 0x7F7F,
       0x7F80, 0x7FC0),
    _t("float16", torch.float16, 2, "_f16", "__half", 5, 10, 15, 0x8000, 0x7BFF, 0x7C00,
       0x7E00),
    _t("float8_e4m3fn", torch.float8_e4m3fn, 3, "_e4m3fn", "__nv_fp8_e4m3", 4, 3, 7, 0x80,
       0x7E, None, 0x7F, overflow="nan"),
    _t("float8_e5m2", torch.float8_e5m2, 4, "_e5m2", "__nv_fp8_e5m2", 5, 2, 15, 0x80, 0x7B,
       0x7C, 0x7E),
    # fnuz: no infinity, no -0; 0x80 is the one NaN.
    _t("float8_e4m3fnuz", _U8, 5, "_e4m3fnuz", "row_e4m3fnuz", 4, 3, 8, 0x80, 0x7F, None,
       0x80, nan_signed=False, zero="unsigned", overflow="nan"),
    _t("float8_e5m2fnuz", _U8, 6, "_e5m2fnuz", "row_e5m2fnuz", 5, 2, 16, 0x80, 0x7F, None,
       0x80, nan_signed=False, zero="unsigned", overflow="nan"),
    _t("float8_e4m3b11fnuz", _U8, 7, "_e4m3b11fnuz", "row_e4m3b11fnuz", 4, 3, 11, 0x80,
       0x7F, None, 0x80, nan_signed=False, zero="unsigned", overflow="nan"),
    # IEEE-style: the top exponent holds the infinities and NaNs.
    _t("float8_e3m4", _U8, 8, "_e3m4", "row_e3m4", 3, 4, 3, 0x80, 0x6F, 0x70, 0x78),
    _t("float8_e4m3", _U8, 9, "_e4m3", "row_e4m3", 4, 3, 7, 0x80, 0x77, 0x78, 0x7C),
    # Powers of two 2^-127 .. 2^127, no sign, no zero; 0xFF is NaN.
    _t("float8_e8m0fnu", _U8, 10, "_e8m0fnu", "row_e8m0fnu", 8, 0, 127, 0, 0xFE, None, 0xFF,
       nan_signed=False, zero="nan", overflow="nan", ties="up"),
    # No infinity and no NaN: overflow saturates, NaN rounds to -0 (0x8).
    _t("float4_e2m1fn", _U8, 11, "_e2m1fn", "row_e2m1fn", 2, 1, 1, 0x8, 0x7, None, 0x8,
       nan_signed=False, overflow="saturate"),
)}
"""Every row type of the stream kernels by JAX's name (float32 is the f32
stream's)."""

F32 = STREAM_TYPES["float32"]
_BY_STORAGE = {t.storage: t for t in STREAM_TYPES.values() if not t.minifloat}

RowTypeLike = Union[None, str, torch.dtype, StreamType]


def row_type(t: RowTypeLike) -> Optional[StreamType]:
    """The :class:`StreamType` that ``t`` names: a StreamType, a JAX name
    of :data:`STREAM_TYPES`, or one of the five torch dtypes torch names
    (f32, bf16, f16, float8_e4m3fn, float8_e5m2). None stays None."""
    if t is None or isinstance(t, StreamType):
        return t
    if isinstance(t, str):
        return STREAM_TYPES[t]
    if t in _BY_STORAGE:
        return _BY_STORAGE[t]
    raise ValueError(f"not a stream row type: {t}")


def rows_type(rows: torch.Tensor, t: RowTypeLike = None) -> StreamType:
    """The row type of a tensor of stream rows: ``t`` where given, else its
    dtype's (``uint8`` codes must name theirs)."""
    if t is not None:
        t = row_type(t)
        if rows.dtype != t.storage:
            raise ValueError(f"rows of {rows.dtype} are not {t.name} rows")
        return t
    if rows.dtype not in _BY_STORAGE:
        raise ValueError(f"rows of {rows.dtype}: name their stream row type")
    return _BY_STORAGE[rows.dtype]


def one_rounding_bound(ref: torch.Tensor, t: RowTypeLike,
                       sum_atol: float = 0.0) -> torch.Tensor:
    """How far a value rounded once to ``t`` may lie from the f32 sum
    ``ref`` when the rounded value is a sum of the same terms in another
    order: half a step of the type (2^-(m+1) of ``|ref|`` for m significand
    bits, and half the smallest step near zero) plus ``sum_atol``, the
    room given to the order of the f32 sums. Inside the type's range."""
    row = row_type(t)
    return (2.0 ** -(row.significand_bits + 1) * ref.abs()
            + 2.0 ** (row.subnormal_exponent - 1) + sum_atol)


# Names that ``ml_dtypes`` registers with JAX that JAX cannot cast to, and
# its integers.
_ML_UNCASTABLE = ("float6_e2m3fn", "float6_e3m2fn")
_ML_INTS = ("int2", "int4", "uint2", "uint4")


def stream_dtype(name) -> Optional[StreamType]:
    """The stream's row type for ``field_stream_dtype`` ``name``: None for
    the f32 stream (``None``, ``"float32"``, ``"float64"`` and their numpy
    aliases), else the :class:`StreamType` of bf16, f16 or an 8- or 4-bit
    float. Raises what JAX's ``endpoint_features`` raises for a name it
    refuses."""
    if name is None:
        return None
    if name in STREAM_TYPES and name != "float32":
        return STREAM_TYPES[name]
    if name in _ML_UNCASTABLE:
        raise TypeError(f"JAX only supports number, bool, and string dtypes, got dtype "
                        f"{name} in astype")
    if name in _ML_INTS:
        raise ValueError(f"field_stream_dtype={name!r}: not a floating-point type")
    dtype = np.dtype(name)  # TypeError for a name numpy does not know, as in JAX
    if dtype.kind == "f" and dtype.isnative and dtype.itemsize in (2, 4, 8):
        return STREAM_TYPES["float16"] if dtype.itemsize == 2 else None
    if dtype.kind in "iub":
        raise ValueError(f"field_stream_dtype={name!r}: not a floating-point type")
    if dtype.kind == "c":
        raise NotImplementedError(str(dtype))
    raise TypeError(f"JAX only supports number, bool, and string dtypes, got dtype "
                    f"{dtype} in astype")


# The f32 magnitudes past which a rounding to float8_e4m3fn gives NaN (it
# has no infinity; 464 is the midpoint between its largest value, 448, and
# the next step, and ties to even round it down), and from which one to
# float8_e5m2 gives infinity (61440, the midpoint above 57344, ties up).
_E4M3FN_LIMIT = 464.0
_E5M2_LIMIT = 61440.0


def round_to(x: torch.Tensor, t: RowTypeLike) -> torch.Tensor:
    """``x`` (f32) rounded to the row type ``t`` as ``jnp.astype``
    (``ml_dtypes``) rounds it, bit for bit, in ``t``'s storage dtype: to
    nearest with the type's ties (to even; float8_e8m0fnu's up), subnormals
    kept, and the type's rules for overflow, infinity, NaN and -0
    (:class:`StreamType`). Torch's own casts agree for bf16, f16 and the two
    fp8 types inside their range; they saturate float8_e4m3fn at 448, and
    write the NaNs of float8_e5m2 (and, on the card, of float16, without
    their sign) with other bits: those codes are set here. The seven types
    torch lacks round in integer ops on the f32 bits. None, float32 or
    ``x``'s dtype: ``x``. Plain elementwise torch ops, on any device."""
    t = row_type(t)
    if t is None or t.storage == x.dtype:
        return x
    if t.minifloat:
        return _round_minifloat(x, t)
    dtype = t.storage
    y = x.to(dtype)
    if dtype not in (torch.float16, torch.float8_e4m3fn, torch.float8_e5m2):
        return y
    wide = dtype == torch.float16
    code_type = torch.int16 if wide else torch.uint8
    bits = y.view(code_type).int()
    # The sign bit as a value of the code type: -32768 | c is an int16 code.
    sign = torch.signbit(x).int() * (-32768 if wide else 0x80)
    if dtype == torch.float8_e4m3fn:
        bits = torch.where(x.abs() <= _E4M3FN_LIMIT, bits, sign | 0x7F)  # also NaN, inf
    else:
        if dtype == torch.float8_e5m2:
            bits = torch.where(x.abs() >= _E5M2_LIMIT, sign | 0x7C, bits)
        bits = torch.where(x.isnan(), sign | (0x7E00 if wide else 0x7E), bits)
    return bits.to(code_type).view(dtype)


def _round_minifloat(x: torch.Tensor, t: StreamType) -> torch.Tensor:
    """:func:`round_to` for a type stored as ``uint8`` codes."""
    bits = x.float().contiguous().view(torch.int32).long()
    neg = bits < 0
    a = bits & 0x7FFFFFFF  # the magnitude's bits
    nan = a > 0x7F800000
    exp = a >> 23
    if t.ties == "up":
        # Powers of two: the f32 exponent, rounded up from half the step (a
        # subnormal f32 from just above it: ml_dtypes' rule).
        mag = (a + torch.where(exp > 0, 1 << 22, (1 << 22) - 1)) >> 23
    else:
        m = t.significand_bits
        shift = 23 - m
        # At the type's normal exponents: round the f32 bits to m
        # significand bits (to nearest, ties to even), then re-bias.
        normal = (a + (1 << (shift - 1)) - 1 + ((a >> shift) & 1)) >> shift
        normal = normal - ((127 - t.bias) << m)
        # Below them: the significand (with its implicit bit) shifted to
        # the type's smallest step, rounded the same way.
        sig = (a & 0x7FFFFF) | torch.where(exp > 0, 1 << 23, 0)
        sh = (151 - t.bias - m - exp.clamp_min(1)).clamp(shift + 1, 40)
        q = sig >> sh
        rem = sig - (q << sh)
        half = torch.ones_like(sh) << (sh - 1)
        q = q + ((rem > half) | ((rem == half) & ((q & 1) == 1))).long()
        mag = torch.where(exp >= 128 - t.bias, normal, q)
    sign = torch.where(neg, t.sign_bit, 0)
    code = sign | mag
    if t.zero == "unsigned":
        code = torch.where(mag == 0, 0, code)
    over = (mag > t.max_code) | (a == 0x7F800000)
    if t.overflow == "inf":
        code = torch.where(over, sign | t.inf_code, code)
    elif t.overflow == "saturate":
        code = torch.where(over, sign | t.max_code, code)
    else:
        nan = nan | over
    if t.zero == "nan":
        nan = nan | (a == 0)
    if t.sign_bit == 0:
        nan = nan | neg
    nan_code = (sign | t.nan_code) if t.nan_signed else torch.full_like(code, t.nan_code)
    code = torch.where(nan, nan_code, code)
    return code.to(torch.uint8)


def widen(rows: torch.Tensor, t: RowTypeLike = None) -> torch.Tensor:
    """Rows of the row type ``t`` (``rows``' dtype's where None) as f32,
    exactly: every value of every row type is an f32 value, NaN and the
    infinities included (``jnp.astype(float32)``). Plain elementwise torch
    ops, on any device; f64 rows stay f64."""
    if t is None and rows.is_floating_point():
        return rows if rows.dtype in (torch.float32, torch.float64) else rows.float()
    t = rows_type(rows, t)
    if not t.minifloat:
        return rows.float()
    c = rows.long()
    if t.ties == "up":  # 2^(c - 127); 2^-127 is an f32 subnormal
        bits = torch.where(c == 0, 1 << 22, c << 23)
        out = bits.to(torch.int32).view(torch.float32)
        return torch.where(c == t.nan_code, float("nan"), out)
    m, e = t.significand_bits, t.exponent_bits
    exp = (c >> m) & ((1 << e) - 1)
    sig = c & ((1 << m) - 1)
    normal = (((exp - t.bias + 127) << 23) | (sig << (23 - m))).to(torch.int32)
    out = torch.where(exp == 0, sig.float() * 2.0 ** (1 - t.bias - m),
                      normal.view(torch.float32))
    out = torch.where((c & t.sign_bit) != 0, -out, out)
    if t.inf_code is not None:  # the top exponent: infinity or NaN
        top = exp == (1 << e) - 1
        out = torch.where(top, torch.where(sig == 0, out.sign() * float("inf"), float("nan")),
                          out)
    elif t.zero == "unsigned":  # fnuz: the code of -0 is the NaN
        out = torch.where(c == t.nan_code, float("nan"), out)
    return out


def nonfinite(rows: torch.Tensor, t: RowTypeLike = None) -> torch.Tensor:
    """Where rows of the row type ``t`` (``rows``' dtype's where None) hold
    a NaN or an infinity: ``~widen(rows, t).isfinite()``, from the codes'
    bits alone for the seven software types (K2's ``MiniRow::nonfinite``).
    Plain elementwise torch ops, on any device."""
    t = rows_type(rows, t)
    if not t.minifloat:
        return ~rows.float().isfinite()
    if t.overflow == "saturate":  # float4_e2m1fn: no NaN, no infinity
        return torch.zeros_like(rows, dtype=torch.bool)
    if t.inf_code is not None:  # the top exponent, either sign
        return (rows & (t.sign_bit - 1)) >= t.inf_code
    return rows == t.nan_code  # the one NaN code (fnuz, float8_e8m0fnu)


BOUNDARY_VALUES = (447.0, 448.0, 463.99, 464.0, 464.01, 480.0, 57344.0, 61440.0, 65504.0,
                   65520.0, 1e5, float("inf"), 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
                   2.0 ** -24)
"""f32 values at the edges of the f16 and fp8 roundings: past 464
float8_e4m3fn is NaN (torch's own cast saturates at 448), 61440 ties up to
float8_e5m2's infinity, 65520 to f16's; 2^-10 ties down to float8_e4m3fn's
zero, 3 * 2^-11 up to 2^-9."""

MINIFLOAT_BOUNDARY_VALUES = (
    0.0, 2.0 ** -149, 2.0 ** -128, 2.0 ** -127, 1.5 * 2.0 ** -127, 2.0 ** -126,
    2.0 ** -18, 2.0 ** -17, 2.0 ** -14, 2.0 ** -11, 3 * 2.0 ** -11, 2.0 ** -10, 2.0 ** -7,
    2.0 ** -6, 0.25, 0.75, 1.5, 2.5, 3.0, 5.0, 6.0, 7.0, 15.5, 15.75, 16.0, 30.0, 31.0,
    31.5, 240.0, 247.99, 248.0, 57344.0, 61440.0, 1.5 * 2.0 ** 127, 3.4e38,
    float("inf"))
"""f32 values at the edges of the seven software roundings: each type's
smallest step and the ties below it, ties between steps (to even, and
float8_e8m0fnu's up), each largest value and the ties past it (15.5 and
15.75 of float8_e3m4, 30 and 31 of float8_e4m3b11fnuz, 240 and 248 of
float8_e4m3 and float8_e4m3fnuz, 57344 and 61440 of float8_e5m2fnuz, 6 and
7 of float4_e2m1fn, 2^127 and 1.5 * 2^127 of float8_e8m0fnu), and
infinity."""


def _signed(codes, sign, nan):
    """The codes of ``(values, -values, NaN, -NaN)`` from those of the
    values, for a type whose negative codes are the positive ones with the
    sign bit and whose NaN keeps its sign."""
    return tuple(codes) + tuple(c | sign for c in codes) + (nan, nan | sign)


BOUNDARY_CODES = {
    "float16": _signed((0x5EFC, 0x5F00, 0x5F40, 0x5F40, 0x5F40, 0x5F80, 0x7B00, 0x7B80,
                        0x7BFF, 0x7C00, 0x7C00, 0x7C00, 0x1800, 0x1400, 0x1600, 0x0001),
                       0x8000, 0x7E00),
    "float8_e4m3fn": _signed((0x7E, 0x7E, 0x7E, 0x7E, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F,
                              0x7F, 0x7F, 0x01, 0x00, 0x01, 0x00), 0x80, 0x7F),
    "float8_e5m2": _signed((0x5F, 0x5F, 0x5F, 0x5F, 0x5F, 0x60, 0x7B, 0x7C, 0x7C, 0x7C,
                            0x7C, 0x7C, 0x18, 0x14, 0x16, 0x00), 0x80, 0x7E),
    "float8_e4m3fnuz": (
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x02, 0x01, 0x08, 0x10, 0x30,
        0x3C, 0x44, 0x4A, 0x4C, 0x52, 0x54, 0x56, 0x60, 0x60, 0x60, 0x67, 0x68, 0x68, 0x7F, 0x7F,
        0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
        0x00, 0x82, 0x81, 0x88, 0x90, 0xB0, 0xBC, 0xC4, 0xCA, 0xCC, 0xD2, 0xD4, 0xD6, 0xE0, 0xE0,
        0xE0, 0xE7, 0xE8, 0xE8, 0xFF, 0xFF, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80,
    ),
    "float8_e5m2fnuz": (
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x08, 0x14, 0x1A, 0x18, 0x24, 0x28, 0x38,
        0x3E, 0x42, 0x45, 0x46, 0x49, 0x4A, 0x4B, 0x50, 0x50, 0x50, 0x54, 0x54, 0x54, 0x60, 0x60,
        0x60, 0x7F, 0x80, 0x80, 0x80, 0x80, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x81, 0x88,
        0x94, 0x9A, 0x98, 0xA4, 0xA8, 0xB8, 0xBE, 0xC2, 0xC5, 0xC6, 0xC9, 0xCA, 0xCB, 0xD0, 0xD0,
        0xD0, 0xD4, 0xD4, 0xD4, 0xE0, 0xE0, 0xE0, 0xFF, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80,
    ),
    "float8_e4m3b11fnuz": (
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x04, 0x0C, 0x08, 0x20, 0x28, 0x48,
        0x54, 0x5C, 0x62, 0x64, 0x6A, 0x6C, 0x6E, 0x78, 0x78, 0x78, 0x7F, 0x80, 0x80, 0x80, 0x80,
        0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
        0x84, 0x8C, 0x88, 0xA0, 0xA8, 0xC8, 0xD4, 0xDC, 0xE2, 0xE4, 0xEA, 0xEC, 0xEE, 0xF8, 0xF8,
        0xF8, 0xFF, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80,
    ),
    "float8_e3m4": (
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x10,
        0x28, 0x38, 0x44, 0x48, 0x54, 0x58, 0x5C, 0x6F, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x70,
        0x70, 0x70, 0x70, 0x70, 0x70, 0x70, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80,
        0x80, 0x80, 0x80, 0x80, 0x81, 0x90, 0xA8, 0xB8, 0xC4, 0xC8, 0xD4, 0xD8, 0xDC, 0xEF, 0xF0,
        0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0x78, 0xF8,
    ),
    "float8_e4m3": (
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x00, 0x04, 0x08, 0x28,
        0x34, 0x3C, 0x42, 0x44, 0x4A, 0x4C, 0x4E, 0x58, 0x58, 0x58, 0x5F, 0x60, 0x60, 0x77, 0x77,
        0x78, 0x78, 0x78, 0x78, 0x78, 0x78, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80, 0x80,
        0x80, 0x81, 0x80, 0x84, 0x88, 0xA8, 0xB4, 0xBC, 0xC2, 0xC4, 0xCA, 0xCC, 0xCE, 0xD8, 0xD8,
        0xD8, 0xDF, 0xE0, 0xE0, 0xF7, 0xF7, 0xF8, 0xF8, 0xF8, 0xF8, 0xF8, 0xF8, 0x7C, 0xFC,
    ),
    "float8_e8m0fnu": (
        0xFF, 0x00, 0x00, 0x00, 0x01, 0x01, 0x6D, 0x6E, 0x71, 0x74, 0x76, 0x75, 0x78, 0x79, 0x7D,
        0x7F, 0x80, 0x80, 0x81, 0x81, 0x82, 0x82, 0x83, 0x83, 0x83, 0x84, 0x84, 0x84, 0x87, 0x87,
        0x87, 0x8F, 0x8F, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
        0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
        0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
    ),
    "float4_e2m1fn": (
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
        0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x07, 0x07, 0x07, 0x07, 0x07, 0x07, 0x07, 0x07, 0x07,
        0x07, 0x07, 0x07, 0x07, 0x07, 0x07, 0x08, 0x08, 0x08, 0x08, 0x08, 0x08, 0x08, 0x08, 0x08,
        0x08, 0x08, 0x08, 0x08, 0x08, 0x08, 0x0A, 0x0B, 0x0C, 0x0D, 0x0E, 0x0F, 0x0F, 0x0F, 0x0F,
        0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x0F, 0x08, 0x08,
    ),
}
"""The codes ``jnp.astype`` (``ml_dtypes``) gives ``boundary_values(name)``
(:func:`boundary_values`: the type's boundary values, their negatives, NaN
and -NaN), by JAX's name. The f16 and fp8 codes are their magnitudes' with
the sign bit for a negative value, ml_dtypes' NaN with its sign; the seven
software roundings' follow their own rules (:class:`StreamType`)."""


def boundary_values(name: str) -> Tuple[float, ...]:
    """The f32 values :data:`BOUNDARY_CODES` gives codes for: the type's
    boundary values (:data:`MINIFLOAT_BOUNDARY_VALUES` for the seven
    software roundings, :data:`BOUNDARY_VALUES` for the others), their
    negatives, NaN and -NaN."""
    values = (MINIFLOAT_BOUNDARY_VALUES if STREAM_TYPES[name].minifloat
              else BOUNDARY_VALUES)
    return values + tuple(-v for v in values) + (float("nan"), -float("nan"))
