"""The field stream's row types (``field_stream_dtype``): which names the
port takes, and the rounding of f32 values to each.

Counterpart of the ``stream_dtype`` argument of
:func:`tetranerf_tpu.ops.fused.endpoint_features` and of ``jnp.astype``
to that type. The stream kernels (K2, K2b and K7) have an instance for
each row type of :data:`KERNEL_CODES`; the blend itself, and the field
gradient's sum, stay f32 in every instance.

Names are read as JAX reads them (``jnp.dtype(name)``, then ``astype``
with 64-bit types off), with the same exception types for the names it
refuses: ``"float64"`` (and ``"double"``, ``"float"``, ``"f8"``) is the
f32 stream, as JAX computes it with x64 off; integer and bool types raise
``ValueError``; complex types ``NotImplementedError``; unknown names,
``float128`` and non-numeric types ``TypeError``. JAX also runs the other
8- and 4-bit types of ``ml_dtypes`` (``float8_e4m3fnuz``, ...): the port
has no kernel instance for those and refuses them with
``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

KERNEL_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.float8_e4m3fn: 3,
    torch.float8_e5m2: 4,
}
"""The row-type argument of the stream kernels' C entry points
(``csrc/common.cuh`` ``RowType``)."""

COUNTER_SUFFIX = {
    torch.float32: "",
    torch.bfloat16: "_bf16",
    torch.float16: "_f16",
    torch.float8_e4m3fn: "_e4m3fn",
    torch.float8_e5m2: "_e5m2",
}
"""The launch counter of each row type's instance: the f32 instance's name
with this suffix."""


class RowType(NamedTuple):
    """A low-precision row type's format and its name in the kernels."""

    significand_bits: int
    """Stored significand bits: a rounding moves a value by at most
    2^-(bits+1) of it."""
    subnormal_exponent: int
    """The exponent of the smallest subnormal: near zero a rounding moves a
    value by at most half of it."""
    cuda_type: str
    """The type's name in the template arguments of its kernel instances
    (as a profiler shows them)."""


ROW_TYPES = {
    torch.bfloat16: RowType(7, -133, "__nv_bfloat16"),
    torch.float16: RowType(10, -24, "__half"),
    torch.float8_e4m3fn: RowType(3, -9, "__nv_fp8_e4m3"),
    torch.float8_e5m2: RowType(2, -16, "__nv_fp8_e5m2"),
}

BOUNDARY_VALUES = (447.0, 448.0, 463.99, 464.0, 464.01, 480.0, 57344.0, 61440.0, 65504.0,
                   65520.0, 1e5, float("inf"), 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
                   2.0 ** -24)
"""f32 values at the edges of the f16 and fp8 roundings: past 464
float8_e4m3fn is NaN (torch's own cast saturates at 448), 61440 ties up to
float8_e5m2's infinity, 65520 to f16's; 2^-10 ties down to float8_e4m3fn's
zero, 3 * 2^-11 up to 2^-9."""

BOUNDARY_CODES = {
    torch.float16: ((0x5EFC, 0x5F00, 0x5F40, 0x5F40, 0x5F40, 0x5F80, 0x7B00, 0x7B80, 0x7BFF,
                     0x7C00, 0x7C00, 0x7C00, 0x1800, 0x1400, 0x1600, 0x0001), 0x8000, 0x7E00),
    torch.float8_e4m3fn: ((0x7E, 0x7E, 0x7E, 0x7E, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F,
                           0x7F, 0x01, 0x00, 0x01, 0x00), 0x80, 0x7F),
    torch.float8_e5m2: ((0x5F, 0x5F, 0x5F, 0x5F, 0x5F, 0x60, 0x7B, 0x7C, 0x7C, 0x7C, 0x7C,
                         0x7C, 0x18, 0x14, 0x16, 0x00), 0x80, 0x7E),
}
"""``(codes, sign bit, NaN code)`` of each type: the codes ``jnp.astype``
(``ml_dtypes``) gives :data:`BOUNDARY_VALUES`; a negative value's code is
its magnitude's with the sign bit, and ml_dtypes' NaN is the NaN code
(with the sign bit for -NaN)."""


def one_rounding_bound(ref: torch.Tensor, dtype: torch.dtype,
                       sum_atol: float = 0.0) -> torch.Tensor:
    """How far a value rounded once to ``dtype`` may lie from the f32 sum
    ``ref`` when the rounded value is a sum of the same terms in another
    order: half a step of the type (2^-(m+1) of ``|ref|`` for m significand
    bits, and half the smallest subnormal near zero) plus ``sum_atol``, the
    room given to the order of the f32 sums."""
    row = ROW_TYPES[dtype]
    return (2.0 ** -(row.significand_bits + 1) * ref.abs()
            + 2.0 ** (row.subnormal_exponent - 1) + sum_atol)

_ML_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
# Names that ``ml_dtypes`` registers with JAX: floats JAX runs and the port
# lacks, floats JAX cannot cast to, and integers.
_ML_UNPORTED = ("float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz", "float8_e4m3fnuz",
                "float8_e5m2fnuz", "float8_e8m0fnu", "float4_e2m1fn")
_ML_UNCASTABLE = ("float6_e2m3fn", "float6_e3m2fn")
_ML_INTS = ("int2", "int4", "uint2", "uint4")

# The f32 magnitudes past which a rounding to float8_e4m3fn gives NaN (it
# has no infinity; 464 is the midpoint between its largest value, 448, and
# the next step, and ties to even round it down), and from which one to
# float8_e5m2 gives infinity (61440, the midpoint above 57344, ties up).
_E4M3FN_LIMIT = 464.0
_E5M2_LIMIT = 61440.0


def stream_dtype(name) -> Optional[torch.dtype]:
    """The stream's row type for ``field_stream_dtype`` ``name``: None for
    the f32 stream (``None``, ``"float32"``, ``"float64"`` and their numpy
    aliases), else bf16, f16, float8_e4m3fn or float8_e5m2. Raises what
    JAX's ``endpoint_features`` raises for a name it refuses, and
    ``NotImplementedError`` for a type JAX runs that the port has no kernel
    instance for."""
    if name is None:
        return None
    if name in _ML_DTYPES:
        return _ML_DTYPES[name]
    if name in _ML_UNPORTED:
        raise NotImplementedError(
            f"not ported to tetranerf_torch: field_stream_dtype={name!r} (ROADMAP A19; "
            "the stream kernels take float32, bfloat16, float16, float8_e4m3fn and "
            "float8_e5m2)")
    if name in _ML_UNCASTABLE:
        raise TypeError(f"JAX only supports number, bool, and string dtypes, got dtype "
                        f"{name} in astype")
    if name in _ML_INTS:
        raise ValueError(f"field_stream_dtype={name!r}: not a floating-point type")
    dtype = np.dtype(name)  # TypeError for a name numpy does not know, as in JAX
    if dtype.kind == "f" and dtype.isnative and dtype.itemsize in (2, 4, 8):
        return torch.float16 if dtype.itemsize == 2 else None
    if dtype.kind in "iub":
        raise ValueError(f"field_stream_dtype={name!r}: not a floating-point type")
    if dtype.kind == "c":
        raise NotImplementedError(str(dtype))
    raise TypeError(f"JAX only supports number, bool, and string dtypes, got dtype "
                    f"{dtype} in astype")


def round_to(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` (f32) rounded to ``dtype`` as ``jnp.astype`` (``ml_dtypes``)
    rounds it, bit for bit: to nearest, ties to even, subnormals kept;
    past the largest value float16 and float8_e5m2 give infinity and
    float8_e4m3fn NaN, and a NaN keeps its sign and takes ml_dtypes'
    payload. Torch's own cast agrees inside the range; it saturates
    float8_e4m3fn at 448, and writes the NaNs of float8_e5m2 (and, on the
    card, of float16, without their sign) with other bits: those codes are
    set here. None or ``x``'s dtype: ``x``. Plain elementwise torch ops,
    on any device."""
    if dtype is None or dtype == x.dtype:
        return x
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
