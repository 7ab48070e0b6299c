"""Row gather with a column prefix (kernel K8, ``csrc/gather.cu``) beside its
plain PyTorch twin.

Counterpart of :func:`tetranerf_tpu.ops.pallas_gather.pallas_gather_rows`
(``table[indices]``), widened to a column prefix. On the bucketed path it
cuts each quantile bucket's rays and interval prefix out of a march
(:func:`~.fused.slice_march`).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda


def row_gather_twin(table, idx, width: Optional[int] = None):
    """``table[idx, :width]`` for ``table [N, W]``, ``idx i32[M]`` in
    ``[0, N)`` -> ``[M, width]`` (``width=None`` takes every column)."""
    width = table.shape[1] if width is None else width
    return table[idx.long(), :width]


def _row_gather_cuda(table, idx, width: int):
    if not (table.is_cuda and idx.is_cuda and table.device == idx.device):
        raise ValueError("row_gather: table and idx must be on one CUDA device")
    if (
        table.dim() != 2 or table.element_size() not in (1, 4)
        or (table.shape[1] > 1 and table.stride(1) != 1)
        or idx.dtype != torch.int32 or idx.dim() != 1
        or not idx.is_contiguous() or not 0 <= width <= table.shape[1]
    ):
        raise ValueError("row_gather: unexpected shapes, strides or dtypes")
    out = torch.empty((idx.shape[0], width), dtype=table.dtype, device=table.device)
    if out.numel():
        size = table.element_size()
        cuda.launch(
            "row_gather", "tetranerf_row_gather", table.device,
            *map(cuda.ptr, (table, idx, out)),
            idx.shape[0], table.stride(0) * size, width * size,
        )
    return out


def row_gather(table, idx, width: Optional[int] = None):
    """K8 on CUDA tensors, :func:`row_gather_twin` on CPU tensors.

    ``table [N, W]`` of a 4-byte or 1-byte dtype whose columns are
    contiguous (rows may have any stride), ``idx i32[M]``, and a copy
    width ``width <= W``; returns a contiguous ``[M, width]``."""
    width = table.shape[1] if width is None else width
    if table.is_cuda:
        return _row_gather_cuda(table, idx, width)
    if table.device.type == "cpu":
        return row_gather_twin(table, idx, width)
    raise ValueError(f"row_gather: unsupported device {table.device}")
