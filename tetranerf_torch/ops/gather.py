"""Row gather with a column prefix (kernel K8, ``csrc/gather.cu``) beside its
plain PyTorch twin, for one table or a batch of them in one launch.

Counterpart of :func:`tetranerf_tpu.ops.pallas_gather.pallas_gather_rows`
(``table[indices]``), widened to a column prefix. On the bucketed path one
batch cuts every quantile bucket of a step out of a march
(:func:`~.fused.slice_march_buckets`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import cuda

Job = Tuple[torch.Tensor, torch.Tensor, int]
"""``(table [N, W], idx i32[M], width)``: rows ``idx`` of ``table``, cut
to their first ``width`` columns."""


def row_gather_twin(table, idx, width: Optional[int] = None):
    """``table[idx, :width]`` for ``table [N, W]``, ``idx i32[M]`` in
    ``[0, N)`` -> ``[M, width]`` (``width=None`` takes every column)."""
    width = table.shape[1] if width is None else width
    return table[idx.long(), :width]


def row_gather_batch_twin(jobs: Sequence[Job]) -> List[torch.Tensor]:
    """:func:`row_gather_twin` of each job."""
    return [row_gather_twin(table, idx, width) for table, idx, width in jobs]


def _row_gather_batch_cuda(jobs: Sequence[Job]) -> List[torch.Tensor]:
    device = jobs[0][0].device
    tables, indices = {}, {}  # id -> what the jobs need of it, checked once
    outs, flat = [], []
    for table, idx, width in jobs:
        tab = tables.get(id(table))
        if tab is None:
            if not (table.is_cuda and table.device == device):
                raise ValueError("row_gather: tables and indices must be on one CUDA device")
            if (table.dim() != 2 or table.element_size() not in (1, 4)
                    or (table.shape[1] > 1 and table.stride(1) != 1)):
                raise ValueError("row_gather: unexpected shapes, strides or dtypes")
            size = table.element_size()
            tab = tables[id(table)] = (table.data_ptr(), table.stride(0) * size, size,
                                       table.shape[1], table.dtype)
        ind = indices.get(id(idx))
        if ind is None:
            if not (idx.is_cuda and idx.device == device):
                raise ValueError("row_gather: tables and indices must be on one CUDA device")
            if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
                raise ValueError("row_gather: unexpected shapes, strides or dtypes")
            ind = indices[id(idx)] = (idx.data_ptr(), idx.shape[0])
        if not 0 <= width <= tab[3]:
            raise ValueError("row_gather: unexpected shapes, strides or dtypes")
        out = torch.empty((ind[1], width), dtype=tab[4], device=device)
        outs.append(out)
        if ind[1] and width:
            flat.append((tab[0], tab[1], out.data_ptr(), width * tab[2], ind[0], ind[1]))
    for jobs_arr, num in cuda.job_chunks(_max_jobs(), flat):
        cuda.launch("row_gather", "tetranerf_row_gather_batch", device, jobs_arr, num)
    return outs


def _max_jobs() -> int:
    """Jobs one launch takes (the kernel's parameter space holds the list)."""
    return cuda.max_jobs("tetranerf_row_gather_max_jobs")


def row_gather_batch(jobs: Sequence[Job]) -> List[torch.Tensor]:
    """K8 on CUDA tensors, :func:`row_gather_batch_twin` on CPU tensors.

    Each job is ``(table [N, W], idx i32[M], width)``: a table of a 4-byte
    or 1-byte dtype whose columns are contiguous (rows may have any
    stride), and a copy width ``width <= W``; the result is one contiguous
    ``[M, width]`` per job, in job order. On the card one launch copies
    every job (more only past the kernel's job capacity, 128 jobs)."""
    if not jobs:
        return []
    device = jobs[0][0].device
    if device.type == "cuda":
        return _row_gather_batch_cuda(jobs)
    if device.type == "cpu":
        return row_gather_batch_twin(jobs)
    raise ValueError(f"row_gather: unsupported device {device}")


def row_gather(table, idx, width: Optional[int] = None):
    """K8 on CUDA tensors, :func:`row_gather_twin` on CPU tensors: the
    one-job case of :func:`row_gather_batch`.

    ``table [N, W]`` of a 4-byte or 1-byte dtype whose columns are
    contiguous (rows may have any stride), ``idx i32[M]``, and a copy
    width ``width <= W``; returns a contiguous ``[M, width]``."""
    width = table.shape[1] if width is None else width
    return row_gather_batch([(table, idx, width)])[0]
