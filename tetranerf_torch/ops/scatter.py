"""Row scatter-add (kernel K7, ``csrc/scatter.cu``) beside its plain PyTorch
twin, and the row gather whose backward it is.

Counterpart of :mod:`tetranerf_tpu.ops.pallas_scatter`. On the train path
K7 is the second half of the stream blend's backward
(:class:`~.interp.StreamBlendGather`): it scatters the per-ray stream-row
gradient into the ``[V, F]`` field gradient.
"""

from __future__ import annotations

import torch

from . import cuda


def scatter_add_rows_twin(indices, values, num_rows: int):
    """``zeros[num_rows, F]`` with ``values[i]`` added into row
    ``indices[i]``; rows whose index is ``< 0`` or ``>= num_rows`` are
    dropped. ``indices i32[N]``, ``values f32[N, F]``."""
    keep = (indices >= 0) & (indices < num_rows)
    vals = values[keep]
    idx = indices[keep].long()[:, None].expand(-1, values.shape[1])
    out = values.new_zeros((num_rows, values.shape[1]))
    return out.scatter_add_(0, idx, vals)


def _scatter_add_rows_cuda(indices, values, num_rows: int):
    cuda.check_cuda_inputs("scatter_add_rows", indices=indices, values=values)
    if (
        indices.dtype != torch.int32 or values.dtype != torch.float32
        or indices.dim() != 1 or values.dim() != 2
        or values.shape[0] != indices.shape[0]
    ):
        raise ValueError("scatter_add_rows: unexpected shapes or dtypes")
    out = torch.empty(
        (num_rows, values.shape[1]), dtype=torch.float32, device=values.device
    )
    if out.numel():
        cuda.launch(
            "scatter_add_rows", "tetranerf_scatter_add_rows", values.device,
            *map(cuda.ptr, (indices, values, out)),
            indices.shape[0], num_rows, values.shape[1],
        )
    return out


def scatter_add_rows(indices, values, num_rows: int):
    """K7 on CUDA tensors, :func:`scatter_add_rows_twin` on CPU tensors."""
    if values.is_cuda:
        return _scatter_add_rows_cuda(indices, values, num_rows)
    if values.device.type == "cpu":
        return scatter_add_rows_twin(indices, values, num_rows)
    raise ValueError(f"scatter_add_rows: unsupported device {values.device}")


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices):
        idx = indices.clamp_min(0)
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = g.reshape(-1, g.shape[-1]).contiguous()
        grad = scatter_add_rows(
            idx.reshape(-1).to(torch.int32).contiguous(), flat, ctx.num_rows
        )
        return grad, None


def gather_rows(table, indices):
    """``table[max(indices, 0)]`` for ``table [V, F]`` and integer
    ``indices [...]``, whose backward scatters with :func:`scatter_add_rows`
    (as ``pallas_scatter.gather_rows`` does, clamped ids included)."""
    return _GatherRows.apply(table, indices)
