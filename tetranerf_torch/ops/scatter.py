"""Row scatter-add (kernel K7, ``csrc/scatter.cu``) beside its plain PyTorch
twin, for one or several index/value pairs into one table, and the row
gather whose backward it is.

Counterpart of :mod:`tetranerf_tpu.ops.pallas_scatter`. On the train path
K7 is the second half of the stream blend's backward
(:class:`~.interp.StreamBlendGatherBatch`): one launch scatters the
stream-row gradients of every bucket of a step into the one ``[V, F]``
field gradient. With a low-precision stream the rows are in the stream's
row type and K7's instance for that type adds them into the f32 table;
rows of the seven 8- and 4-bit types torch lacks are ``uint8`` codes, and
the calls name their row type (``row_type``, :mod:`.stream_dtypes`).

A job of a march stream's rows (``[R, U]`` slots, flattened) may carry its
rays' ``num_valid``: a ray's slots past ``num_valid + 4`` are padding that no
endpoint weights, so K2b wrote the row type's rounding of 0 there, and K7
reads none of their rows: +0 adds nothing, and float8_e8m0fnu's NaN (it has
no zero) is added once for each run of one id among a ray's padding slots.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import cuda
from .stream_dtypes import F32, RowTypeLike, round_to, rows_type, widen

Job = Tuple[torch.Tensor, ...]
"""``(indices i32[N], values [N, F])``: rows to add into the table, f32
or a stream row type; or ``(indices, values, num_valid i32[R])`` for the
``N = R * U`` slots of a march stream, whose rows at slots ``u >=
num_valid[r] + 4`` of ray ``r`` are taken to be the row type's rounding of
0 and not read (:data:`STREAM_HEAD`, :func:`used_rows`)."""

STREAM_HEAD = 4
"""A march stream's slots before its first step (the entry cell's
vertices): ray ``r`` uses its first ``num_valid[r] + STREAM_HEAD``."""


def used_rows(job: Job, row_type: RowTypeLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(indices, values)`` that K7 adds for ``job`` (rows in the row type
    ``row_type``, where None their dtype's): all its rows, or for a stream
    job those of each ray's used slots, and for a type without zero
    (float8_e8m0fnu) its padding slots' ids with rows of its rounding of 0,
    NaN (what K2b wrote there)."""
    if len(job) == 2:
        return job
    idx, vals, num_valid = job
    num_rays = num_valid.shape[0]
    width = idx.shape[0] // num_rays if num_rays else 0
    if num_rays * width != idx.shape[0]:
        raise ValueError("scatter_add_rows: a stream job's rows are not rays x slots")
    u = torch.arange(width, device=idx.device)
    keep = (u[None, :] < num_valid[:, None].long() + STREAM_HEAD).reshape(-1)
    t = F32 if vals.dtype == torch.float64 else rows_type(vals, row_type)
    if t.zero_mask is not None:
        return idx[keep], vals[keep]
    zero = round_to(vals.new_zeros((1, vals.shape[1]), dtype=torch.float32), t)
    return idx, torch.where(keep[:, None], vals, zero)


def scatter_add_rows_twin(indices, values, num_rows: int, row_type: RowTypeLike = None):
    """``zeros[num_rows, F]`` with ``values[i]`` added into row
    ``indices[i]``, in f32 for values in a stream row type (widened
    exactly; f64 values sum in f64); rows whose index is ``< 0`` or ``>=
    num_rows`` are dropped. ``indices i32[N]``, ``values f32[N, F]`` or
    rows of a stream row type (``row_type``; where None, ``values``'
    dtype's)."""
    keep = (indices >= 0) & (indices < num_rows)
    dtype = torch.float64 if values.dtype == torch.float64 else torch.float32
    vals = widen(values[keep], row_type)
    idx = indices[keep].long()[:, None].expand(-1, values.shape[1])
    out = torch.zeros((num_rows, values.shape[1]), dtype=dtype, device=values.device)
    return out.scatter_add_(0, idx, vals)


def scatter_add_rows_batch_twin(jobs: Sequence[Job], num_rows: int,
                                row_type: RowTypeLike = None):
    """:func:`scatter_add_rows_twin` of the concatenation of the jobs' rows
    (:func:`used_rows`): one ``scatter_add_``."""
    rows = [used_rows(job, row_type) for job in jobs]
    return scatter_add_rows_twin(torch.cat([idx for idx, _ in rows]),
                                 torch.cat([vals for _, vals in rows]), num_rows, row_type)


def _scatter_add_rows_batch_cuda(jobs: Sequence[Job], num_rows: int, row_type: RowTypeLike):
    device = jobs[0][1].device
    num_feat = jobs[0][1].shape[-1]
    dtype = jobs[0][1].dtype
    rows = rows_type(jobs[0][1], row_type)
    flat: List[tuple] = []
    for idx, vals, *stream in jobs:
        cuda.check_cuda_inputs("scatter_add_rows", indices=idx, values=vals,
                               **{"num_valid": nv for nv in stream})
        if (
            vals.device != device or idx.dtype != torch.int32
            or vals.dtype != dtype or idx.dim() != 1 or vals.dim() != 2
            or vals.shape != (idx.shape[0], num_feat)
        ):
            raise ValueError("scatter_add_rows: unexpected shapes or dtypes")
        nv_ptr, width = 0, 0
        if stream:
            (nv,) = stream
            if (nv.dtype != torch.int32 or nv.dim() != 1
                    or (nv.shape[0] and idx.shape[0] % nv.shape[0])):
                raise ValueError("scatter_add_rows: unexpected num_valid")
            if nv.shape[0]:
                nv_ptr, width = nv.data_ptr(), idx.shape[0] // nv.shape[0]
        if idx.shape[0]:
            flat.append((idx.data_ptr(), vals.data_ptr(), idx.shape[0], nv_ptr, width))
    out = torch.empty((num_rows, num_feat), dtype=torch.float32, device=device)
    if not out.numel():
        return out
    if not flat:
        return out.zero_()
    counter = "scatter_add_rows" + rows.suffix
    chunks = cuda.job_chunks(cuda.max_jobs("tetranerf_scatter_add_max_jobs"), flat)
    for i, (jobs_arr, num) in enumerate(chunks):
        # The first launch zeroes the table; later ones add into it.
        cuda.launch(counter, "tetranerf_scatter_add_rows_batch", device,
                    jobs_arr, num, cuda.ptr(out), num_rows, num_feat, int(i == 0),
                    rows.code)
    return out


def scatter_add_rows_batch(jobs: Sequence[Job], num_rows: int, row_type: RowTypeLike = None):
    """K7 on CUDA tensors, :func:`scatter_add_rows_batch_twin` on CPU
    tensors: ``zeros[num_rows, F]`` with every job's rows added in.

    ``jobs`` is a non-empty list of ``(indices i32[N_j], values [N_j,
    F])``, all contiguous, one device, one ``F``, the values all f32 or all
    rows of one stream row type (``row_type``, where None the values'
    dtype's: K7's instance for that type; the table is f32 either way);
    rows whose index is ``< 0`` or ``>= num_rows`` are dropped. A job of
    stream rows may carry ``num_valid`` (:data:`Job`): its rays' padding
    slots are not read. On the card one launch adds every job (more only
    past the kernel's job capacity, 64 jobs)."""
    if not jobs:
        raise ValueError("scatter_add_rows: no jobs (the row width is unknown)")
    device = jobs[0][1].device
    if device.type == "cuda":
        return _scatter_add_rows_batch_cuda(jobs, num_rows, row_type)
    if device.type == "cpu":
        return scatter_add_rows_batch_twin(jobs, num_rows, row_type)
    raise ValueError(f"scatter_add_rows: unsupported device {device}")


def scatter_add_rows(indices, values, num_rows: int, row_type: RowTypeLike = None):
    """K7 on CUDA tensors, :func:`scatter_add_rows_twin` on CPU tensors: the
    one-job case of :func:`scatter_add_rows_batch`."""
    return scatter_add_rows_batch([(indices, values)], num_rows, row_type)


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
