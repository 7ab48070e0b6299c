"""Stream blend (kernels K2 and K2b, ``csrc/blend.cu``) and sample
interpolation (K3 and K3b, ``csrc/interp.cu``), each beside its plain
PyTorch twin, and the autograd Functions that join each forward kernel to
its backward.

Counterpart of :mod:`tetranerf_tpu.ops.pallas_interp`. All run in f32: the
JAX kernels' bf16 contraction was the price of the TPU's matrix unit, not
part of the function. The low-precision streams (``field_stream_dtype``
bf16, f16 or an 8- or 4-bit float, JAX ``gather_rows_lowp``) have their
own instances, one for each row type (:mod:`.stream_dtypes`): K2 reads
the field in that type and blends in f32, K2b writes the stream-row
gradient in that type (rounded once, as ``jnp.astype`` rounds:
:func:`~.stream_dtypes.round_to`), and K7 adds those rows into the f32
field gradient. Rows of the seven types torch lacks are ``uint8`` codes;
the calls then name their row type (``row_type``).

JAX's blend is a dense contraction over a ray's stream slots, so a NaN or
an infinity in any slot row reaches every endpoint of the ray in its
column (``0 * x`` is NaN). For the seven software row types, the only
ones whose rounding of finite values gives NaN in ordinary use
(float8_e8m0fnu has no zero and no sign), K2 and its twin follow it
(:func:`dense_nan`); the f32, bf16, f16 and fp8 instances blend the rows
an endpoint weights and nothing else. K2's launch for the six of them
with NaN or infinity codes first reads the field's codes once, on the
device, for whether any is one (its plain version
:func:`~.stream_dtypes.nonfinite`; no host sync); where none is, the
blend skips the rule's count.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import cuda
from .scatter import scatter_add_rows_batch
from . import stream_dtypes
from .stream_dtypes import F32, RowTypeLike, round_to, rows_type, widen

Stream = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
"""``(vids i32[R, U], pos i32[R, E, 4], bary f32[R, E, 4])``: one march
stream (``MarchStream``'s fields) to blend against the field."""

# Device scratch K2's flag pass writes for the row types with JAX's NaNs:
# one byte a block of the pass (blend.cu ``kFlagBlocks``; the C entry point
# refuses less).
_FLAG_BYTES = 256


def stream_blend_gather_twin(field, vids, pos, bary, row_type: RowTypeLike = None):
    """``out[r, e] = sum_j bary[r, e, j] * field[vids[r, pos[r, e, j]]]``.

    ``field f32[V, F]`` or rows of a stream row type (``row_type``; where
    None, ``field``'s dtype's: its rows widen exactly and blend in f32),
    ``vids i32[R, U]``, ``pos i32[R, E, 4]`` in ``[0, U)``, ``bary f32[R,
    E, 4]`` (zero at invalid endpoints) -> ``f32[R, E, F]``. The seven
    software row types blend the rows an endpoint weights, then take
    JAX's NaNs (:func:`dense_nan`)."""
    num_rays, num_end = pos.shape[:2]
    vid_e = vids.gather(1, pos.reshape(num_rays, num_end * 4).long()).clamp_min(0)
    t = None if field.dtype == torch.float64 else rows_type(field, row_type)
    if t is not None and t.minifloat:
        values = widen(field, t)
        rows = values[vid_e.long()].reshape(num_rays, num_end, 4, field.shape[-1])
        w = bary[..., None]
        terms = [torch.where(w[:, :, j] != 0, w[:, :, j] * rows[:, :, j], 0.0)
                 for j in range(4)]
        out = ((terms[0] + terms[1]) + terms[2]) + terms[3]
        return dense_nan(out, values, vids, pos, bary)
    rows = field[vid_e.long()].reshape(num_rays, num_end, 4, field.shape[-1])
    if rows.element_size() < 4:  # a stream row type; f64 stays f64
        rows = rows.float()
    w = bary[..., None]
    return (
        w[:, :, 0] * rows[:, :, 0] + w[:, :, 1] * rows[:, :, 1]
    ) + w[:, :, 2] * rows[:, :, 2] + w[:, :, 3] * rows[:, :, 3]


def dense_nan(out, values, vids, pos, bary):
    """``out [R, E, F]`` with JAX's NaNs: NaN where a slot row of the ray
    (``values f32[V, F]`` at ``max(vids, 0)``) holds a NaN or an infinity
    in the column and the endpoint's nonzero weights do not reach that
    slot. JAX blends the ``[U, F]`` slot rows of a ray with a dense
    ``[E, U]`` matrix, whose zeros make ``0 * x`` of such a value, NaN; the
    slots an endpoint weights add ``w * x`` as the blend does. So a column
    is NaN where its count of non-finite slots exceeds that of the
    distinct slots the endpoint weights."""
    bad = ~values.isfinite()
    if not bad.any():
        return out
    num_rays, num_end = pos.shape[:2]
    slot_bad = bad[vids.clamp_min(0).long()]  # [R, U, F]
    count = slot_bad.sum(1, dtype=torch.int32)[:, None]
    p = pos.long()
    first = bary != 0  # the weighted slots, each counted once
    for j in range(1, 4):
        for k in range(j):
            first[..., j] &= ~(first[..., k] & (p[..., k] == p[..., j]))
    hit = slot_bad.gather(1, p.reshape(num_rays, -1, 1).expand(-1, -1, bad.shape[1]))
    reached = (hit.reshape(num_rays, num_end, 4, -1) & first[..., None]).sum(
        2, dtype=torch.int32)
    return torch.where(count > reached, float("nan"), out)


def stream_blend_gather_batch_twin(field, streams: Sequence[Stream],
                                   row_type: RowTypeLike = None) -> List[torch.Tensor]:
    """:func:`stream_blend_gather_twin` of each stream."""
    return [stream_blend_gather_twin(field, *s, row_type) for s in streams]


def _stream_blend_gather_batch_cuda(field, streams: Sequence[Stream], row_type: RowTypeLike):
    num_feat = field.shape[-1]
    rows = rows_type(field, row_type)
    if (field.dim() != 2 or num_feat % 2
            or field.data_ptr() % (2 * field.element_size())):
        raise ValueError("stream_blend_gather: unexpected field shape, dtype or alignment")
    outs, flat = [], []
    for vids, pos, bary in streams:
        cuda.check_cuda_inputs("stream_blend_gather", field=field, vids=vids,
                               pos=pos, bary=bary)
        num_rays, num_end = pos.shape[:2]
        if (
            vids.dtype != torch.int32 or vids.dim() != 2 or vids.shape[0] != num_rays
            or pos.dtype != torch.int32 or pos.shape != (num_rays, num_end, 4)
            or bary.dtype != torch.float32 or bary.shape != pos.shape
            or pos.data_ptr() % 16 or bary.data_ptr() % 16
        ):
            raise ValueError("stream_blend_gather: unexpected shapes, dtypes or alignment")
        out = torch.empty((num_rays, num_end, num_feat), dtype=torch.float32,
                          device=field.device)
        outs.append(out)
        if out.numel():
            flat.append((vids.data_ptr(), pos.data_ptr(), bary.data_ptr(),
                         out.data_ptr(), num_rays, num_end, vids.shape[1]))
    counter = "stream_blend_gather" + rows.suffix
    # The types with JAX's NaNs: scratch for the kernel's flag pass over the
    # field (one byte a block of the pass, blend.cu kFlagBlocks).
    flags = (torch.empty(_FLAG_BYTES, dtype=torch.uint8, device=field.device)
             if rows.dense_nan else None)
    for jobs_arr, num in cuda.job_chunks(cuda.max_jobs("tetranerf_stream_blend_max_jobs"), flat):
        cuda.launch(counter, "tetranerf_stream_blend_gather_batch",
                    field.device, cuda.ptr(field), field.shape[0], jobs_arr, num, num_feat,
                    rows.code, None if flags is None else cuda.ptr(flags), _FLAG_BYTES)
    return outs


def stream_blend_gather_batch(field, streams: Sequence[Stream],
                              row_type: RowTypeLike = None) -> List[torch.Tensor]:
    """K2 on CUDA tensors, :func:`stream_blend_gather_batch_twin` on CPU
    tensors: the endpoint features ``f32[R_j, E_j, F]`` of each stream
    against one ``field [V, F]`` (``F`` even), f32 or rows of a stream row
    type (``row_type``, where None ``field``'s dtype's: K2's instance for
    that type). On the card one launch blends every stream (more only past
    the kernel's job capacity, 64 streams); the tensors must be
    contiguous, ``pos`` and ``bary`` 16-byte aligned."""
    if field.is_cuda:
        return _stream_blend_gather_batch_cuda(field, streams, row_type)
    if field.device.type == "cpu":
        return stream_blend_gather_batch_twin(field, streams, row_type)
    raise ValueError(f"stream_blend_gather: unsupported device {field.device}")


def stream_blend_gather(field, vids, pos, bary, row_type: RowTypeLike = None):
    """K2 on CUDA tensors, :func:`stream_blend_gather_twin` on CPU tensors:
    the one-stream case of :func:`stream_blend_gather_batch`."""
    return stream_blend_gather_batch(field, [(vids, pos, bary)], row_type)[0]


def _match(t0, t1, num_valid, ray_mask, distances):
    """Interval ``k_c`` (clamped), lerp weight ``frac`` and validity of each
    sample, as K3 and K3b compute them."""
    max_t = t1.shape[1]
    k = torch.searchsorted(t1, distances, right=True)
    k_c = k.clamp_max(max_t - 1)
    inf = torch.tensor(float("inf"), device=t1.device)
    inside = k < max_t
    t0k = torch.where(inside, t0.gather(1, k_c), inf)
    t1k = torch.where(inside, t1.gather(1, k_c), inf)
    mask = ray_mask[:, None] & (k < num_valid[:, None]) & (distances >= t0k)
    frac = (distances - t0k) / torch.clamp_min(t1k - t0k, 1e-20)
    frac = torch.where(mask, frac, 0.0).clamp(0.0, 1.0)
    return k_c, frac, mask


def sample_interp_twin(t0, t1, num_valid, ray_mask, distances, feats):
    """Per-sample features and validity from interval-endpoint features.

    ``t0, t1 f32[R, T]`` (sorted, ``+inf`` padded), ``num_valid i32[R]``,
    ``ray_mask bool[R]``, ``distances f32[R, S]``, ``feats f32[R, T+1, F]``
    -> ``(f32[R, S, F], bool[R, S])``. Sample ``d`` falls in interval
    ``k = #(t1 <= d)`` and takes the lerp of endpoints ``k`` and ``k+1``."""
    k_c, frac, mask = _match(t0, t1, num_valid, ray_mask, distances)
    idx = k_c[..., None].expand(-1, -1, feats.shape[-1])
    f0 = feats.gather(1, idx)
    f1 = feats.gather(1, idx + 1)
    out = (1.0 - frac)[..., None] * f0 + frac[..., None] * f1
    return torch.where(mask[..., None], out, 0.0), mask


def _check_match_inputs(name, t0, t1, num_valid, ray_mask, distances, x, rows):
    """The checks K3 and K3b share; ``x f32[R, rows, F]`` is their feature
    input (endpoint features or sample gradients)."""
    cuda.check_cuda_inputs(
        name, t0=t0, t1=t1, num_valid=num_valid, ray_mask=ray_mask,
        distances=distances, x=x,
    )
    if (
        t0.shape != t1.shape or t0.dtype != torch.float32
        or t1.dtype != torch.float32 or num_valid.dtype != torch.int32
        or ray_mask.dtype != torch.bool or distances.dtype != torch.float32
        or distances.shape[0] != t1.shape[0] or x.dtype != torch.float32
        or x.shape[:2] != (t1.shape[0], rows) or x.shape[2] % 2
    ):
        raise ValueError(f"{name}: unexpected shapes or dtypes")


def _sample_interp_cuda(t0, t1, num_valid, ray_mask, distances, feats):
    num_rays, max_t = t1.shape
    num_samples = distances.shape[1]
    num_feat = feats.shape[2]
    _check_match_inputs("sample_interp", t0, t1, num_valid, ray_mask,
                        distances, feats, max_t + 1)
    dev = feats.device
    out = torch.empty((num_rays, num_samples, num_feat), device=dev)
    mask = torch.empty((num_rays, num_samples), dtype=torch.bool, device=dev)
    if mask.numel():
        cuda.launch(
            "sample_interp", "tetranerf_sample_interp", dev,
            *map(cuda.ptr, (t0, t1, num_valid, ray_mask, distances, feats,
                            out, mask)),
            num_rays, max_t, num_samples, num_feat,
        )
    return out, mask


def sample_interp(t0, t1, num_valid, ray_mask, distances, feats):
    """K3 on CUDA tensors, :func:`sample_interp_twin` on CPU tensors."""
    if feats.is_cuda:
        return _sample_interp_cuda(t0, t1, num_valid, ray_mask, distances, feats)
    if feats.device.type == "cpu":
        return sample_interp_twin(t0, t1, num_valid, ray_mask, distances, feats)
    raise ValueError(f"sample_interp: unsupported device {feats.device}")


# ------------------------------------------------------------------ backward


def stream_blend_backward_twin(g, pos, bary, num_stream: int, out_dtype=None):
    """The transpose of the stream blend onto the stream rows:
    ``gsf[r, u] = sum_{e, j: pos[r, e, j] = u} bary[r, e, j] * g[r, e]``.

    ``g f32[R, E, F]``, ``pos i32[R, E, 4]``, ``bary f32[R, E, 4]`` ->
    ``[R, U, F]`` with ``U = num_stream``, summed in ``g``'s dtype and
    rounded once to ``out_dtype`` (the stream's row type, as ``jnp.astype``
    rounds: :func:`~.stream_dtypes.round_to`; None keeps ``g``'s)."""
    num_rays, num_end, num_feat = g.shape
    contrib = (bary[..., None] * g[:, :, None, :]).reshape(
        num_rays, num_end * 4, num_feat
    )
    idx = pos.reshape(num_rays, num_end * 4, 1).long().expand(-1, -1, num_feat)
    out = g.new_zeros((num_rays, num_stream, num_feat))
    out = out.scatter_add_(1, idx, contrib)
    return round_to(out, out_dtype)


def _stream_blend_backward_cuda(g, pos, bary, num_stream: int, out_dtype):
    cuda.check_cuda_inputs("stream_blend_backward", g=g, pos=pos, bary=bary)
    num_rays, num_end, num_feat = g.shape
    if (
        g.dtype != torch.float32 or num_feat % 2
        or pos.dtype != torch.int32 or pos.shape != (num_rays, num_end, 4)
        or bary.dtype != torch.float32 or bary.shape != pos.shape
    ):
        raise ValueError("stream_blend_backward: unexpected shapes or dtypes")
    out = stream_dtypes.row_type(out_dtype) or F32
    gsf = torch.empty((num_rays, num_stream, num_feat), dtype=out.storage, device=g.device)
    if gsf.numel():
        cuda.launch(
            "stream_blend_backward" + out.suffix,
            "tetranerf_stream_blend_backward",
            g.device, *map(cuda.ptr, (g, pos, bary, gsf)),
            num_rays, num_end, num_stream, num_feat, out.code,
        )
    return gsf


def stream_blend_backward(g, pos, bary, num_stream: int, out_dtype=None):
    """K2b on CUDA tensors, :func:`stream_blend_backward_twin` on CPU tensors;
    ``out_dtype`` a stream row type (a :class:`~.stream_dtypes.StreamType`,
    its name, or the torch dtype of bf16, f16 or an fp8 type) is K2b's
    instance for that type, whose rows are in its storage dtype (None: f32
    on the card, ``g``'s dtype in the twin)."""
    if g.is_cuda:
        return _stream_blend_backward_cuda(g, pos, bary, num_stream, out_dtype)
    if g.device.type == "cpu":
        return stream_blend_backward_twin(g, pos, bary, num_stream, out_dtype)
    raise ValueError(f"stream_blend_backward: unsupported device {g.device}")


def sample_interp_backward_twin(t0, t1, num_valid, ray_mask, distances, g):
    """The transpose of the sample lerp onto the endpoints: for every sample
    that :func:`sample_interp_twin` keeps, ``(1 - frac) * g[r, s]`` goes to
    endpoint ``k`` and ``frac * g[r, s]`` to ``k + 1``. ``g f32[R, S, F]``
    -> ``f32[R, T+1, F]``."""
    k_c, frac, mask = _match(t0, t1, num_valid, ray_mask, distances)
    w0 = torch.where(mask, 1.0 - frac, 0.0)[..., None]
    w1 = torch.where(mask, frac, 0.0)[..., None]
    num_rays, max_t = t1.shape
    idx = k_c[..., None].expand(-1, -1, g.shape[-1])
    out = g.new_zeros((num_rays, max_t + 1, g.shape[-1]))
    out.scatter_add_(1, idx, w0 * g)
    return out.scatter_add_(1, idx + 1, w1 * g)


def _sample_interp_backward_cuda(t0, t1, num_valid, ray_mask, distances, g):
    num_rays, max_t = t1.shape
    num_samples = distances.shape[1]
    num_feat = g.shape[2]
    _check_match_inputs("sample_interp_backward", t0, t1, num_valid, ray_mask,
                        distances, g, num_samples)
    gfeats = torch.empty((num_rays, max_t + 1, num_feat), device=g.device)
    if gfeats.numel():
        cuda.launch(
            "sample_interp_backward", "tetranerf_sample_interp_backward",
            g.device,
            *map(cuda.ptr, (t0, t1, num_valid, ray_mask, distances, g, gfeats)),
            num_rays, max_t, num_samples, num_feat,
        )
    return gfeats


def sample_interp_backward(t0, t1, num_valid, ray_mask, distances, g):
    """K3b on CUDA tensors, :func:`sample_interp_backward_twin` on CPU tensors."""
    if g.is_cuda:
        return _sample_interp_backward_cuda(
            t0, t1, num_valid, ray_mask, distances, g
        )
    if g.device.type == "cpu":
        return sample_interp_backward_twin(
            t0, t1, num_valid, ray_mask, distances, g
        )
    raise ValueError(f"sample_interp_backward: unsupported device {g.device}")


def split_streams(flat) -> List[Stream]:
    """``(vids_0, pos_0, bary_0, vids_1, ...)`` as a list of streams."""
    return [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]


def _blend_forward(ctx, field, stream_dtype, scatter_ids, num_valid, flat):
    ctx.save_for_backward(*flat)
    ctx.num_rows = field.shape[0]
    ctx.stream_dtype = stream_dtypes.row_type(stream_dtype)
    ctx.scatter_ids = scatter_ids
    ctx.num_valid = num_valid
    rows = round_to(field, ctx.stream_dtype)
    return tuple(stream_blend_gather_batch(rows, split_streams(flat), ctx.stream_dtype))


def _blend_backward(ctx, grads):
    """The field gradient: K2b per stream, one K7 over every stream. With
    the streams' ``num_valid``, K7 reads no padding slot's row: K2b wrote
    the row type's rounding of 0 there, as no endpoint weights them (+0;
    float8_e8m0fnu's NaN, which K7 still adds once, making row 0 NaN as in
    JAX)."""
    flat = ctx.saved_tensors
    jobs = []
    for i, ((vids, pos, bary), g) in enumerate(zip(split_streams(flat), grads)):
        gsf = stream_blend_backward(g.contiguous(), pos, bary, vids.shape[1],
                                    ctx.stream_dtype)
        ids = (vids.clamp_min(0) if ctx.scatter_ids is None
               else ctx.scatter_ids[i])
        job = (ids.reshape(-1), gsf.reshape(-1, gsf.shape[-1]))
        jobs.append(job if ctx.num_valid is None else job + (ctx.num_valid[i],))
    return scatter_add_rows_batch(jobs, ctx.num_rows, ctx.stream_dtype)


class StreamBlendGatherBatch(torch.autograd.Function):
    """:func:`stream_blend_gather_batch` (one K2 launch) with the field
    gradient: K2b per stream onto its stream rows, then one K7 scatters all
    of them into one ``[V, F]`` gradient by vertex id. Called as
    ``apply(field, stream_dtype, scatter_ids, num_valid, vids_0, pos_0,
    bary_0, vids_1, ...)``; returns one ``f32[R_j, E_j, F]`` per stream.
    The streams take no gradient. ``num_valid`` (each march's ``i32[R_j]``
    valid intervals, or None) lets K7 skip each ray's padding slots. The
    two stream levers:

    - ``stream_dtype`` a stream row type, bf16, f16 or an 8- or 4-bit
      float (JAX ``gather_rows_lowp``): the field is rounded once to
      a ``[V, F]`` copy in that type (:func:`~.stream_dtypes.round_to`)
      that K2's instance for the type blends in f32; the backward runs
      K2b's and K7's instances for the type, and K7 adds into the f32
      field gradient. None: f32 rows.
    - ``scatter_ids`` (the gradient-stream budget, JAX ``_stream_gather``):
      one ``i32[R_j, U_j]`` per stream, the vertex row each stream slot's
      gradient goes to, ``-1`` for a slot whose gradient is dropped (K7
      drops negative ids). None: every slot kept. The forward reads row
      ``max(vid, 0)``, so the backward scatters there too, as autodiff of
      the JAX ``field[max(vids, 0)]`` does; a march emits no negative ids,
      and the zero rows of unused slots issue no atomics."""

    @staticmethod
    def forward(ctx, field, stream_dtype, scatter_ids, num_valid, *flat):
        return _blend_forward(ctx, field, stream_dtype, scatter_ids, num_valid, flat)

    @staticmethod
    def backward(ctx, *grads):
        return ((_blend_backward(ctx, grads), None, None, None)
                + (None,) * len(ctx.saved_tensors))


class StreamBlendGather(torch.autograd.Function):
    """The one-stream case of :class:`StreamBlendGatherBatch`:
    ``apply(field, vids, pos, bary)`` -> ``f32[R, E, F]``."""

    @staticmethod
    def forward(ctx, field, vids, pos, bary):
        return _blend_forward(ctx, field, None, None, None, (vids, pos, bary))[0]

    @staticmethod
    def backward(ctx, g):
        return (_blend_backward(ctx, (g,)), None, None, None)


class SampleInterp(torch.autograd.Function):
    """:func:`sample_interp` (K3) with the gradient of the endpoint features
    (K3b). Only ``feats`` takes a gradient; the mask output takes none."""

    @staticmethod
    def forward(ctx, t0, t1, num_valid, ray_mask, distances, feats):
        out, mask = sample_interp(t0, t1, num_valid, ray_mask, distances, feats)
        ctx.save_for_backward(t0, t1, num_valid, ray_mask, distances)
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, _g_mask):
        grad = sample_interp_backward(*ctx.saved_tensors, g.contiguous())
        return None, None, None, None, None, grad
