"""Stream blend (kernels K2 and K2b, ``csrc/blend.cu``) and sample
interpolation (K3 and K3b, ``csrc/interp.cu``), each beside its plain
PyTorch twin, and the autograd Functions that join each forward kernel to
its backward.

Counterpart of :mod:`tetranerf_tpu.ops.pallas_interp`. All run in f32: the
JAX kernels' bf16 contraction was the price of the TPU's matrix unit, not
part of the function.
"""

from __future__ import annotations

import torch

from . import cuda
from .scatter import scatter_add_rows


def stream_blend_gather_twin(field, vids, pos, bary):
    """``out[r, e] = sum_j bary[r, e, j] * field[vids[r, pos[r, e, j]]]``.

    ``field f32[V, F]``, ``vids i32[R, U]``, ``pos i32[R, E, 4]`` in
    ``[0, U)``, ``bary f32[R, E, 4]`` (zero at invalid endpoints) ->
    ``f32[R, E, F]``."""
    num_rays, num_end = pos.shape[:2]
    vid_e = vids.gather(1, pos.reshape(num_rays, -1).long()).clamp_min(0)
    rows = field[vid_e.long()].reshape(num_rays, num_end, 4, -1)
    w = bary[..., None]
    return (
        w[:, :, 0] * rows[:, :, 0] + w[:, :, 1] * rows[:, :, 1]
    ) + w[:, :, 2] * rows[:, :, 2] + w[:, :, 3] * rows[:, :, 3]


def _stream_blend_gather_cuda(field, vids, pos, bary):
    cuda.check_cuda_inputs(
        "stream_blend_gather", field=field, vids=vids, pos=pos, bary=bary
    )
    num_rays, num_end = pos.shape[:2]
    num_feat = field.shape[1]
    if (
        field.dtype != torch.float32 or num_feat % 2
        or vids.dtype != torch.int32 or vids.shape[0] != num_rays
        or pos.dtype != torch.int32 or pos.shape != (num_rays, num_end, 4)
        or bary.dtype != torch.float32 or bary.shape != pos.shape
    ):
        raise ValueError("stream_blend_gather: unexpected shapes or dtypes")
    out = torch.empty(
        (num_rays, num_end, num_feat), dtype=torch.float32, device=field.device
    )
    if out.numel():
        cuda.launch(
            "stream_blend_gather", "tetranerf_stream_blend_gather",
            field.device, *map(cuda.ptr, (field, vids, pos, bary, out)),
            num_rays, num_end, vids.shape[1], num_feat,
        )
    return out


def stream_blend_gather(field, vids, pos, bary):
    """K2 on CUDA tensors, :func:`stream_blend_gather_twin` on CPU tensors."""
    if field.is_cuda:
        return _stream_blend_gather_cuda(field, vids, pos, bary)
    if field.device.type == "cpu":
        return stream_blend_gather_twin(field, vids, pos, bary)
    raise ValueError(f"stream_blend_gather: unsupported device {field.device}")


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


def stream_blend_backward_twin(g, pos, bary, num_stream: int):
    """The transpose of the stream blend onto the stream rows:
    ``gsf[r, u] = sum_{e, j: pos[r, e, j] = u} bary[r, e, j] * g[r, e]``.

    ``g f32[R, E, F]``, ``pos i32[R, E, 4]``, ``bary f32[R, E, 4]`` ->
    ``f32[R, U, F]`` with ``U = num_stream``."""
    num_rays, num_end, num_feat = g.shape
    contrib = (bary[..., None] * g[:, :, None, :]).reshape(
        num_rays, num_end * 4, num_feat
    )
    idx = pos.reshape(num_rays, num_end * 4, 1).long().expand(-1, -1, num_feat)
    out = g.new_zeros((num_rays, num_stream, num_feat))
    return out.scatter_add_(1, idx, contrib)


def _stream_blend_backward_cuda(g, pos, bary, num_stream: int):
    cuda.check_cuda_inputs("stream_blend_backward", g=g, pos=pos, bary=bary)
    num_rays, num_end, num_feat = g.shape
    if (
        g.dtype != torch.float32 or num_feat % 2
        or pos.dtype != torch.int32 or pos.shape != (num_rays, num_end, 4)
        or bary.dtype != torch.float32 or bary.shape != pos.shape
    ):
        raise ValueError("stream_blend_backward: unexpected shapes or dtypes")
    gsf = torch.empty(
        (num_rays, num_stream, num_feat), dtype=torch.float32, device=g.device
    )
    if gsf.numel():
        cuda.launch(
            "stream_blend_backward", "tetranerf_stream_blend_backward",
            g.device, *map(cuda.ptr, (g, pos, bary, gsf)),
            num_rays, num_end, num_stream, num_feat,
        )
    return gsf


def stream_blend_backward(g, pos, bary, num_stream: int):
    """K2b on CUDA tensors, :func:`stream_blend_backward_twin` on CPU tensors."""
    if g.is_cuda:
        return _stream_blend_backward_cuda(g, pos, bary, num_stream)
    if g.device.type == "cpu":
        return stream_blend_backward_twin(g, pos, bary, num_stream)
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


class StreamBlendGather(torch.autograd.Function):
    """:func:`stream_blend_gather` (K2) with the field gradient: K2b onto
    the stream rows, then K7 scatters them into ``[V, F]`` by vertex id.
    The forward reads row ``max(vid, 0)``, so the backward scatters there
    too, as autodiff of the JAX ``field[max(vids, 0)]`` does; a march emits
    no negative ids, and the zero rows of unused slots issue no atomics.
    ``vids``, ``pos`` and ``bary`` take no gradient."""

    @staticmethod
    def forward(ctx, field, vids, pos, bary):
        ctx.save_for_backward(vids, pos, bary)
        ctx.num_rows = field.shape[0]
        return stream_blend_gather(field, vids, pos, bary)

    @staticmethod
    def backward(ctx, g):
        vids, pos, bary = ctx.saved_tensors
        gsf = stream_blend_backward(g.contiguous(), pos, bary, vids.shape[1])
        grad = scatter_add_rows(
            vids.reshape(-1).clamp_min(0), gsf.reshape(-1, gsf.shape[-1]),
            ctx.num_rows,
        )
        return grad, None, None, None


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
