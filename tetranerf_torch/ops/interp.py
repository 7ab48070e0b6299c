"""Stream blend (kernel K2, ``csrc/blend.cu``) and sample interpolation
(kernel K3, ``csrc/interp.cu``), each beside its plain PyTorch twin.

Counterpart of :mod:`tetranerf_tpu.ops.pallas_interp` (forward only; the
backward kernels come with the train step). Both run in f32: the JAX
kernels' bf16 contraction was the price of the TPU's matrix unit, not part
of the function.
"""

from __future__ import annotations

import torch

from . import cuda


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


def sample_interp_twin(t0, t1, num_valid, ray_mask, distances, feats):
    """Per-sample features and validity from interval-endpoint features.

    ``t0, t1 f32[R, T]`` (sorted, ``+inf`` padded), ``num_valid i32[R]``,
    ``ray_mask bool[R]``, ``distances f32[R, S]``, ``feats f32[R, T+1, F]``
    -> ``(f32[R, S, F], bool[R, S])``. Sample ``d`` falls in interval
    ``k = #(t1 <= d)`` and takes the lerp of endpoints ``k`` and ``k+1``."""
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
    idx = k_c[..., None].expand(-1, -1, feats.shape[-1])
    f0 = feats.gather(1, idx)
    f1 = feats.gather(1, idx + 1)
    out = (1.0 - frac)[..., None] * f0 + frac[..., None] * f1
    return torch.where(mask[..., None], out, 0.0), mask


def _sample_interp_cuda(t0, t1, num_valid, ray_mask, distances, feats):
    cuda.check_cuda_inputs(
        "sample_interp", t0=t0, t1=t1, num_valid=num_valid,
        ray_mask=ray_mask, distances=distances, feats=feats,
    )
    num_rays, max_t = t1.shape
    num_samples = distances.shape[1]
    num_feat = feats.shape[2]
    if (
        t0.shape != t1.shape or t0.dtype != torch.float32
        or t1.dtype != torch.float32 or num_valid.dtype != torch.int32
        or ray_mask.dtype != torch.bool or distances.dtype != torch.float32
        or distances.shape[0] != num_rays or feats.dtype != torch.float32
        or feats.shape[:2] != (num_rays, max_t + 1) or num_feat % 2
    ):
        raise ValueError("sample_interp: unexpected shapes or dtypes")
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
