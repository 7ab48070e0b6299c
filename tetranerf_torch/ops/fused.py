"""March + field interpolation: the render hot path around the kernels.

Counterpart of ``march_features``, ``endpoint_features``, ``ray_bounds``,
``biased_warp_range`` and ``sample_features`` in
:mod:`tetranerf_tpu.ops.fused`. Barycentric interpolation is affine along a
ray inside a cell and continuous across faces, so a sample's feature is
the exact lerp of the features at its interval's two endpoints: the march
emits endpoint features once (K2) and every sampling round lerps them (K3).
Bucketed shading cuts each quantile bucket out of one march with the row
gather K8 (:func:`slice_march`) and recomputes its endpoint features.
Where autograd records (grad enabled and a differentiable input), the two go
through the autograd Functions whose backwards are K2b + K7 and K3b.
"""

from __future__ import annotations

import torch

from .interp import (
    SampleInterp,
    StreamBlendGather,
    sample_interp,
    stream_blend_gather,
)
from .gather import row_gather
from .march import FusedMarch, MarchStream, march


def endpoint_features(field: torch.Tensor, stream: MarchStream) -> torch.Tensor:
    """Interval-endpoint features ``f32[R, T+1, F]`` of a march (K2); the
    only field-dependent part of the traversal."""
    args = (field.contiguous(), stream.vids.contiguous(),
            stream.pos.contiguous(), stream.bary.contiguous())
    if torch.is_grad_enabled() and field.requires_grad:
        return StreamBlendGather.apply(*args)
    return stream_blend_gather(*args)


def march_features(
    mesh,
    field,
    origins,
    directions,
    max_steps: int = 512,
    entry_walk_steps: int = 16,
    use_occupancy: bool = False,
    occ_threshold: float = 1e-3,
    occ_depth_cap=None,
) -> FusedMarch:
    """March rays (K1) and, when ``field f32[V, F]`` is given, emit their
    endpoint features (K2)."""
    res = march(
        mesh, origins, directions, max_steps, entry_walk_steps,
        use_occupancy, occ_threshold, occ_depth_cap,
    )
    if field is None:
        return res
    return res._replace(feats=endpoint_features(field, res.stream))


def slice_march(res: FusedMarch, idx: torch.Tensor, t: int) -> FusedMarch:
    """Rays ``idx`` of a geometry-only march, cut to their first ``t``
    intervals (JAX ``_slice_march``); ``feats`` is left None (recompute
    with :func:`endpoint_features`).

    Endpoint ``k`` references stream positions below ``4 + k``, so a stream
    cut to ``t + 4`` ids and ``t + 1`` endpoints is self-consistent. The
    ``[R, T]`` tensors and the stream go through K8, one launch each; the
    per-ray vectors through plain indexing. Rays with more than ``t`` valid
    intervals lose their far tail, and that truncation is folded into
    ``overflow``."""
    t = min(t, res.t1.shape[1])
    idx = idx.to(torch.int32).contiguous()
    num = idx.shape[0]
    s = res.stream

    def endpoints(x):  # [R, T+1, 4] as [R, (T+1)*4] rows, cut to t+1 endpoints
        return row_gather(x.reshape(x.shape[0], -1), idx, (t + 1) * 4).view(num, t + 1, 4)

    stream = MarchStream(vids=row_gather(s.vids, idx, t + 4),
                         pos=endpoints(s.pos), bary=endpoints(s.bary))
    valid = row_gather(res.valid, idx, t)
    num_valid = valid.sum(dim=-1, dtype=torch.int32)
    rows = idx.long()
    return FusedMarch(
        cells=row_gather(res.cells, idx, t),
        t1=row_gather(res.t1, idx, t),
        t_entry=res.t_entry[rows],
        valid=valid,
        num_valid=num_valid,
        feats=None,
        hit=res.hit[rows],
        overflow=res.overflow[rows] | (num_valid < res.num_valid[rows]),
        stream=stream,
        t0s=row_gather(res.t0s, idx, t) if res.t0s is not None else None,
    )


def ray_bounds(res: FusedMarch, near: float = 0.0):
    """Per-ray ``(nears, fars, first_kept, num_kept, ray_mask)``; intervals
    entered before ``near`` are dropped (an origin's own partial cell)."""
    t0 = res.t0
    drop = (res.valid & (t0 < near)).sum(dim=-1).to(torch.int32)
    num_kept = res.num_valid - drop
    ray_mask = res.hit & (num_kept > 0)
    max_t = res.t1.shape[1]
    first = drop.clamp_max(max_t - 1)[:, None].long()
    nears = t0.gather(1, first)[:, 0]
    last = (res.num_valid - 1).clamp(0, max_t - 1)[:, None].long()
    fars = res.t1.gather(1, last)[:, 0]
    nears = torch.where(ray_mask, nears, 0.0)
    fars = torch.where(ray_mask, torch.maximum(fars, nears + 1e-6), 1.0)
    return nears, fars, drop, num_kept, ray_mask


def biased_warp_range(res: FusedMarch, first, num_kept, nears, fars, samples):
    """Warp euclidean bin edges so each kept interval
    ``first .. first+num_kept-1`` gets an equal share of the samples."""
    max_t = res.t1.shape[1]
    idx_t = torch.arange(max_t, device=samples.device)[None, :]
    kept = (idx_t >= first[:, None]) & (idx_t < (first + num_kept)[:, None])
    lengths = torch.where(kept, torch.clamp_min(res.t1 - res.t0, 0.0), 0.0)
    span = fars - nears
    uni = (samples - nears[:, None]) / torch.where(span == 0, 1.0, span)[:, None]
    nk = num_kept.clamp_min(1)[:, None].to(samples.dtype)
    rest = uni * nk
    local = torch.minimum(torch.clamp_min(torch.floor(rest), 0.0), nk - 1)
    rest = rest - local
    intervals = (first[:, None] + local.to(torch.int32)).clamp(0, max_t - 1)
    cum = torch.cumsum(torch.cat([nears[:, None], lengths], dim=1), dim=1)
    idx = intervals.long()
    return cum.gather(1, idx) + lengths.gather(1, idx) * rest


def sample_features(res: FusedMarch, distances, ray_mask):
    """Per-sample features ``f32[R, S, F]`` and validity ``bool[R, S]`` at
    sorted ``distances f32[R, S]`` (K3)."""
    args = (res.t0.contiguous(), res.t1.contiguous(), res.num_valid.contiguous(),
            ray_mask.contiguous(), distances.contiguous(), res.feats.contiguous())
    if torch.is_grad_enabled() and res.feats.requires_grad:
        return SampleInterp.apply(*args)
    return sample_interp(*args)
