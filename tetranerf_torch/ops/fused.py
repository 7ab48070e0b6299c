"""March + field interpolation: the render hot path around the kernels.

Counterpart of ``march_features``, ``endpoint_features``, ``ray_bounds``,
``biased_warp_range`` and ``sample_features`` in
:mod:`tetranerf_tpu.ops.fused`. Barycentric interpolation is affine along a
ray inside a cell and continuous across faces, so a sample's feature is
the exact lerp of the features at its interval's two endpoints: the march
emits endpoint features once (K2) and every sampling round lerps them (K3).
Bucketed shading cuts every quantile bucket out of one march with one
launch of the row gather K8 (:func:`slice_march_buckets`) and recomputes
every bucket's endpoint features with one launch of K2
(:func:`endpoint_features_batch`).
Where autograd records (grad enabled and a differentiable input), the two go
through the autograd Functions whose backwards are K2b + K7 and K3b.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .interp import (
    SampleInterp,
    StreamBlendGatherBatch,
    sample_interp,
    split_streams,
    stream_blend_gather_batch,
)
from .gather import row_gather_batch
from .march import FusedMarch, MarchStream, march


def endpoint_features_batch(field: torch.Tensor,
                            streams: Sequence[MarchStream]) -> List[torch.Tensor]:
    """Interval-endpoint features ``f32[R_j, T_j+1, F]`` of each march
    stream, in one K2 launch; the only field-dependent part of the
    traversal. Where autograd records, the field gradient of all streams is
    one ``[V, F]`` tensor (one K7 launch)."""
    field = field.contiguous()
    flat = [x.contiguous() for s in streams for x in (s.vids, s.pos, s.bary)]
    if torch.is_grad_enabled() and field.requires_grad:
        return list(StreamBlendGatherBatch.apply(field, *flat))
    return stream_blend_gather_batch(field, split_streams(flat))


def endpoint_features(field: torch.Tensor, stream: MarchStream) -> torch.Tensor:
    """Interval-endpoint features ``f32[R, T+1, F]`` of a march (K2): the
    one-stream case of :func:`endpoint_features_batch`."""
    return endpoint_features_batch(field, [stream])[0]


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
    use_skip: bool = True,
) -> FusedMarch:
    """March rays (K1) and, when ``field f32[V, F]`` is given, emit their
    endpoint features (K2). With ``use_skip`` and ``use_occupancy`` the
    rays sphere-trace the mesh's skip grid first, where it has one."""
    res = march(
        mesh, origins, directions, max_steps, entry_walk_steps,
        use_occupancy, occ_threshold, occ_depth_cap, use_skip,
    )
    if field is None:
        return res
    return res._replace(feats=endpoint_features(field, res.stream))


def slice_march_jobs(res: FusedMarch, order: torch.Tensor, plan, rays=()):
    """The K8 jobs ``(table, idx, width)`` with which
    :func:`slice_march_buckets` cuts ``res``, bucket by bucket: per entry
    ``(_, lo, hi, t, ...)`` of ``plan``, rays ``order[lo:hi]`` cut to
    ``min(t, T)`` intervals. A bucket's jobs are, in order: cells, t1, t0s
    (where the march has them), valid, the stream's ids, positions and
    weights, then ``t_entry``, ``hit``, ``num_valid`` and ``overflow`` as
    1-column jobs, then each of ``rays`` (``[R, C]`` tensors) whole.

    Endpoint ``k`` references stream positions below ``4 + k``, so a stream
    cut to ``t + 4`` ids and ``t + 1`` endpoints is self-consistent; ``pos``
    and ``bary`` are cut as ``[R, (T+1)*4]`` rows."""
    order = order.to(torch.int32).contiguous()
    num_rays, max_t = res.t1.shape
    s = res.stream
    pos, bary = (x.reshape(num_rays, -1) for x in (s.pos, s.bary))
    per_ray = [x[:, None] for x in (res.t_entry, res.hit, res.num_valid, res.overflow)]
    jobs = []
    for _, lo, hi, t, *_ in plan:
        t = min(t, max_t)
        idx = order[lo:hi]
        tensors = [(res.cells, t), (res.t1, t)]
        if res.t0s is not None:
            tensors.append((res.t0s, t))
        tensors += [(res.valid, t), (s.vids, t + 4), (pos, (t + 1) * 4),
                    (bary, (t + 1) * 4)]
        tensors += [(x, 1) for x in per_ray] + [(x, x.shape[1]) for x in rays]
        jobs += [(table, idx, width) for table, width in tensors]
    return jobs


def slice_march_buckets(res: FusedMarch, order: torch.Tensor, plan, rays=()):
    """Every bucket of ``plan`` cut out of a geometry-only march in one K8
    launch (JAX ``_slice_march`` per bucket): per entry ``(_, lo, hi, t,
    ...)``, rays ``order[lo:hi]`` cut to their first ``t`` intervals, and
    those rays' rows of each ``[R, C]`` tensor of ``rays`` (origins,
    directions). Returns one ``(FusedMarch, [ray rows])`` per entry;
    ``feats`` is left None (recompute with :func:`endpoint_features_batch`).

    Rays with more than ``t`` valid intervals lose their far tail, and that
    truncation is folded into ``overflow``."""
    jobs = slice_march_jobs(res, order, plan, rays)
    outs = iter(row_gather_batch(jobs))
    slices = []
    for _, lo, hi, t, *_ in plan:
        t = min(t, res.t1.shape[1])
        num = hi - lo
        cells, t1 = next(outs), next(outs)
        t0s = next(outs) if res.t0s is not None else None
        valid, vids, pos, bary = (next(outs) for _ in range(4))
        t_entry, hit, num_valid_before, overflow = (next(outs).view(num) for _ in range(4))
        num_valid = valid.sum(dim=-1, dtype=torch.int32)
        march = FusedMarch(
            cells=cells, t1=t1, t_entry=t_entry, valid=valid, num_valid=num_valid,
            feats=None, hit=hit, overflow=overflow | (num_valid < num_valid_before),
            stream=MarchStream(vids=vids, pos=pos.view(num, t + 1, 4),
                               bary=bary.view(num, t + 1, 4)),
            t0s=t0s,
        )
        slices.append((march, [next(outs) for _ in rays]))
    return slices


def slice_march(res: FusedMarch, idx: torch.Tensor, t: int) -> FusedMarch:
    """Rays ``idx`` of a geometry-only march, cut to their first ``t``
    intervals (JAX ``_slice_march``): the one-bucket case of
    :func:`slice_march_buckets`."""
    return slice_march_buckets(res, idx, [(0, 0, idx.shape[0], t)])[0][0]


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
