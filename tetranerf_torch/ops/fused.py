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

The two stream levers of :func:`endpoint_features_batch` (JAX
``endpoint_features(..., counts, grad_budget, stream_dtype)``): a
low-precision stream, bf16, f16 or an 8- or 4-bit float (K2, K2b and K7's
instances for that row type, :mod:`.stream_dtypes`; the field gradient
still summed in f32),
and the gradient-stream budget (:func:`stream_budget_ids`: the slots past
the budget scatter no gradient).

With the field sharded over its feature axis (``columns``, a
:class:`~..parallel.Group` of model shards), K2 blends this rank's ``F/M``
columns and one gather over the model group puts every stream's endpoint
features at full width; the backward runs K2b and K7 on this rank's columns
of the gradient (:class:`~..parallel.GatherColumns`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..parallel.distributed import gather_columns
from .interp import (
    SampleInterp,
    StreamBlendGatherBatch,
    sample_interp,
    split_streams,
    stream_blend_gather_batch,
)
from .gather import row_gather_batch
from .march import FusedMarch, MarchStream, march
from .stream_dtypes import RowTypeLike, round_to, row_type


def endpoint_features_batch(field: torch.Tensor, streams: Sequence[MarchStream],
                            stream_dtype: RowTypeLike = None,
                            scatter_ids: Optional[Sequence[torch.Tensor]] = None,
                            columns=None,
                            num_valid: Optional[Sequence[torch.Tensor]] = None
                            ) -> List[torch.Tensor]:
    """Interval-endpoint features ``f32[R_j, T_j+1, F]`` of each march
    stream, in one K2 launch; the only field-dependent part of the
    traversal. Where autograd records, the field gradient of all streams is
    one ``[V, F]`` tensor (one K7 launch).

    ``stream_dtype`` (a :class:`~.stream_dtypes.StreamType` of bf16, f16
    or an 8- or 4-bit float, its name, or its torch dtype where torch has
    one; JAX ``gather_rows_lowp``) blends a copy of the field in that type, rounded
    once here as ``jnp.astype`` rounds (:func:`~.stream_dtypes.round_to`:
    plain torch ops, as JAX leaves the cast to XLA; torch's own cast would
    saturate float8_e4m3fn where JAX gives NaN), in K2's instance for the
    type, and sends the gradient through stream rows in that type (K2b's
    and K7's instances) into the f32 field gradient; ``scatter_ids``
    (:func:`stream_budget_ids`, one per stream) drop the field gradient of
    the slots past the gradient-stream budget.
    The forward is the same either way.

    ``columns`` (a :class:`~..parallel.Group` with model shards) says that
    ``field`` is this rank's ``[V, F/M]`` column block: K2 runs at ``F/M``
    and one gather over the model group returns every stream at ``F``.
    ``num_valid`` (each stream's march ``num_valid``, ``i32[R_j]``) lets the
    backward's K7 skip the slots past each ray's ``num_valid + 4``, which
    no endpoint weights; the gradient is the same."""
    field = field.contiguous()
    stream_dtype = row_type(stream_dtype)
    flat = [x.contiguous() for s in streams for x in (s.vids, s.pos, s.bary)]
    if torch.is_grad_enabled() and field.requires_grad:
        outs = StreamBlendGatherBatch.apply(field, stream_dtype, scatter_ids,
                                            _int32(num_valid), *flat)
    else:
        outs = stream_blend_gather_batch(round_to(field, stream_dtype), split_streams(flat),
                                         stream_dtype)
    return gather_columns(columns, outs)


def _int32(tensors):
    return None if tensors is None else [t.to(torch.int32).contiguous() for t in tensors]


def endpoint_features(field: torch.Tensor, stream: MarchStream,
                      stream_dtype: RowTypeLike = None,
                      scatter_ids: Optional[torch.Tensor] = None,
                      columns=None, num_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Interval-endpoint features ``f32[R, T+1, F]`` of a march (K2): the
    one-stream case of :func:`endpoint_features_batch`."""
    return endpoint_features_batch(
        field, [stream], stream_dtype,
        None if scatter_ids is None else [scatter_ids], columns,
        None if num_valid is None else [num_valid])[0]


def stream_budget_ids(vids: torch.Tensor, counts: torch.Tensor, offs: torch.Tensor,
                      budget: int, last: torch.Tensor) -> torch.Tensor:
    """K7's scatter ids ``i32[R, U]`` of a march stream under the
    gradient-stream budget (JAX ``_stream_gather``'s backward,
    ``tetranerf_tpu/ops/fused.py:629-659``): ``max(vids, 0)`` where a slot
    keeps its field gradient, ``-1`` where it is dropped.

    Ray ``r`` uses its first ``counts[r]`` slots (``min(num_valid + 4, U)``)
    and they lie at ``offs[r], offs[r] + 1, ...`` of the forward's flat
    stream (``offs``: the exclusive sum of the counts of the rays before
    it, in the forward's ray order and across ranks). A slot at position
    ``p`` keeps its gradient when ``p < budget - 1``, so a ray that
    straddles the budget keeps its first slots. Position ``budget - 1`` is
    kept only by the forward's last ray (``last[r]``): JAX recovers each
    slot's ray from marks at ``min(offs, budget - 1)``, so every ray that
    starts at or past the budget marks that slot too, and it goes to the
    last ray."""
    width = vids.shape[1]
    u = torch.arange(width, device=vids.device, dtype=torch.int64)[None, :]
    pos = offs.to(torch.int64)[:, None] + u
    keep = (u < counts[:, None]) & (
        (pos < budget - 1) | ((pos == budget - 1) & last[:, None]))
    return torch.where(keep, vids.clamp_min(0), -1).to(torch.int32).contiguous()


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
    columns=None,
) -> FusedMarch:
    """March rays (K1) and, when ``field f32[V, F]`` is given, emit their
    endpoint features (K2; ``columns`` as in :func:`endpoint_features_batch`).
    With ``use_skip`` and ``use_occupancy`` the rays sphere-trace the mesh's
    skip grid first, where it has one."""
    res = march(
        mesh, origins, directions, max_steps, entry_walk_steps,
        use_occupancy, occ_threshold, occ_depth_cap, use_skip,
    )
    if field is None:
        return res
    return res._replace(feats=endpoint_features(field, res.stream, columns=columns,
                                                num_valid=res.num_valid))


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
