"""Ray samplers: stratified and uniform bins, the interval-biased warp and
PDF resampling.

Counterpart of ``stratified_bins``, ``uniform_sample``, ``biased_warp``
and ``pdf_sample`` in :mod:`tetranerf_tpu.ops.sampling`. Randomness enters only as explicit
uniforms (``u``): the render path passes none and both samplers are then
deterministic, as in the JAX package at eval.

The JAX inversion of the CDF uses masked max/min reductions and a rank
merge because gathers are slow on the TPU; on sorted rows they select the
same elements as ``searchsorted`` + ``gather`` and a sort of the
concatenation used here.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_bins(
    num_rays: int,
    num_samples: int,
    device=None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bin edges ``[R, S+1]`` in [0, 1]: a linspace, jittered between
    neighbouring bin centres by uniforms ``u [R, S+1]`` when given."""
    bins = torch.linspace(0.0, 1.0, num_samples + 1, device=device)
    bins = bins[None, :].expand(num_rays, num_samples + 1)
    if u is None:
        return bins
    centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
    upper = torch.cat([centers, bins[..., -1:]], dim=-1)
    lower = torch.cat([bins[..., :1], centers], dim=-1)
    return lower + (upper - lower) * u


def uniform_sample(
    nears: torch.Tensor,
    fars: torch.Tensor,
    num_samples: int,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform bin edges ``[R, S+1]`` in euclidean distance between
    ``nears [R]`` and ``fars [R]``, stratified by uniforms ``u [R, S+1]``
    when given (:func:`stratified_bins`)."""
    bins = stratified_bins(nears.shape[0], num_samples, nears.device, u).to(nears.dtype)
    return nears[:, None] + bins * (fars - nears)[:, None]


def biased_warp(
    num_bounds: torch.Tensor, bounds: torch.Tensor, samples: torch.Tensor
) -> torch.Tensor:
    """Warp euclidean bin edges ``samples [R, S+1]`` (within [first entry,
    last exit]) so that each of a ray's ``num_bounds [R]`` valid traversal
    intervals ``bounds [R, T, 2]`` ([entry, exit] distances) gets an equal
    share of them: the reference's
    ``map_from_real_distances_to_biased_with_bounds``."""
    num_bounds = num_bounds.to(torch.int64)
    valid = torch.arange(bounds.shape[1], device=bounds.device)[None, :] < num_bounds[:, None]
    zero = bounds.new_zeros(())
    lengths = torch.clamp_min(torch.where(valid, bounds[..., 1], zero)
                              - torch.where(valid, bounds[..., 0], zero), 0.0)
    start = bounds[:, 0, 0]
    last = torch.clamp_min(num_bounds - 1, 0)[:, None]
    span = bounds[..., 1].gather(1, last)[:, 0] - start
    uni = (samples - start[:, None]) / torch.where(span == 0, 1.0, span)[:, None]
    rest = uni * num_bounds[:, None]
    intervals = torch.minimum(torch.clamp_min(torch.floor(rest), 0.0), last.to(rest.dtype))
    rest = rest - intervals
    intervals = intervals.to(torch.int64)
    cum = torch.cumsum(torch.cat([start[:, None], lengths], dim=1), dim=1)
    return cum.gather(1, intervals) + lengths.gather(1, intervals) * rest


def pdf_sample(
    spacing_bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    include_original: bool = True,
    histogram_padding: float = 0.01,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF resampling of spacing-domain edges ``[R, S+1]`` by
    rendering weights ``[R, S]`` (nerfstudio's ``PDFSampler`` as the
    reference configures it). Without ``u`` the ``num_samples + 1`` new
    edges sit at bin centres of the CDF; with uniforms ``u [R, N+1]`` in
    [0, 1) they are stratified. Returns ``[R, N+1 (+ S+1)]`` sorted edges."""
    num_bins = num_samples + 1
    weights = weights + histogram_padding
    weights_sum = weights.sum(dim=-1, keepdim=True)
    padding = torch.clamp_min(1e-5 - weights_sum, 0.0)
    weights = weights + padding / weights.shape[-1]
    weights_sum = weights_sum + padding
    pdf = weights / weights_sum
    cdf = torch.cat(
        [torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1
    )
    cdf = torch.clamp_max(cdf, 1.0)

    dev, dt = pdf.device, pdf.dtype
    if u is not None:
        u = torch.arange(num_bins, device=dev, dtype=dt) / num_bins + u / num_bins
    else:
        u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, device=dev, dtype=dt)
        u = (u + 1.0 / (2 * num_bins))[None, :].expand(pdf.shape[0], num_bins)
    u = u.clamp(0.0, 1.0 - 1e-7).contiguous()

    last = cdf.shape[-1] - 1
    above = torch.searchsorted(cdf, u, right=True)  # first edge with cdf > u
    below = (above - 1).clamp_min(0)
    above = above.clamp_max(last)
    cdf_g0 = cdf.gather(1, below)
    cdf_g1 = cdf.gather(1, above)
    bins_g0 = spacing_bins.gather(1, below)
    bins_g1 = spacing_bins.gather(1, above)
    t = (u - cdf_g0) / torch.where(cdf_g1 == cdf_g0, 1.0, cdf_g1 - cdf_g0)
    new_bins = bins_g0 + t.clamp(0.0, 1.0) * (bins_g1 - bins_g0)
    if include_original:
        new_bins = torch.sort(torch.cat([new_bins, spacing_bins], dim=-1), dim=-1).values
    return new_bins
