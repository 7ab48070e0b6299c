"""Volume rendering: weights and RGB / accumulation / depth.

Counterpart of :mod:`tetranerf_tpu.ops.rendering` (nerfstudio's
``get_weights`` and its RGB, accumulation and depth renderers).
"""

from __future__ import annotations

from typing import Optional

import torch


def render_weights(densities, deltas):
    """``w_i = (1 - exp(-sigma_i delta_i)) * exp(-sum_{j<i} sigma_j delta_j)``."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    shifted = torch.cat(
        [torch.zeros_like(delta_density[..., :1]), delta_density[..., :-1]],
        dim=-1,
    )
    return alphas * torch.exp(-torch.cumsum(shifted, dim=-1))


def accumulate_along_rays(weights, values=None):
    """Per-ray sums over samples: ``weights [..., S]`` alone gives
    ``[...]``; with ``values [..., S, C]`` the weighted sums ``[..., C]``."""
    if values is None:
        return weights.sum(dim=-1)
    return torch.einsum("...s,...sc->...c", weights, values)


def render_rgb_depth_acc(
    weights,
    rgb,
    distances,
    background_rgb: Optional[torch.Tensor] = None,
    depth_method: str = "median",
):
    """Composite per-sample colours ``[R, S, 3]`` into per-ray RGB ``[R, 3]``,
    accumulation ``[R]`` and depth ``[R]``. ``"median"`` depth is the
    distance where the accumulated weight crosses 0.5; ``"expected"`` the
    weighted mean."""
    acc = accumulate_along_rays(weights)
    out_rgb = accumulate_along_rays(weights, rgb)
    if background_rgb is not None:
        out_rgb = out_rgb + (1.0 - acc[..., None]) * background_rgb
    if depth_method == "median":
        cum = torch.cumsum(weights, dim=-1)
        idx = (cum < 0.5).sum(dim=-1, keepdim=True)
        idx = idx.clamp(0, distances.shape[-1] - 1)
        depth = distances.gather(-1, idx)[..., 0]
    elif depth_method == "expected":
        depth = (weights * distances).sum(dim=-1) / torch.clamp_min(acc, 1e-10)
        depth = torch.minimum(
            torch.maximum(depth, distances.amin(dim=-1)), distances.amax(dim=-1)
        )
    else:
        raise ValueError(f"unknown depth method {depth_method!r}")
    return out_rgb, acc, depth
