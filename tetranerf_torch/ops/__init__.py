"""Ray ops and fused MLPs of the port; the kernels (K1-K5, ``csrc/``) have
PyTorch twins."""

from .fused import (
    biased_warp_range,
    endpoint_features,
    march_features,
    ray_bounds,
    sample_features,
)
from .march import FusedMarch, MarchStream, march
from .mlp import (
    FusedDensityMLP,
    FusedFieldMLPs,
    fused_density_mlp,
    fused_density_mlp_backward,
    fused_field_mlps,
    fused_field_mlps_backward,
)
from .rendering import render_rgb_depth_acc, render_weights
from .sampling import pdf_sample, stratified_bins
from .traversal import hull_intersect

__all__ = [
    "FusedDensityMLP",
    "FusedFieldMLPs",
    "FusedMarch",
    "MarchStream",
    "biased_warp_range",
    "endpoint_features",
    "fused_density_mlp",
    "fused_density_mlp_backward",
    "fused_field_mlps",
    "fused_field_mlps_backward",
    "hull_intersect",
    "march",
    "march_features",
    "pdf_sample",
    "ray_bounds",
    "render_rgb_depth_acc",
    "render_weights",
    "sample_features",
    "stratified_bins",
]
