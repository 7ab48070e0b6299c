"""Ray ops and fused MLPs of the port; the kernels (K1-K8, ``csrc/``) have
PyTorch twins."""

from .fused import (
    biased_warp_range,
    endpoint_features,
    endpoint_features_batch,
    march_features,
    ray_bounds,
    sample_features,
    slice_march,
    slice_march_buckets,
)
from .gather import row_gather, row_gather_batch
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
    "endpoint_features_batch",
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
    "row_gather",
    "row_gather_batch",
    "sample_features",
    "slice_march",
    "slice_march_buckets",
    "stratified_bins",
]
