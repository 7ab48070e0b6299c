"""Ray ops of the port; K1-K3 are CUDA kernels with PyTorch twins."""

from .fused import (
    biased_warp_range,
    endpoint_features,
    march_features,
    ray_bounds,
    sample_features,
)
from .march import FusedMarch, MarchStream, march
from .rendering import render_rgb_depth_acc, render_weights
from .sampling import pdf_sample, stratified_bins
from .traversal import hull_intersect

__all__ = [
    "FusedMarch",
    "MarchStream",
    "biased_warp_range",
    "endpoint_features",
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
