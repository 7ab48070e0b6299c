"""Ray ops, fused MLPs and the skip grid of the port; the kernels (K1-K9,
``csrc/``) have PyTorch twins. The tracer's ops (``trace_rays``,
``find_visited_cells``, ``find_tetrahedra``, ``trace_rays_triangles``,
interpolation and barycentrics) are the reference's API over them; the
tracer's own ``march`` and ``locate_points`` are in :mod:`.traversal` (the
names here are the neighbour march K1 and the walk K9)."""

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
from .barycentric import add_barycentrics_grad, barycentric_coordinates
from .encoding import nerf_encoding
from .gather import row_gather, row_gather_batch
from .interpolation import gather_uint32, interpolate_values, scatter_ema_uint32
from .march import FusedMarch, MarchStream, locate_points, march
from .matching import find_visited_cells, match_samples
from .mlp import (
    FusedDensityMLP,
    FusedFieldMLPs,
    fused_density_mlp,
    fused_density_mlp_backward,
    fused_field_mlps,
    fused_field_mlps_backward,
)
from .parity import find_tetrahedra, trace_rays_triangles, update_occupancy
from .rendering import accumulate_along_rays, render_rgb_depth_acc, render_weights
from .sampling import biased_warp, pdf_sample, stratified_bins, uniform_sample
from .skip_grid import SkipSetup, build_skip_table, make_skip_setup
from .traversal import UINT_MAX, MarchResult, hull_intersect, trace_rays

__all__ = [
    "FusedDensityMLP",
    "FusedFieldMLPs",
    "FusedMarch",
    "MarchResult",
    "MarchStream",
    "SkipSetup",
    "UINT_MAX",
    "accumulate_along_rays",
    "add_barycentrics_grad",
    "barycentric_coordinates",
    "biased_warp",
    "biased_warp_range",
    "build_skip_table",
    "endpoint_features",
    "endpoint_features_batch",
    "find_tetrahedra",
    "find_visited_cells",
    "fused_density_mlp",
    "fused_density_mlp_backward",
    "fused_field_mlps",
    "fused_field_mlps_backward",
    "gather_uint32",
    "hull_intersect",
    "interpolate_values",
    "locate_points",
    "make_skip_setup",
    "march",
    "march_features",
    "match_samples",
    "nerf_encoding",
    "pdf_sample",
    "ray_bounds",
    "render_rgb_depth_acc",
    "render_weights",
    "row_gather",
    "row_gather_batch",
    "sample_features",
    "scatter_ema_uint32",
    "slice_march",
    "slice_march_buckets",
    "stratified_bins",
    "trace_rays",
    "trace_rays_triangles",
    "uniform_sample",
    "update_occupancy",
]
