"""Model configuration: a field-for-field mirror of
:class:`tetranerf_tpu.models.config.TetrahedraNerfConfig` (same names and
defaults, so a config moves between the packages with ``dataclasses.asdict``),
plus the ``tetra-nerf`` preset of :mod:`tetranerf_tpu.training.presets`.

Knobs of the JAX package that tune its TPU lowering are accepted here:

- ``march_compaction`` / ``march_compact_ratio``: no-ops. The compaction
  cascade is bit-identical to an uncompacted march; the CUDA march runs one
  thread per ray and each thread stops at its own ray's end instead.
- ``traversal_hops``: 1 or 2, the same march. Two hops fetch a cell's row
  with its neighbours' from a two-hop table, and give outputs bit-identical
  to one hop; the CUDA march reads one row per step at either setting and
  needs no two-hop table (a mesh built with one wraps unchanged). Any other
  value raises ``ValueError``: the JAX march does not check it, divides by
  zero at 0 and marches another function at the other values.
- ``remat_mlps``: no-op. The train step keeps the MLP activations for
  its backward instead of recomputing them: autograd keeps 2.73 GB for a
  step of 4096 rays x 257 samples at the preset's widths, about 2.6 KB
  per (ray, sample) (``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at
  700 W). The render path keeps none. With ``fused_mlps`` the fused
  kernels recompute them in their backward instead, as JAX's do.

``fused_mlps=True`` runs the MLP stack as the fused CUDA kernels of
``ops/mlp.py`` (without a Fourier input encoding, as in JAX). On the card
they compute in bfloat16 only: ``compute_dtype="float32"`` with
``fused_mlps`` raises ``NotImplementedError`` for CUDA tensors (its CPU
twins run at either dtype).
- ``interp_mode``: no-op. ``"matmul"``, ``"pallas"`` and ``"gather"``
  compute one function; the port always runs the sample-interp kernel.

``ray_buckets >= 2`` shades rays in quantile buckets of their crossing
count, each at its own bound (``TetraNerf.get_outputs``); the buckets are
cut from one march with the row-gather kernel K8. ``bucket_merge_mlps``
runs the MLPs of all buckets as one call per round (2 MLP chains a step in
place of 2 per bucket), as JAX does; with ``fused_mlps`` it is ignored, as
in JAX.

``skip_grid_resolution > 0`` builds the empty-space skip grid at each
occupancy refresh (``Trainer._rebuild_skip_grid``, ``ops/skip_grid.py``),
and every march with occupancy termination sphere-traces through it first,
as in JAX.

Settings whose code is not ported yet are refused by
:func:`check_supported` with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Literal, Optional, Union


@dataclasses.dataclass
class TetrahedraNerfConfig:
    tetrahedra_path: Optional[Path] = None
    num_tetrahedra_vertices: Optional[int] = None
    num_tetrahedra_cells: Optional[int] = None

    max_intersected_triangles: int = 512
    """March step bound per ray."""
    num_samples: int = 256
    num_fine_samples: int = 256
    use_biased_sampler: bool = False
    field_dim: int = 64

    num_color_layers: int = 1
    num_density_layers: int = 3
    hidden_size: int = 128

    input_fourier_frequencies: int = 0

    initialize_colors: bool = True

    use_gradient_scaling: bool = False
    """Radiance-field gradient scaling; the identity in the forward."""
    background_color: Literal["random", "last_sample", "black", "white"] = "white"

    appearance_embed_dim: int = 0

    use_occupancy_field: bool = False
    """Stop a ray once ``sum(occupancy[cell] * chord)`` passes the depth
    cap ``-log(occupancy_threshold)`` (column 24 of the march rows)."""
    occupancy_update_every: int = 16
    occupancy_refresh_every: int = 64
    occupancy_threshold: float = 1e-3
    occupancy_decay: float = 0.95
    occupancy_retune_every: int = 256
    skip_grid_resolution: int = 0
    skip_grid_eps: float = 1e-3
    occupancy_retune_mode: Literal["transmittance", "march"] = "transmittance"
    occupancy_retune_percentile: float = 100.0
    occ_cap_margin: float = 1.2
    occ_cap_percentile: float = 99.9

    compute_dtype: str = "bfloat16"
    """MLP operand dtype; parameters and the last layer's output stay f32."""
    interp_mode: str = "matmul"
    remat_mlps: Union[bool, Literal["auto"]] = "auto"
    fused_mlps: bool = False
    ray_buckets: int = 1
    bucket_short_steps: Optional[int] = None
    bucket_bound_margin: float = 1.15
    bucket_merge_mlps: bool = False
    bucket_adaptive_samples: bool = True
    traversal_hops: int = 1
    march_compaction: int = 4
    march_compact_ratio: float = 0.7
    grad_stream_budget_per_ray: Optional[int] = None
    field_stream_dtype: str = "float32"
    far_plane: float = 1e3
    """Depth reported for rays that hit nothing."""
    depth_method: Literal["median", "expected"] = "median"


def check_supported(config: TetrahedraNerfConfig) -> None:
    """Refuse settings whose code the port does not have yet."""
    refused = {
        "grad_stream_budget_per_ray": config.grad_stream_budget_per_ray
        is not None,
        "field_stream_dtype='bfloat16'": config.field_stream_dtype
        not in (None, "float32"),
    }
    missing = [name for name, hit in refused.items() if hit]
    if missing:
        raise NotImplementedError(
            "not ported to tetranerf_torch yet: " + ", ".join(missing)
        )
    if config.traversal_hops not in (1, 2):
        raise ValueError(f"traversal_hops must be 1 or 2, got {config.traversal_hops!r}")
    if config.interp_mode not in ("matmul", "pallas", "gather"):
        raise ValueError(f"unknown interp_mode {config.interp_mode!r}")


def tetranerf_preset(**overrides) -> TetrahedraNerfConfig:
    """The model part of the ``tetra-nerf`` preset
    (``tetranerf_tpu.training.presets.tetranerf_preset``): 128 biased +
    128 PDF samples, gradient scaling, occupancy termination at 1e-4 with
    the transmittance retune every 128 steps, and shading in 8 quantile
    buckets with adaptive sample budgets."""
    cfg = TetrahedraNerfConfig(
        num_samples=128,
        num_fine_samples=128,
        use_biased_sampler=True,
        use_gradient_scaling=True,
        use_occupancy_field=True,
        occupancy_retune_percentile=100.0,
        occupancy_threshold=1e-4,
        occupancy_retune_every=128,
        ray_buckets=8,
    )
    return dataclasses.replace(cfg, **overrides)
