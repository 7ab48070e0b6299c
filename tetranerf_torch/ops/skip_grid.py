"""Empty-space skipping: a voxel distance grid over the tetrahedra mesh.

Counterpart of :mod:`tetranerf_tpu.ops.skip_grid`. A ray pays one dependent
row read per crossed cell; in camera scenes most of a chord crosses big
empty cells between the hull and the first surface. The skip grid lets the
march (``ops/march.py``, K1's prologue) sphere-trace that empty prefix:

1. :func:`make_skip_setup`, once per mesh: the grid's geometry (the hull's
   bounding box with a half-voxel margin), each voxel centre's containing
   cell (the anchor, by the point-location walk K9 from a cell of the
   centre's nearest vertex; -1 outside the hull), and the voxels of each
   cell's vertices and centroid.
2. :func:`build_skip_table`, at each occupancy refresh: voxelise the
   occupancy EMA (anchor coverage, then the vertex and centroid voxels of
   each cell, by max), dilate by one voxel, threshold at ``skip_eps``, and
   take the Chebyshev distance ``d`` to the occupied voxels (capped at
   ``max_skip_voxels``). Column 0 is the safe advance ``max(d - 1, 0) *
   h_min``, column 1 the anchor (int32 bit-cast; the nearest vertex's cell
   where the centre lies outside the hull).

The host part is numpy in float64, as JAX's; the per-refresh table is
torch ops on the mesh's device, every one exact (a max is order-free, a
3-wide max-pool's ``-inf`` padding equals JAX's edge replication for a
max, the distances are small integers in f32), so the table is bit-equal
to JAX's. It runs once per refresh on ``G^3`` voxels and needs no kernel of
its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .march import locate_points

LOCATE_STEPS = 48


class SkipSetup(NamedTuple):
    """The grid's geometry-only precomputation, on the mesh's device."""

    anchors: torch.Tensor  # i32[G, G, G] cell holding the voxel centre (-1 outside the hull)
    loc_anchors: torch.Tensor  # i32[G, G, G] the anchor, else the nearest vertex's cell
    vert_vox: torch.Tensor  # i32[4C] flat voxel of each cell's 4 vertices
    cent_vox: torch.Tensor  # i32[C] flat voxel of each cell's centroid
    meta: torch.Tensor  # f32[8]: lo (3) | 1/h (3) | h_min | 0


def grid_geometry(vertices: np.ndarray, resolution: int):
    """Voxel grid ``lo``/``h`` covering the hull's bounding box with a
    half-voxel margin (so clamped indexing never maps an inside point to a
    voxel whose extent excludes it)."""
    v = np.asarray(vertices, np.float64)
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    h = span / (resolution - 1)  # half-voxel margin on both sides
    lo = lo - 0.5 * h
    return lo.astype(np.float32), h.astype(np.float32)


def _voxel_of(points: np.ndarray, lo, h, resolution: int) -> np.ndarray:
    ij = np.clip(
        ((np.asarray(points, np.float64) - lo) / h).astype(np.int64),
        0,
        resolution - 1,
    )
    g = resolution
    return (ij[..., 0] * g * g + ij[..., 1] * g + ij[..., 2]).astype(np.int32)


def voxel_centers_and_seeds(mesh, resolution: int):
    """The ``G^3`` voxel centres ``f32[G^3, 3]`` of :func:`grid_geometry`
    (x-major) and their walk seeds ``i32[G^3]``, a cell incident to each
    centre's nearest vertex (host kd-tree), as numpy arrays."""
    from scipy.spatial import cKDTree

    g = resolution
    vertices = mesh.vertices.cpu().numpy().astype(np.float64)
    lo, h = grid_geometry(vertices, g)
    axes = [lo[a] + (np.arange(g) + 0.5) * h[a] for a in range(3)]
    centers = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    _, nearest = cKDTree(vertices).query(centers, workers=-1)
    seeds = mesh.vertex_cells.cpu().numpy()[nearest].astype(np.int32)
    return centers.astype(np.float32), seeds


def make_skip_setup(mesh, resolution: int = 64) -> SkipSetup:
    """The one-time precomputation for ``mesh`` (a
    :class:`~..geometry.TorchMesh`): host kNN seeds, then the G^3 voxel
    centres point-located by K9 on the mesh's device (its twin on the
    CPU)."""
    g = resolution
    dev = mesh.device
    vertices = mesh.vertices.cpu().numpy().astype(np.float64)
    cells = mesh.cells.cpu().numpy()
    lo, h = grid_geometry(vertices, g)
    centers, seeds = voxel_centers_and_seeds(mesh, g)

    anchors = locate_points(
        mesh.march_table, torch.from_numpy(seeds).to(dev),
        torch.from_numpy(centers).to(dev), LOCATE_STEPS,
    ).cpu().numpy()
    loc_anchors = np.where(anchors >= 0, anchors, seeds).astype(np.int32)

    centroids = vertices[cells].mean(axis=1)
    vert_vox = _voxel_of(vertices[cells.reshape(-1)], lo, h, g)  # [4C]
    cent_vox = _voxel_of(centroids, lo, h, g)  # [C]

    meta = np.zeros(8, np.float32)
    meta[:3] = lo
    meta[3:6] = 1.0 / h
    meta[6] = float(h.min())
    return SkipSetup(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            anchors.reshape(g, g, g), loc_anchors.reshape(g, g, g), vert_vox,
            cent_vox, meta))
    )


def _max3d(x: torch.Tensor) -> torch.Tensor:
    """Max over each voxel's 3x3x3 neighbourhood inside the grid."""
    return F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]


def chebyshev_distance(occupied: torch.Tensor, max_dist: int) -> torch.Tensor:
    """Chebyshev (L-inf) voxel distance ``f32[G, G, G]`` to the occupied set,
    capped at ``max_dist``: ``max_dist`` rounds of a 3x3x3 min-pool, each
    moving the distance one voxel in every direction at once."""
    d = torch.where(occupied, 0.0, float(max_dist))
    for _ in range(max_dist):
        d = torch.minimum(d, -_max3d(-d) + 1.0)
    return d


def build_skip_table(
    occ: torch.Tensor,
    setup: SkipSetup,
    skip_eps: float = 1e-3,
    max_skip_voxels: int = 16,
) -> torch.Tensor:
    """The skip table ``f32[G, G, G, 8]`` of the occupancy EMA ``occ f32[C]``
    (on the setup's device): column 0 the safe advance ``rho`` (0 in or next
    to estimated density), column 1 the anchor cell (int32 bit-cast)."""
    g = setup.anchors.shape[0]
    occ = occ.to(torch.float32)
    # Conservative voxelisation: every voxel whose centre lies in a cell
    # takes its occupancy, and a cell smaller than a voxel also marks its
    # vertices' and centroid's voxels.
    anchors = setup.anchors.reshape(-1).long()
    grid = torch.where(anchors >= 0, occ[anchors.clamp_min(0)], 0.0)
    grid = grid.scatter_reduce(0, setup.vert_vox.long(), occ.repeat_interleave(4), "amax")
    grid = grid.scatter_reduce(0, setup.cent_vox.long(), occ, "amax")
    occupied = _max3d(grid.reshape(g, g, g)) > skip_eps  # one-voxel dilation

    d = chebyshev_distance(occupied, max_skip_voxels)
    rho = torch.clamp_min(d - 1.0, 0.0) * setup.meta[6]
    out = torch.zeros((g, g, g, 8), dtype=torch.float32, device=occ.device)
    out[..., 0] = rho
    out[..., 1] = setup.loc_anchors.view(torch.float32)
    return out
