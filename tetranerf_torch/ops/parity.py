"""The reference's auxiliary pipelines (counterpart of
:mod:`tetranerf_tpu.ops.parity`): :func:`find_tetrahedra` (point location,
``src/optix/optix_find_tetrahedra.cu``; here the walk K9 answers exactly),
:func:`trace_rays_triangles` (the face-crossing tracer,
``src/optix/optix_trace_rays_triangles.cu``; here derived from the march
K1: crossing 0 enters the first interval, crossing ``k + 1`` leaves
interval ``k``) and :func:`update_occupancy` (the per-cell EMA that the
reference's ``scatter_ema_uint32`` was built for). Ids the reference returns
as uint32 come back as int64, ``UINT_MAX`` padded."""

from __future__ import annotations

import torch

from .interpolation import _last_writes
from .traversal import UINT_MAX, eval_planes, locate_points, march

_FACE_VERTS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
"""The vertices of the face opposite vertex ``k``."""


def find_tetrahedra(mesh, points: torch.Tensor, num_steps: int = 64) -> dict:
    """Locate ``points f32[N, 3]`` (``py_binding.cpp:137-141``):
    ``tetrahedra i32[N]`` (-1 outside), ``barycentric_coordinates
    f32[N, 3]`` (vertices 1..3), ``vertex_indices int64[N, 4]``
    (``UINT_MAX`` outside) and ``valid_mask bool[N]``."""
    cells = locate_points(mesh, points, num_steps)
    valid = cells >= 0
    safe = cells.clamp_min(0).long()
    bary = torch.where(valid[:, None], eval_planes(mesh.planes[safe], points), 0.0)
    return {
        "tetrahedra": cells,
        "barycentric_coordinates": bary[:, 1:],
        "vertex_indices": torch.where(valid[:, None], mesh.cells[safe].long(), UINT_MAX),
        "valid_mask": valid,
    }


def _face_crossing(planes, cell_verts, valid, t_at, origins, directions, exit: bool):
    """The crossed face of each interval end: the (near-)zero barycentric
    among the faces the ray leaves (``exit``) or enters. Returns the face's
    vertex ids ``[R, S, 3]`` and its normalised weights ``[R, S, 3]``."""
    d = directions[:, None, :]
    p = origins[:, None, :] + torch.where(valid, t_at, 0.0)[..., None] * d
    bary = eval_planes(planes, p)  # [R, S, 4]
    den = (planes[..., 0] * d[..., None, 0] + planes[..., 1] * d[..., None, 1]
           + planes[..., 2] * d[..., None, 2])
    sign = -den if exit else den
    face = torch.where(sign > 0, bary.abs(), float("inf")).argmin(dim=-1)
    fv = torch.tensor(_FACE_VERTS, device=planes.device)[face]  # [R, S, 3]
    weights = bary.gather(-1, fv)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return cell_verts.gather(-1, fv), weights


def trace_rays_triangles(mesh, origins: torch.Tensor, directions: torch.Tensor,
                         max_hits: int = 512) -> dict:
    """Every face crossing along each ray, sorted by distance (JAX
    ``parity.trace_rays_triangles``): ``num_hits i32[R]``,
    ``hit_distances f32[R, H]`` (``+inf`` padded), ``vertex_indices
    int64[R, H, 3]`` (the crossed face's vertices, ``UINT_MAX`` padded) and
    ``barycentric_coordinates f32[R, H, 2]`` (weights of face vertices 1
    and 2; vertex 0's is ``1 - sum``)."""
    res = march(mesh, origins, directions, max_steps=max_hits - 1)
    valid = res.cells >= 0
    safe = res.cells.clamp_min(0).long()
    planes = mesh.planes[safe]  # [R, T, 4, 4]
    cell_verts = mesh.cells[safe].long()  # [R, T, 4]
    exit_verts, exit_w = _face_crossing(planes, cell_verts, valid, res.t1, origins,
                                        directions, True)
    entry_verts, entry_w = _face_crossing(planes[:, :1], cell_verts[:, :1], valid[:, :1],
                                          res.t0[:, :1], origins, directions, False)
    hit_valid = torch.cat([valid[:, :1], valid], dim=1)
    distances = torch.cat([res.t0[:, :1], res.t1], dim=1)
    verts = torch.cat([entry_verts, exit_verts], dim=1)
    weights = torch.cat([entry_w, exit_w], dim=1)
    return {
        "num_hits": hit_valid.sum(dim=-1, dtype=torch.int32),
        "hit_distances": torch.where(hit_valid, distances, float("inf")),
        "vertex_indices": torch.where(hit_valid[..., None], verts, UINT_MAX),
        "barycentric_coordinates": torch.where(hit_valid[..., None], weights, 0.0)[..., 1:],
    }


def update_occupancy(occupancy: torch.Tensor, cell_indices: torch.Tensor,
                     values: torch.Tensor, decay: float = 0.95) -> torch.Tensor:
    """``occupancy[c] = decay * occupancy[c] + (1 - decay) * value`` for each
    sampled cell, as a new tensor; negative cells are dropped, and a cell
    sampled more than once keeps one update (the last)."""
    ids = cell_indices.reshape(-1).to(torch.int64)
    vals = values.reshape(-1).to(occupancy.dtype)
    valid = (ids >= 0) & (ids < occupancy.shape[0])
    read = torch.where(valid, ids, 0)
    updated = decay * occupancy[read] + (1.0 - decay) * vals
    writes = _last_writes(ids, valid, occupancy.shape[0])
    out = occupancy.clone()
    out[ids[writes]] = updated[writes]
    return out
