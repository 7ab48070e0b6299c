"""Sample-to-cell matching: counterpart of :mod:`tetranerf_tpu.ops.matching`
(the reference's ``find_matched_cells_kernel``,
``src/tetrahedra_tracer.cu:115-193``). A per-ray two-pointer sweep of
sorted intervals against sorted sample distances is a ``searchsorted`` of
the distances in the interval exits plus an in-interval test; JAX counts
``t1 <= d`` with a compare-sum, a TPU workaround with the same result."""

from __future__ import annotations

import torch

from .traversal import UINT_MAX, MarchResult, eval_planes


def match_samples(mesh, res: MarchResult, distances: torch.Tensor, origins: torch.Tensor,
                  directions: torch.Tensor) -> dict:
    """Match sorted sample distances ``f32[R, S]`` to the intervals of
    ``res`` (:func:`~.traversal.march`). Returns ``cell_indices i32[R, S]``
    and ``vertex_indices i32[R, S, 4]`` (-1 where unmatched), ``mask
    bool[R, S]`` and the four barycentric weights ``f32[R, S, 4]`` from
    the plane table (0 where unmatched)."""
    distances = distances.contiguous()
    max_t = res.cells.shape[1]
    k = torch.searchsorted(res.t1.contiguous(), distances, right=True)
    k_c = k.clamp_max(max_t - 1)
    cell = res.cells.gather(1, k_c)
    t0k = res.t0.gather(1, k_c)
    mask = (k < res.num_cells[:, None]) & (distances >= t0k) & (cell >= 0)
    c_safe = cell.clamp_min(0).long()
    points = origins[:, None, :] + distances[..., None] * directions[:, None, :]
    bary = eval_planes(mesh.planes[c_safe], points)
    return {
        "cell_indices": torch.where(mask, cell, -1),
        "vertex_indices": torch.where(mask[..., None], mesh.cells[c_safe], -1),
        "mask": mask,
        "barycentric": torch.where(mask[..., None], bary, 0.0),
    }


def find_visited_cells(num_visited_cells, visited_cells, barycentric_coordinates,
                       hit_distances, vertex_indices, distances) -> dict:
    """The reference's ``find_visited_cells`` (``src/py_binding.cpp:163-216``,
    JAX ``matching.find_visited_cells``) on :func:`~.traversal.trace_rays`'
    outputs, no mesh needed: each sample at ``distances f32[R, S]`` takes
    its interval's cell and vertex ids, and barycentrics lerped between the
    interval's entry and exit weights by ``(d - t0) / (t1 - t0)``.

    Returns ``cell_indices [R, S]`` and ``vertex_indices [R, S, 4]`` in the
    ids' dtype (int64 from ``trace_rays``), ``UINT_MAX`` where unmatched,
    ``mask bool[R, S]`` and ``barycentric_coordinates f32[R, S, 3]``."""
    distances = distances.contiguous()
    t0, t1 = hit_distances[..., 0], hit_distances[..., 1]
    num = num_visited_cells.to(torch.int64)
    max_t = t1.shape[1]
    slots = torch.arange(max_t, device=t1.device)[None, :]
    t1_sorted = torch.where(slots < num[:, None], t1, float("inf")).contiguous()
    k = torch.searchsorted(t1_sorted, distances, right=True)
    k_c = k.clamp_max(max_t - 1)
    t0k, t1k = t0.gather(1, k_c), t1.gather(1, k_c)
    mask = (k < num[:, None]) & (distances >= t0k)
    frac = ((distances - t0k) / (t1k - t0k).clamp_min(1e-20)).clamp(0.0, 1.0)[..., None]
    idx = k_c[..., None].expand(-1, -1, 3)
    b_entry = barycentric_coordinates[..., 0, :].gather(1, idx)
    b_exit = barycentric_coordinates[..., 1, :].gather(1, idx)
    bary = b_entry + frac * (b_exit - b_entry)
    cells = visited_cells.gather(1, k_c)
    verts = vertex_indices.gather(1, k_c[..., None].expand(-1, -1, vertex_indices.shape[-1]))
    return {
        "cell_indices": torch.where(mask, cells, UINT_MAX),
        "vertex_indices": torch.where(mask[..., None], verts, UINT_MAX),
        "mask": mask,
        "barycentric_coordinates": torch.where(mask[..., None], bary, 0.0),
    }
