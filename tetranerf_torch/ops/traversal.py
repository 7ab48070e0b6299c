"""Hull slab test, barycentric plane evaluation, and the tracer's
traversal: ``march``, ``trace_rays`` and ``locate_points``.

Counterpart of :mod:`tetranerf_tpu.ops.traversal`. The JAX module's march
is its own ``lax.scan`` over the unpacked tables; here :func:`march` is
the port's neighbour march (kernel K1 on CUDA tensors, ``ops/march.py``,
which gives the cells of JAX's ``traversal.march`` bit for bit for rays
that start outside the hull) without occupancy or skip grid, followed by
JAX's near-plane shift: intervals entered before ``near`` are dropped, the
rest move to the front. :func:`locate_points` is JAX's hull test and seed
with the walk run by kernel K9.

Ids that the reference returns as uint32 come back as int64 tensors, the
padding ``UINT_MAX`` = 0xFFFFFFFF (JAX's uint32 values, widened).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BARY_EPS = 1e-5
UINT_MAX = 0xFFFFFFFF
"""The reference's padding of ``visited_cells`` / ``vertex_indices``
(``optix_trace_rays.cu:260-265``), held in int64 tensors."""


class MarchResult(NamedTuple):
    """Sorted traversal intervals of a batch of rays: interval ``k`` of ray
    ``r`` covers ``[t0[r, k], t1[r, k]]`` in cell ``cells[r, k]``; the
    first ``num_cells[r]`` slots are valid, the rest hold ``cells = -1``
    and ``t0 = t1 = +inf``."""

    cells: torch.Tensor  # i32[R, T]
    t0: torch.Tensor  # f32[R, T]
    t1: torch.Tensor  # f32[R, T]
    num_cells: torch.Tensor  # i32[R]


def eval_planes(planes: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Barycentrics ``[..., 4]`` of ``points [..., 3]`` from plane rows
    ``[..., 4, 4]``: ``((nx*x + ny*y) + nz*z) + d``, every product and sum
    rounded on its own, in the order of the march kernel."""
    x = points[..., None, 0]
    y = points[..., None, 1]
    z = points[..., None, 2]
    return (
        planes[..., 0] * x + planes[..., 1] * y + planes[..., 2] * z
    ) + planes[..., 3]


def hull_intersect(hull_eqs: torch.Tensor, origins, directions):
    """Slab test of rays against the convex hull's half-spaces.

    Returns ``(t_in, t_out, entry_facet, hit)``; ``t_in`` is negative for
    origins inside the hull and ``entry_facet`` indexes ``hull_eqs``.
    The ``[R, H]`` products run in full f32: near-tangent facets need it,
    so TF32 must be off for float32 matmuls."""
    if origins.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "hull_intersect needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    n = hull_eqs[:, :3]
    d = hull_eqs[:, 3]
    num = torch.matmul(origins, n.T) + d
    den = torch.matmul(directions, n.T)
    # Python-scalar infinities: a 0-d tensor built from one would be copied
    # from the host, which synchronises the stream.
    inf = float("inf")
    t_hit = -num / torch.where(den == 0.0, inf, den)
    lower = torch.where(den < 0.0, t_hit, -inf)
    upper = torch.where(den > 0.0, t_hit, inf)
    parallel_miss = torch.any((den == 0.0) & (num > 0.0), dim=-1)
    t_in, entry_facet = torch.max(lower, dim=-1)
    t_out = torch.amin(upper, dim=-1)
    hit = (t_in <= t_out) & ~parallel_miss & (t_out > 0.0)
    return t_in, t_out, entry_facet.to(torch.int32), hit


def locate_points(mesh, points: torch.Tensor, num_steps: int = 64) -> torch.Tensor:
    """The cell holding each point ``f32[N, 3]``, or -1 (JAX
    ``locate_points``): points outside the hull get -1; the others walk
    (K9 on CUDA tensors) from the cell of the hull facet their +x ray
    leaves through, and a walk that ends outside its cell gives -1."""
    from .march import locate_points as walk

    points = points.contiguous()
    normals = mesh.hull_eqs[:, :3]
    evals = torch.matmul(points, normals.T) + mesh.hull_eqs[:, 3]
    inside_hull = evals.amax(dim=-1) <= BARY_EPS
    # The +x ray's exit facet: its direction's products with the normals
    # are the normals' x components.
    den = normals[:, 0].expand_as(evals)
    t_hit = -evals / torch.where(den == 0.0, float("inf"), den)
    exit_facet = torch.where(den > 0.0, t_hit, float("inf")).argmin(dim=-1)
    seeds = torch.where(inside_hull, mesh.hull_cells[exit_facet], -1).to(torch.int32)
    cell = walk(mesh.march_table, seeds.contiguous(), points, num_steps)
    b = eval_planes(mesh.planes[cell.clamp_min(0).long()], points)
    contained = (b.amin(dim=-1) >= -BARY_EPS) & (cell >= 0)
    return torch.where(contained, cell, -1)


def march(mesh, origins: torch.Tensor, directions: torch.Tensor, max_steps: int = 512,
          near: float = 0.0, entry_walk_steps: int = 16) -> MarchResult:
    """Sorted traversal intervals of rays ``[R, 3]`` through ``mesh`` (JAX
    ``traversal.march``): the neighbour march (K1 on CUDA tensors), then
    the intervals entered before ``near`` dropped and the rest shifted to
    the front, as the reference never reports the origin's own partial
    cell."""
    from .march import march as neighbour_march

    res = neighbour_march(mesh, origins, directions, max_steps, entry_walk_steps)
    cells, t0s, t1s = res.cells, res.t0, res.t1
    valid = cells >= 0
    # Valid intervals are a prefix with increasing t0: a per-ray shift.
    drop = (valid & (t0s < near)).sum(dim=-1, keepdim=True)
    idx = torch.arange(max_steps, device=cells.device)[None, :] + drop
    in_range = idx < max_steps
    idx = idx.clamp_max(max_steps - 1)
    inf = float("inf")
    cells = torch.where(in_range, cells.gather(1, idx), -1)
    t0s = torch.where(in_range, t0s.gather(1, idx), inf)
    t1s = torch.where(in_range, t1s.gather(1, idx), inf)
    valid = cells >= 0
    t0s = torch.where(valid, t0s, inf)
    return MarchResult(cells=cells, t0=t0s, t1=t1s,
                       num_cells=valid.sum(dim=-1, dtype=torch.int32))


def trace_rays(mesh, origins: torch.Tensor, directions: torch.Tensor,
               max_visited_cells: int = 512, near: float = 0.0) -> dict:
    """The reference's ``trace_rays`` dict (``src/py_binding.cpp:53-76``,
    JAX ``traversal.trace_rays``) from :func:`march`:

    - ``num_visited_cells`` i32[R];
    - ``visited_cells`` int64[R, T], ``UINT_MAX`` padded;
    - ``barycentric_coordinates`` f32[R, T, 2, 3]: the entry and exit
      weights of vertices 1..3 (vertex 0's is 1 - sum);
    - ``hit_distances`` f32[R, T, 2] (0 where padded);
    - ``vertex_indices`` int64[R, T, 4], ``UINT_MAX`` padded.

    ``max_visited_cells`` need not be a power of two."""
    res = march(mesh, origins, directions, max_visited_cells, near)
    valid = res.cells >= 0
    c_safe = res.cells.clamp_min(0).long()
    planes = mesh.planes[c_safe]  # [R, T, 4, 4]
    t0 = torch.where(valid, res.t0, 0.0)
    t1 = torch.where(valid, res.t1, 0.0)
    o, d = origins[:, None, :], directions[:, None, :]
    bary = torch.stack([eval_planes(planes, o + t[..., None] * d)[..., 1:]
                        for t in (t0, t1)], dim=-2)  # [R, T, 2, 3]
    return {
        "num_visited_cells": res.num_cells,
        "visited_cells": torch.where(valid, res.cells.long(), UINT_MAX),
        "barycentric_coordinates": torch.where(valid[..., None, None], bary, 0.0),
        "hit_distances": torch.stack([t0, t1], dim=-1),
        "vertex_indices": torch.where(valid[..., None], mesh.cells[c_safe].long(), UINT_MAX),
    }
