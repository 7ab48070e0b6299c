"""Barycentric coordinates, differentiable: counterpart of
:mod:`tetranerf_tpu.ops.barycentric`. The reference injects analytic
gradients through a custom autograd function
(``tetranerf/utils/extension/__init__.py:45-68``); here the solve itself is
differentiable, and :func:`add_barycentrics_grad` keeps the reference's
API as an identity whose gradient flows to the vertices and points."""

from __future__ import annotations

import torch


def barycentric_coordinates(vertices: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The weights ``[..., 3]`` of vertices 1..3 (vertex 0's is ``1 - sum``)
    of ``points [..., 3]`` in tetrahedra ``vertices [..., 4, 3]``: the
    reference's edge-matrix solve ``T = (v1-v0, v2-v0, v3-v0)``,
    ``w = T^-1 (p - v0)``."""
    v0 = vertices[..., 0, :]
    edges = (vertices[..., 1:, :] - v0[..., None, :]).transpose(-1, -2)
    return torch.linalg.solve(edges, (points - v0)[..., None])[..., 0]


def add_barycentrics_grad(barycentrics: torch.Tensor, vertices: torch.Tensor,
                          points: torch.Tensor) -> torch.Tensor:
    """``barycentrics`` as they are, with the gradient of
    :func:`barycentric_coordinates` to ``vertices`` and ``points``."""
    recomputed = barycentric_coordinates(vertices, points)
    return recomputed + (barycentrics - recomputed).detach()
