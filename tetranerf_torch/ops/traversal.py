"""Hull slab test and barycentric plane evaluation.

Counterpart of ``_eval_planes`` and ``hull_intersect`` in
:mod:`tetranerf_tpu.ops.traversal`.
"""

from __future__ import annotations

import torch

BARY_EPS = 1e-5


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
