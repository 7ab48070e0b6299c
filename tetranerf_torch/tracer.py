"""``TetrahedraTracer``: the reference's public tracer object
(``tetranerf/utils/extension/__init__.py:23-26``,
``src/py_binding.cpp:433-449``; JAX :mod:`tetranerf_tpu.tracer`) over the
port's mesh and ops. ``load_tetrahedra`` builds the mesh tables on the
tracer's device; the traversal runs the march K1 and the point walk K9 on
a CUDA device::

    tracer = TetrahedraTracer()          # "cuda"; TetrahedraTracer("cpu")
    tracer.load_tetrahedra(vertices, cells)
    out = tracer.trace_rays(origins, directions, 512)
    matched = tracer.find_visited_cells(
        out["num_visited_cells"], out["visited_cells"],
        out["barycentric_coordinates"], out["hit_distances"],
        out["vertex_indices"], distances)

Inputs may be numpy arrays or tensors; outputs are tensors on the
tracer's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .geometry.mesh import TorchMesh, build_mesh
from .ops.matching import find_visited_cells as _find_visited_cells
from .ops.parity import find_tetrahedra as _find_tetrahedra
from .ops.parity import trace_rays_triangles as _trace_rays_triangles
from .ops.traversal import trace_rays as _trace_rays


class TetrahedraTracer:
    """Object-style tracer API (reference parity) on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.mesh: Optional[TorchMesh] = None

    def load_tetrahedra(self, vertices, cells) -> None:
        """Build the traversal tables (the reference's GAS build,
        ``py_binding.cpp:144-161``) on the tracer's device."""
        self.mesh = build_mesh(np.asarray(vertices, np.float64),
                               np.asarray(cells, np.int32), device=self.device)

    def _require_mesh(self) -> TorchMesh:
        if self.mesh is None:
            raise RuntimeError("call load_tetrahedra first")
        return self.mesh

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _rays(self, origins, directions):
        return self._tensor(origins).contiguous(), self._tensor(directions).contiguous()

    def trace_rays(self, origins, directions, max_visited_cells: int = 512) -> dict:
        """The reference's traversal dict (``py_binding.cpp:53-76``; see
        :func:`~.ops.traversal.trace_rays`); ``max_visited_cells`` need not
        be a power of two."""
        return _trace_rays(self._require_mesh(), *self._rays(origins, directions),
                           max_visited_cells)

    def find_visited_cells(self, num_visited_cells, visited_cells, barycentric_coordinates,
                           hit_distances, vertex_indices, distances) -> dict:
        """Match sample ``distances`` to :meth:`trace_rays`' intervals (see
        :func:`~.ops.matching.find_visited_cells`)."""
        ids = torch.int64
        return _find_visited_cells(
            self._tensor(num_visited_cells, ids), self._tensor(visited_cells, ids),
            self._tensor(barycentric_coordinates), self._tensor(hit_distances),
            self._tensor(vertex_indices, ids), self._tensor(distances))

    def find_tetrahedra(self, positions) -> dict:
        """The cell of each point and its barycentrics (see
        :func:`~.ops.parity.find_tetrahedra`)."""
        return _find_tetrahedra(self._require_mesh(), self._tensor(positions).contiguous())

    def trace_rays_triangles(self, origins, directions, max_hits: int = 512) -> dict:
        """Every face crossing along each ray (see
        :func:`~.ops.parity.trace_rays_triangles`)."""
        return _trace_rays_triangles(self._require_mesh(), *self._rays(origins, directions),
                                     max_hits)
