"""Delaunay tetrahedralization of a point cloud (host side, scipy Qhull).

Counterpart of :func:`tetranerf_tpu.geometry.delaunay.triangulate`, with the
same Qhull options so both packages build the same complex.
"""

from __future__ import annotations

import numpy as np


def triangulate(points: np.ndarray) -> np.ndarray:
    """``[V, 3]`` points -> ``[C, 4]`` int32 cells of every finite tetrahedron.

    Degenerate (zero-volume) simplices are kept: dropping one would turn
    its neighbours' shared faces into fake boundary and stop rays
    mid-interior. :func:`..mesh.compute_planes` regularizes them.
    """
    from scipy.spatial import Delaunay  # deferred: scipy import is slow

    points = np.ascontiguousarray(points, dtype=np.float64)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [V, 3], got {points.shape}")
    if len(points) < 4:
        raise ValueError("need at least 4 points to tetrahedralize")
    tri = Delaunay(points, qhull_options="Qbb Qc Qz Q12")
    cells = tri.simplices.astype(np.int32)
    cells = cells[(cells < len(points)).all(axis=1)]
    return np.ascontiguousarray(cells)


def find_average_spacing(points: np.ndarray, num_neighbors: int = 6) -> float:
    """Mean distance from each point to its ``num_neighbors`` nearest other
    points, averaged over the points (the contract of CGAL's
    ``compute_average_spacing``, reference ``src/triangulation.cpp:121-134``).

    The KD-tree path of :func:`tetranerf_tpu.geometry.delaunay.
    find_average_spacing`; the JAX package's optional native library is not
    used."""
    from scipy.spatial import cKDTree

    points = np.ascontiguousarray(points, dtype=np.float64)
    tree = cKDTree(points)
    k = min(num_neighbors + 1, len(points))
    dists, _ = tree.query(points, k=k)
    return float(dists[:, 1:].mean())
