"""Tetrahedral mesh tables: host-side builder and the device-side holder.

Counterpart of :mod:`tetranerf_tpu.geometry.mesh` (``build_mesh``,
``build_adjacency``, ``compute_planes``, ``_check_watertight``), numpy path
only. The JAX module registers a pytree with ``jax.tree_util`` when it is
imported, so it cannot be imported where JAX is absent; this copy keeps
the same arithmetic and a test pins its tables bit for bit to the JAX
builder's.

The hot table is ``march_table f32[C, 64]``, one row per cell:

- columns 0-15: the barycentric plane rows ``(nx, ny, nz, d)`` of the
  cell's four faces, ``bary_k(x) = n_k . x + d_k``;
- columns 16-19: neighbour cell ids across the face opposite vertex ``k``
  (-1 on the boundary), int32 bit-cast into the float column;
- columns 20-23: the cell's vertex ids, int32 bit-cast;
- column 24: the per-cell occupancy density (:meth:`TorchMesh.with_occupancy`);
- columns 25-63: zero padding (a row is 256 bytes).

Beside it the empty-space skip grid ``skip_table f32[G, G, G, 8]`` and its
geometry ``skip_meta f32[8]`` (:mod:`..ops.skip_grid`), zero-size while the
grid is off.

The bit-cast ids are float denormals: read them only through an int view
(``Tensor.view(torch.int32)`` or ``__float_as_int``), never through float
arithmetic, which may flush them to zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

MARCH_ROW = 64
OCC_COLUMN = 24


@dataclasses.dataclass(frozen=True)
class TorchMesh:
    """Mesh tables as tensors on one device.

    Attributes:
        vertices: ``f32[V, 3]`` vertex positions.
        cells: ``i32[C, 4]`` vertex ids per tetrahedron.
        neighbors: ``i32[C, 4]`` cell across the face opposite vertex ``k``.
        planes: ``f32[C, 4, 4]`` barycentric plane rows.
        hull_eqs: ``f32[H, 4]`` outward convex-hull half-spaces
            (``n . x + d <= 0`` inside).
        hull_cells: ``i32[H]`` a cell incident to each hull facet.
        vertex_cells: ``i32[V]`` some cell incident to each vertex.
        march_table: ``f32[C, 64]`` packed per-cell march row (module doc).
        skip_table: ``f32[G, G, G, 8]`` empty-space skip grid: column 0 the
            safe sphere-trace advance, column 1 the voxel's anchor cell
            (int32 bit-cast); ``f32[0, 0, 0, 8]`` while the grid is off.
        skip_meta: ``f32[8]`` the grid's geometry: ``lo`` (3) | ``1/h`` (3)
            | ``h_min`` | 0.
    """

    vertices: torch.Tensor
    cells: torch.Tensor
    neighbors: torch.Tensor
    planes: torch.Tensor
    hull_eqs: torch.Tensor
    hull_cells: torch.Tensor
    vertex_cells: torch.Tensor
    march_table: torch.Tensor
    skip_table: torch.Tensor
    skip_meta: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def device(self) -> torch.device:
        return self.march_table.device

    def to(self, device) -> "TorchMesh":
        """The same tables on ``device``."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            },
        )

    def with_occupancy(self, occupancy) -> "TorchMesh":
        """New mesh whose march rows carry ``occupancy f32[C]`` in column 24.

        The march accumulates ``occupancy[cell] * chord`` and stops a ray
        once that optical depth passes its cap. The caller's mesh is left
        as it was (the table is copied)."""
        occ = torch.as_tensor(occupancy, dtype=torch.float32)
        if occ.shape != (self.num_cells,):
            raise ValueError(
                f"occupancy must be [{self.num_cells}], got {tuple(occ.shape)}"
            )
        table = self.march_table.clone()
        table[:, OCC_COLUMN] = occ.to(table.device)
        return dataclasses.replace(self, march_table=table)

    @property
    def has_skip_grid(self) -> bool:
        return self.skip_table.numel() > 0

    def with_skip_grid(self, table, meta) -> "TorchMesh":
        """New mesh carrying the skip grid ``table f32[G, G, G, 8]`` and
        ``meta f32[8]`` (:func:`..ops.skip_grid.build_skip_table`; JAX
        ``attach_skip_grid``). The caller's mesh is left as it was."""
        dev = self.device
        return dataclasses.replace(
            self,
            skip_table=torch.as_tensor(table, dtype=torch.float32).to(dev).contiguous(),
            skip_meta=torch.as_tensor(meta, dtype=torch.float32).to(dev).contiguous(),
        )

    @classmethod
    def from_tables(cls, tables, device="cuda") -> "TorchMesh":
        """Wrap numpy tables with the attribute names above, e.g. a mesh
        built by :func:`tetranerf_tpu.geometry.build_mesh`; its skip grid
        is wrapped as it is (zero-size where the source has none)."""
        off = _no_skip_grid()
        return cls(
            **{
                f.name: torch.from_numpy(np.array(
                    getattr(tables, f.name, off.get(f.name))
                )).to(device)
                for f in dataclasses.fields(cls)
            }
        )


def _no_skip_grid() -> dict:
    """The zero-size skip grid of a mesh without one."""
    return {"skip_table": np.zeros((0, 0, 0, 8), np.float32),
            "skip_meta": np.zeros(8, np.float32)}


def _face_key_sort(cells: np.ndarray) -> np.ndarray:
    """All 4 faces of every cell as sorted vertex triples, ``[C*4, 3]``;
    face ``c*4 + k`` is the face of cell ``c`` opposite vertex ``k``."""
    opp = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64)
    faces = cells[:, opp]
    return np.sort(faces.reshape(-1, 3), axis=1)


def build_adjacency(cells: np.ndarray) -> np.ndarray:
    """Face-adjacency table ``neighbors[C, 4]`` (-1 where no neighbour),
    by sorting face keys. Raises if a face is shared by more than two
    cells."""
    cells = np.asarray(cells, dtype=np.int64)
    num_cells = cells.shape[0]
    faces = _face_key_sort(cells)
    order = np.lexsort((faces[:, 2], faces[:, 1], faces[:, 0]))
    sf = faces[order]
    same = (sf[1:] == sf[:-1]).all(axis=1)
    if np.any(same[:-1] & same[1:]):
        raise ValueError("a triangle face is shared by more than 2 tetrahedra")
    neighbors = np.full(num_cells * 4, -1, dtype=np.int32)
    a = order[:-1][same]
    b = order[1:][same]
    neighbors[a] = b // 4
    neighbors[b] = a // 4
    return neighbors.reshape(num_cells, 4)


def _hash_unit(idx: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic splitmix64-style hash of integer ids to [-1, 1]: the
    per-vertex jitter of :func:`compute_planes`, a pure function of
    ``(id, salt)`` so every cell touching a vertex sees the same position."""
    x = np.asarray(idx, dtype=np.uint64) + np.uint64(salt + 1) * np.uint64(
        0x9E3779B97F4A7C15
    )
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53) * 2.0 - 1.0


def compute_planes(vertices: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Barycentric plane tables ``f32[C, 4, 4]``: the inverse of the
    homogeneous vertex matrix ``[[v_0..v_3]; [1 1 1 1]]`` of each cell.

    Numerically singular cells (zero-volume simplices Qhull emits for
    cospherical inputs, kept for watertight adjacency) are solved on
    vertex positions jittered by a hash of the global vertex id, growing
    the jitter tenfold per round, every singular cell re-jittered each
    round so adjacent singular cells agree on their shared face. Cells
    still singular after 8 rounds get a sentinel plane that is never
    inside and never an exit."""
    cells = np.asarray(cells, dtype=np.int64)
    v = np.asarray(vertices, dtype=np.float64)[cells]
    m = np.concatenate([v, np.ones_like(v[..., :1])], axis=-1)
    m = np.swapaxes(m, -1, -2)  # columns are [v_k; 1]
    dets = np.linalg.det(m)
    edge = np.linalg.norm(v[:, 1:] - v[:, :1], axis=-1).max(axis=-1)
    singular = np.abs(dets) <= 1e-14 * np.maximum(edge, 1e-30) ** 3
    if np.any(singular):
        m = m.copy()
        all_idx = np.nonzero(singular)[0]
        idx = all_idx
        sc = float(np.abs(v).max()) or 1.0
        eps = 1e-7
        for _ in range(8):
            vid = cells[all_idx]
            jit = np.stack(
                [_hash_unit(vid, salt) for salt in range(3)], axis=-1
            )
            vj = v[all_idx] + eps * sc * jit
            mj = np.concatenate([vj, np.ones_like(vj[..., :1])], axis=-1)
            mj = np.swapaxes(mj, -1, -2)
            m[all_idx] = mj
            still_all = np.abs(np.linalg.det(mj)) <= (
                1e-14 * np.maximum(edge[all_idx], 1e-30) ** 3
            )
            idx = all_idx[still_all]
            if not len(idx):
                break
            eps *= 10.0
        else:
            m[idx] = np.eye(4)
            planes = np.linalg.inv(m)
            planes[idx] = np.array([0.0, 0.0, 0.0, -1e30])[None, :]
            return planes.astype(np.float32)
    return np.linalg.inv(m).astype(np.float32)


def _check_watertight(vertices, cells, neighbors, hull_eqs, tol_rel=1e-5):
    """Raise if a boundary face (neighbour -1) lies strictly inside the
    convex hull: a hole that would stop marching rays silently."""
    boundary_mask = (np.asarray(neighbors) < 0).reshape(-1)
    if not boundary_mask.any():
        return
    v = np.asarray(vertices, np.float64)
    faces = _face_key_sort(np.asarray(cells, np.int64))[boundary_mask]
    centroids = v[faces].mean(axis=1)
    scale = float(np.abs(v).max()) or 1.0
    tol = tol_rel * scale
    n, d = hull_eqs[:, :3], hull_eqs[:, 3]
    interior = 0
    example = None
    for i in range(0, len(centroids), 65536):
        c = centroids[i : i + 65536]
        dist = (c @ n.T + d[None, :]).max(axis=1)
        bad = dist < -tol
        interior += int(bad.sum())
        if example is None and bad.any():
            example = c[np.argmax(bad)]
    if interior:
        raise ValueError(
            f"non-watertight tetrahedra complex: {interior} boundary "
            f"face(s) lie strictly inside the convex hull (e.g. near "
            f"{example}); pass the full simplicial complex, degenerate "
            "cells included."
        )


def _convex_hull(vertices: np.ndarray):
    from scipy.spatial import ConvexHull

    return ConvexHull(np.asarray(vertices, dtype=np.float64), qhull_options="Qx")


def build_mesh(
    vertices: np.ndarray,
    cells: Optional[np.ndarray] = None,
    device="cuda",
) -> TorchMesh:
    """Build the mesh tables from vertices (Delaunay-tetrahedralized when
    ``cells`` is None) and place them on ``device``."""
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    if cells is None:
        from .delaunay import triangulate

        cells = triangulate(vertices)
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    neighbors = build_adjacency(cells)
    planes = compute_planes(vertices, cells)

    hull = _convex_hull(vertices)
    hull_eqs = hull.equations.astype(np.float64)
    _check_watertight(vertices, cells, neighbors, hull_eqs)

    # Each hull facet seeds the entry walk from an incident boundary cell;
    # a facet Qhull triangulated differently from the complex falls back
    # to a cell incident to its first vertex (the walk corrects it).
    vertex_cells = np.zeros(len(vertices), dtype=np.int32)
    c_idx = np.arange(len(cells), dtype=np.int32)
    for k in range(4):
        vertex_cells[cells[:, k]] = c_idx
    boundary_mask = (neighbors < 0).reshape(-1)
    boundary_faces = _face_key_sort(cells.astype(np.int64))[boundary_mask]
    boundary_cells = np.repeat(c_idx, 4)[boundary_mask]
    face_lut = {tuple(f): c for f, c in zip(boundary_faces, boundary_cells)}
    hull_simplices = np.sort(hull.simplices, axis=1)
    hull_cells = np.empty(len(hull_simplices), dtype=np.int32)
    for i, tri in enumerate(hull_simplices):
        c = face_lut.get(tuple(int(t) for t in tri))
        hull_cells[i] = vertex_cells[tri[0]] if c is None else c

    march_table = np.zeros((len(cells), MARCH_ROW), np.float32)
    march_table[:, :16] = planes.reshape(len(cells), 16)
    march_table[:, 16:20] = neighbors.view(np.float32)
    march_table[:, 20:24] = cells.view(np.float32)

    host = dict(
        vertices=vertices.astype(np.float32),
        cells=cells,
        neighbors=neighbors,
        planes=march_table[:, :16].reshape(len(cells), 4, 4),
        hull_eqs=hull_eqs.astype(np.float32),
        hull_cells=hull_cells,
        vertex_cells=vertex_cells,
        march_table=march_table,
        **_no_skip_grid(),
    )
    return TorchMesh(
        **{
            k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in host.items()
        }
    )
