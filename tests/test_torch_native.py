"""The port's native host geometry library (``tetranerf_torch/csrc/
tetra_geom.cpp``, bound by ``tetranerf_torch/geometry/native.py``), built
here with ``g++``: the neighbour table (a bucket sort in C++) bit for bit
against the port's numpy path and the JAX package's ``build_adjacency``,
the over-shared face and a negative vertex id refused, the spacing against brute force and the KD-tree (as
``tests/test_native.py`` holds JAX's library), and ``build_mesh`` with and
without the library."""

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import build_mesh, delaunay, mesh, native, triangulate
from tetranerf_torch.utils.synthetic import make_sphere_scene


@pytest.fixture(scope="module")
def lib():
    return native.load()


def _sphere_cells():
    points, _ = make_sphere_scene(2_000, seed=0)
    return points, triangulate(points)


@pytest.mark.parametrize("scene", ["ball", "sphere"])
def test_adjacency_is_the_numpy_and_jax_table(lib, ball_points, scene):
    from tetranerf_tpu.geometry import mesh as jax_mesh

    cells = triangulate(ball_points) if scene == "ball" else _sphere_cells()[1]
    ours = native.build_adjacency(cells)
    assert ours.dtype == np.int32 and ours.shape == (len(cells), 4)
    np.testing.assert_array_equal(ours, mesh.build_adjacency_numpy(cells))
    np.testing.assert_array_equal(ours, jax_mesh.build_adjacency(cells))
    np.testing.assert_array_equal(mesh.build_adjacency(cells), ours)


def test_adjacency_refuses_an_overshared_face(lib):
    cells = np.array([[0, 1, 2, 3], [0, 1, 2, 4], [0, 1, 2, 5]], np.int32)
    with pytest.raises(ValueError, match="more than 2"):
        native.build_adjacency(cells)
    with pytest.raises(ValueError, match="more than 2"):
        mesh.build_adjacency_numpy(cells)
    with pytest.raises(ValueError, match="negative vertex id"):
        native.build_adjacency(np.array([[0, 1, 2, -3]], np.int32))


@pytest.mark.parametrize("num_neighbors", [1, 6])
def test_spacing_matches_bruteforce_and_kdtree(lib, rng, num_neighbors):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    ref = np.sqrt(np.sort(d2, axis=1)[:, :num_neighbors]).mean()
    got = native.average_spacing(pts, num_neighbors)
    assert got == pytest.approx(float(ref), rel=1e-6)
    assert got == pytest.approx(delaunay.average_spacing_kdtree(pts, num_neighbors),
                                rel=1e-6)
    assert delaunay.find_average_spacing(pts, num_neighbors) == got


def test_spacing_on_a_line(lib):
    pts = np.stack([np.arange(10) * 2.0, np.zeros(10), np.zeros(10)], axis=-1)
    assert 2.0 <= native.average_spacing(pts, 2) <= 2.5


def test_build_mesh_with_and_without_the_library(lib, monkeypatch):
    points, cells = _sphere_cells()
    with_lib = build_mesh(points, cells, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    without = build_mesh(points, cells, device="cpu")
    for name, value in vars(with_lib).items():
        if isinstance(value, torch.Tensor):  # bits: sentinel planes hold NaN
            other = getattr(without, name)
            assert value.dtype == other.dtype and value.shape == other.shape, name
            assert value.numpy().tobytes() == other.numpy().tobytes(), name
