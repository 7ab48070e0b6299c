"""The port's mesh builder and host helpers against the JAX package's."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
from tetranerf_tpu.geometry.delaunay import triangulate as jax_triangulate
from tetranerf_tpu.utils import synthetic as jax_synthetic
from tetranerf_torch.geometry import TorchMesh, build_mesh, triangulate
from tetranerf_torch.utils import synthetic

GOLDEN = Path(__file__).parent / "assets" / "golden_march.npz"
TABLES = ("vertices", "cells", "neighbors", "planes", "hull_eqs",
          "hull_cells", "vertex_cells", "march_table")


def _points(name):
    if name == "sphere800":
        return synthetic.make_sphere_scene(800, seed=0)[0]
    with np.load(GOLDEN) as data:
        return data["points"]


@pytest.mark.parametrize("scene", ["sphere800", "golden300"])
def test_build_mesh_matches_jax_bit_for_bit(scene):
    points = _points(scene)
    mesh = build_mesh(points, device="cpu")
    ref = jax_build_mesh(points)
    for name in TABLES:
        ours = getattr(mesh, name).numpy()
        theirs = np.asarray(getattr(ref, name))
        assert ours.dtype == theirs.dtype, name
        assert ours.shape == theirs.shape, name
        # Bit for bit: the id columns of march_table are bit-cast ints.
        np.testing.assert_array_equal(
            ours.view(np.uint8), theirs.view(np.uint8), err_msg=name
        )


def test_triangulate_matches_jax():
    points = _points("sphere800")
    np.testing.assert_array_equal(triangulate(points), jax_triangulate(points))


def test_with_occupancy_writes_column_24_only():
    mesh = build_mesh(_points("golden300"), device="cpu")
    occ = torch.arange(mesh.num_cells, dtype=torch.float32) * 0.5
    new = mesh.with_occupancy(occ)
    assert torch.equal(new.march_table[:, 24], occ)
    keep = [c for c in range(64) if c != 24]
    assert torch.equal(
        new.march_table.view(torch.int32)[:, keep],
        mesh.march_table.view(torch.int32)[:, keep],
    )
    assert torch.all(mesh.march_table[:, 24] == 0)  # the source is unchanged
    with pytest.raises(ValueError):
        mesh.with_occupancy(occ[:-1])


def test_from_tables_wraps_jax_mesh_and_refuses_skip_grid():
    """A JAX mesh wraps table for table, its skip grid as it is (zero-size
    when off; the skip grid is ported, so a mesh carrying one is no longer
    refused but wrapped bit for bit)."""
    points = _points("golden300")
    ref = jax_build_mesh(points)
    mesh = TorchMesh.from_tables(ref, device="cpu")
    np.testing.assert_array_equal(
        mesh.march_table.numpy().view(np.int32),
        np.asarray(ref.march_table).view(np.int32),
    )
    assert mesh.to("cpu").device == torch.device("cpu")
    assert tuple(mesh.skip_table.shape) == (0, 0, 0, 8) and not mesh.has_skip_grid
    table = np.random.default_rng(0).random((2, 2, 2, 8)).astype(np.float32)
    table[..., 1] = np.arange(8, dtype=np.int32).reshape(2, 2, 2).view(np.float32)
    meta = np.arange(8, dtype=np.float32)
    with_skip = ref.__class__(**{**ref.__dict__, "skip_table": table, "skip_meta": meta})
    wrapped = TorchMesh.from_tables(with_skip, device="cpu")
    assert wrapped.has_skip_grid
    np.testing.assert_array_equal(wrapped.skip_table.numpy().view(np.int32),
                                  table.view(np.int32))
    np.testing.assert_array_equal(wrapped.skip_meta.numpy(), meta)
    kept = wrapped.with_occupancy(np.ones(wrapped.num_cells, np.float32))
    assert kept.skip_table is wrapped.skip_table and mesh.with_skip_grid(
        table, meta).has_skip_grid and not mesh.has_skip_grid


def test_synthetic_scene_matches_jax():
    p, c = synthetic.make_sphere_scene(500, seed=3)
    jp, jc = jax_synthetic.make_sphere_scene(500, seed=3)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc)
    o, d = synthetic.sample_sphere_rays(np.random.default_rng(5), 64)
    jo, jd = jax_synthetic.sample_sphere_rays(np.random.default_rng(5), 64)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(d, jd)
