"""The port's synthetic scenes against the JAX package's: the camera scene
and the hard scene (point clouds, colours, ray samplers and analytic
targets) bit for bit at several seeds and sizes, and the hard-scene
dataset writer (``--scene hard``) against ``benchmarks/make_synthetic_dataset.py``."""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tetranerf_torch.geometry import load_tetrahedra
from tetranerf_torch.utils import synthetic
from tetranerf_torch.utils.synthetic_dataset import main as write_main

SCENES = {
    "camera": ("make_camera_scene", "sample_camera_rays", "camera_ray_targets"),
    "hard": ("make_hard_scene", "sample_hard_rays", "hard_ray_targets"),
}


@pytest.mark.parametrize("seed, num_points", [(0, 2000), (3, 500), (11, 64)])
@pytest.mark.parametrize("scene", list(SCENES))
def test_scene_matches_jax(scene, seed, num_points):
    """Points, colours, sampled rays and their targets, bit for bit."""
    from tetranerf_tpu.utils import synthetic as jax_synthetic

    make, sample, targets = SCENES[scene]
    ours = getattr(synthetic, make)(num_points, seed=seed)
    ref = getattr(jax_synthetic, make)(num_points, seed=seed)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    o, d = getattr(synthetic, sample)(np.random.default_rng(seed), 512)
    jo, jd = getattr(jax_synthetic, sample)(np.random.default_rng(seed), 512)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(d, jd)
    rgb = getattr(synthetic, targets)(o, d)
    np.testing.assert_array_equal(rgb, getattr(jax_synthetic, targets)(jo, jd))
    assert rgb.dtype == np.float32 and ((rgb >= 0) & (rgb <= 1)).all()
    assert (rgb < 1).any(axis=1).sum() > 64  # rays that hit an object


def test_camera_scene_stretches_its_hull():
    """~5% of the points on a far shell: the hull is many times the objects."""
    points, _ = synthetic.make_camera_scene(2000, seed=0)
    radius = np.linalg.norm(points, axis=1)
    assert (radius > 4.0).sum() == 100 and (radius < 1.0).sum() > 1800


def test_hard_dataset_matches_the_jax_generator(tmp_path, monkeypatch):
    """``--scene hard`` at ``--side 16``: the same transforms, pixels and
    tetrahedra as the JAX package's writer."""
    args = ["--side=16", "--train=2", "--test=1", "--points=300", "--scene=hard"]
    write_main(["--out", str(tmp_path / "port")] + args)
    script = Path(__file__).resolve().parents[1] / "benchmarks" / "make_synthetic_dataset.py"
    monkeypatch.setattr(sys, "argv", [str(script), "--out", str(tmp_path / "jax")] + args)
    runpy.run_path(str(script), run_name="__main__")
    for split, count in (("train", 2), ("test", 1)):
        name = f"transforms_{split}.json"
        ours = json.loads((tmp_path / "port" / name).read_text())
        assert ours == json.loads((tmp_path / "jax" / name).read_text())
        assert len(ours["frames"]) == count
        for frame in ours["frames"]:
            png = frame["file_path"][2:] + ".png"
            a, b = (np.asarray(Image.open(tmp_path / root / png))
                    for root in ("port", "jax"))
            assert a.shape == (16, 16, 3)
            np.testing.assert_array_equal(a, b)
    ours = load_tetrahedra(tmp_path / "port" / "tetra.npz")
    ref = np.load(tmp_path / "jax" / "tetra.npz")
    for k in ref.files:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
