"""The serving path: chunked rendering, the no-JAX import guard, and the
kernel build refusing to fall back."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import build_mesh
from tetranerf_torch.models import TetraNerf, tetranerf_preset
from tetranerf_torch.ops import cuda
from tetranerf_torch.render import Renderer
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(field_dim=16, hidden_size=32, num_samples=16, num_fine_samples=16,
             max_intersected_triangles=64, ray_buckets=1)


@pytest.fixture(scope="module")
def renderer():
    points, colors = make_sphere_scene(800, seed=0)
    mesh = build_mesh(points, device="cpu")
    centroids = mesh.vertices[mesh.cells.long()].mean(dim=1)
    mesh = mesh.with_occupancy(torch.where(centroids.norm(dim=1) > 0.85, 30.0, 0.0))
    model = TetraNerf(tetranerf_preset(**SMALL), mesh.num_vertices,
                      point_colors=colors,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    return Renderer(model, mesh, "cpu")


def test_chunked_render_matches_one_call(renderer):
    o, d = sample_sphere_rays(np.random.default_rng(4), 100)
    whole = renderer.render_rays(o, d, chunk=100)
    chunked = renderer.render_rays(o, d, chunk=32)  # 3 full chunks + a padded tail
    assert whole.keys() == chunked.keys()
    for k in whole:
        assert whole[k].shape == chunked[k].shape == (100,) + whole[k].shape[1:]
        # Rays are independent; only GEMM blocking may differ with batch size.
        np.testing.assert_allclose(chunked[k], whole[k], atol=1e-5, rtol=0, err_msg=k)
    assert np.isfinite(whole["rgb"]).all()
    assert whole["rgb"].min() >= 0.0 and whole["rgb"].max() <= 1.0
    assert whole["ray_mask"].sum() > 90


def test_port_imports_and_renders_without_jax():
    code = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np, torch
from tetranerf_torch import Renderer, TetraNerf, build_mesh, tetranerf_preset
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays
points, colors = make_sphere_scene(300, seed=0)
mesh = build_mesh(points, device="cpu")
cfg = tetranerf_preset(field_dim=8, hidden_size=16, num_samples=8,
                       num_fine_samples=8, max_intersected_triangles=32,
                       ray_buckets=1)
model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                  generator=torch.Generator().manual_seed(0), device="cpu")
o, d = sample_sphere_rays(np.random.default_rng(0), 16)
out = Renderer(model, mesh, "cpu").render_rays(o, d, chunk=8)
assert np.isfinite(out["rgb"]).all() and out["rgb"].shape == (16, 3)
leaked = [m for m in sys.modules if m.startswith(("jax", "tetranerf_tpu"))
          and sys.modules[m] is not None]
assert not leaked, leaked
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda, "_lib", None)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.load()


def test_cuda_path_refuses_cpu_tensors():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cuda.check_cuda_inputs("k", a=x)
