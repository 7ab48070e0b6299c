"""The march (kernel K1 and its PyTorch twin) against the golden trace and
the JAX package's ``march_features``.

JAX is imported inside fixtures only, so the CUDA cases also run where JAX
is absent: ``python -m pytest --noconftest -m cuda tests/test_torch_march.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import build_mesh
from tetranerf_torch.ops import cuda
from tetranerf_torch.ops.march import (
    march,
    march_intervals,
    march_intervals_twin,
)
from tetranerf_torch.ops.traversal import hull_intersect
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays

GOLDEN = Path(__file__).parent / "assets" / "golden_march.npz"
THRESHOLD = 1e-4
# (use_occupancy, max_steps): full marches, occupancy termination, and a
# bound short enough that most rays overflow.
CASES = {"plain": (False, 64), "occupancy": (True, 64), "overflow": (False, 16)}
# Distances: cells agree exactly, but the JAX CPU build contracts the plane
# sums into FMAs while the port rounds each product (as its kernel does,
# --fmad=false), so t differs by an ulp or two.
T_ATOL = 1e-5
# Barycentrics are b + (t_exit - t) * den: an ulp of t times |den|, which
# reaches ~1e3 on sliver cells (measured max 5e-4 on this scene).
BARY_ATOL = 1e-3


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def scene():
    points, _ = make_sphere_scene(800, seed=0)
    mesh = build_mesh(points)
    centroids = mesh.vertices[mesh.cells.long()].mean(dim=1)
    occ = torch.where(centroids.norm(dim=1) > 0.85, 30.0, 0.0)
    origins, directions = sample_sphere_rays(np.random.default_rng(1), 256)
    return dict(points=points, mesh=mesh, occ=occ, origins=origins,
                directions=directions)


@pytest.fixture(scope="module")
def jax_marches(scene):
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.ops.fused import march_features

    base = jax_build_mesh(scene["points"])
    out = {}
    for name, (use_occ, steps) in CASES.items():
        mesh = base.with_occupancy(scene["occ"].numpy()) if use_occ else base
        res = march_features(
            mesh, None, scene["origins"], scene["directions"],
            max_steps=steps, use_occupancy=use_occ, occ_threshold=THRESHOLD,
        )
        out[name] = {
            "cells": res.cells, "t0": res.t0, "t1": res.t1,
            "num_valid": res.num_valid, "hit": res.hit,
            "overflow": res.overflow, "vids": res.stream.vids,
            "pos": res.stream.pos, "bary": res.stream.bary,
        }
        out[name] = {k: np.asarray(v) for k, v in out[name].items()}
    return out


def _port_march(scene, case, device="cpu"):
    use_occ, steps = CASES[case]
    mesh = scene["mesh"].with_occupancy(scene["occ"]) if use_occ else scene["mesh"]
    res = march(
        mesh.to(device),
        torch.from_numpy(scene["origins"]).to(device),
        torch.from_numpy(scene["directions"]).to(device),
        max_steps=steps, use_occupancy=use_occ, occ_threshold=THRESHOLD,
    )
    return {
        "cells": res.cells, "t0": res.t0, "t1": res.t1,
        "num_valid": res.num_valid, "hit": res.hit, "overflow": res.overflow,
        "vids": res.stream.vids, "pos": res.stream.pos, "bary": res.stream.bary,
    }


def _assert_distances(ours, theirs, atol):
    fin = np.isfinite(theirs)
    np.testing.assert_array_equal(np.isfinite(ours), fin)
    np.testing.assert_allclose(ours[fin], theirs[fin], atol=atol, rtol=0)


def _check_golden(res, golden):
    num = golden["num_cells"]
    np.testing.assert_array_equal(res.num_valid.cpu().numpy(), num)
    cells, t0, t1 = (x.cpu().numpy() for x in (res.cells, res.t0, res.t1))
    for r, n in enumerate(num):
        np.testing.assert_array_equal(cells[r, :n], golden["cells"][r, :n])
        np.testing.assert_allclose(t0[r, :n], golden["t0"][r, :n], atol=1e-5)
        np.testing.assert_allclose(t1[r, :n], golden["t1"][r, :n], atol=1e-5)


def test_twin_matches_golden_trace(golden):
    mesh = build_mesh(golden["points"])
    res = march(mesh, torch.from_numpy(golden["origins"]),
                torch.from_numpy(golden["directions"]), max_steps=96)
    _check_golden(res, golden)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_march_features(case, scene, jax_marches):
    ours = {k: v.numpy() for k, v in _port_march(scene, case).items()}
    theirs = jax_marches[case]
    for name in ("cells", "num_valid", "hit", "overflow", "vids", "pos"):
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    _assert_distances(ours["t0"], theirs["t0"], T_ATOL)
    _assert_distances(ours["t1"], theirs["t1"], T_ATOL)
    np.testing.assert_allclose(ours["bary"], theirs["bary"], atol=BARY_ATOL, rtol=0)
    if case == "overflow":
        assert ours["overflow"].sum() > 100
    if case == "occupancy":  # termination shortens the marches
        assert ours["num_valid"].mean() < jax_marches["plain"]["num_valid"].mean()


def test_wrapper_runs_the_twin_on_cpu(scene):
    before = dict(cuda.launch_counts)
    a = _port_march(scene, "occupancy")
    assert cuda.launch_counts == before
    mesh = scene["mesh"].with_occupancy(scene["occ"])
    o = torch.from_numpy(scene["origins"])
    d = torch.from_numpy(scene["directions"])
    args = (mesh.march_table, mesh.hull_cells, o, d,
            *hull_intersect(mesh.hull_eqs, o, d), 64, 64, 16, True,
            -np.log(THRESHOLD))
    for x, y in zip(march_intervals(*args), march_intervals_twin(*args)):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
    assert torch.equal(a["cells"], march_intervals_twin(*args).cells)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the march kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_twin(case, scene, cuda_device):
    use_occ, steps = CASES[case]
    mesh = scene["mesh"].with_occupancy(scene["occ"]) if use_occ else scene["mesh"]
    mesh = mesh.to(cuda_device)
    o = torch.from_numpy(scene["origins"]).to(cuda_device)
    d = torch.from_numpy(scene["directions"]).to(cuda_device)
    args = (mesh.march_table, mesh.hull_cells, o, d,
            *hull_intersect(mesh.hull_eqs, o, d), steps, steps, 16, use_occ,
            float(-np.log(THRESHOLD)))
    before = cuda.launch_counts["march"]
    ker = march_intervals(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts["march"] == before + 1
    twin = march_intervals_twin(*args)
    for name in ("cells", "pos", "new_vid", "vids0", "hit", "done"):
        assert torch.equal(getattr(ker, name), getattr(twin, name)), name
    for name in ("t0", "t1"):
        _assert_distances(getattr(ker, name).cpu().numpy(),
                          getattr(twin, name).cpu().numpy(), 1e-5)
    torch.testing.assert_close(ker.bary_exit, twin.bary_exit, atol=1e-5, rtol=0)
    hit = twin.hit
    torch.testing.assert_close(ker.t_entry[hit], twin.t_entry[hit], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_matches_golden_trace(golden, cuda_device):
    mesh = build_mesh(golden["points"], device=cuda_device)
    before = cuda.launch_counts["march"]
    res = march(mesh, torch.from_numpy(golden["origins"]).to(cuda_device),
                torch.from_numpy(golden["directions"]).to(cuda_device),
                max_steps=96)
    assert cuda.launch_counts["march"] == before + 1
    _check_golden(res, golden)
