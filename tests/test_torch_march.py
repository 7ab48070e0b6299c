"""The march (kernel K1 and its PyTorch twin) against the golden trace and
the JAX package's ``march_features``: every field of the ``FusedMarch`` that
one K1 launch writes (cells, t0, t1, valid, num_valid, hit, overflow,
t_entry and the stream's vids, pos and bary), padding included.

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
# (use_occupancy, max_steps): full marches, occupancy termination, a bound
# short enough that most rays overflow, and bounds that are not a multiple
# of the JAX march's 16-step blocks (23: nor of K1's four-slot stores).
CASES = {"plain": (False, 64), "occupancy": (True, 64), "overflow": (False, 16),
         "ragged": (True, 20), "odd": (False, 23)}
FIELDS = ("cells", "t0", "t1", "valid", "num_valid", "hit", "overflow", "t_entry",
          "vids", "pos", "bary")
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
    mesh = build_mesh(points, device="cpu")
    centroids = mesh.vertices[mesh.cells.long()].mean(dim=1)
    occ = torch.where(centroids.norm(dim=1) > 0.85, 30.0, 0.0)
    origins, directions = sample_sphere_rays(np.random.default_rng(1), 256)
    # Two rays that miss the hull: from outside, pointing away from it.
    origins[:2] = [[3.0, 0.0, 0.0], [0.0, -3.0, 0.5]]
    directions[:2] = [[1.0, 0.0, 0.0], [0.0, -0.6, 0.8]]
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
        out[name] = {k: np.asarray(v) for k, v in _fields(res).items()}
    return out


def _fields(res):
    """The march's outputs by name (``t0`` from ``t0s``, the stream's
    tensors flattened in)."""
    return {"cells": res.cells, "t0": res.t0, "t1": res.t1, "valid": res.valid,
            "num_valid": res.num_valid, "hit": res.hit, "overflow": res.overflow,
            "t_entry": res.t_entry, "vids": res.stream.vids, "pos": res.stream.pos,
            "bary": res.stream.bary}


def _port_march(scene, case, device="cpu"):
    use_occ, steps = CASES[case]
    mesh = scene["mesh"].with_occupancy(scene["occ"]) if use_occ else scene["mesh"]
    res = march(
        mesh.to(device),
        torch.from_numpy(scene["origins"]).to(device),
        torch.from_numpy(scene["directions"]).to(device),
        max_steps=steps, use_occupancy=use_occ, occ_threshold=THRESHOLD,
    )
    return _fields(res)


def _assert_same_march(ours, theirs, t_atol, bary_atol):
    """Every field exact but the distances (``t_atol`` where finite, the
    same infinities; ``t_entry`` on hit rays) and the weights."""
    for name in ("cells", "valid", "num_valid", "hit", "overflow", "vids", "pos"):
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    _assert_distances(ours["t0"], theirs["t0"], t_atol)
    _assert_distances(ours["t1"], theirs["t1"], t_atol)
    hit = theirs["hit"]
    np.testing.assert_allclose(ours["t_entry"][hit], theirs["t_entry"][hit],
                               atol=t_atol, rtol=0)
    np.testing.assert_allclose(ours["bary"], theirs["bary"], atol=bary_atol, rtol=0)


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
    mesh = build_mesh(golden["points"], device="cpu")
    res = march(mesh, torch.from_numpy(golden["origins"]),
                torch.from_numpy(golden["directions"]), max_steps=96)
    _check_golden(res, golden)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_march_features(case, scene, jax_marches):
    ours = {k: v.numpy() for k, v in _port_march(scene, case).items()}
    theirs = jax_marches[case]
    _assert_same_march(ours, theirs, T_ATOL, BARY_ATOL)
    # The two missed rays: all padding, the entry weights zeroed, the entry
    # ids those of row 0 (JAX's clamped fetch).
    assert not ours["hit"][:2].any() and not ours["valid"][:2].any()
    assert (ours["bary"][:2] == 0).all() and (ours["pos"][:2, 1:] == 0).all()
    row0 = scene["mesh"].march_table[0, 20:24].view(torch.int32).numpy()
    np.testing.assert_array_equal(ours["vids"][:2, :4], np.stack([row0, row0]))
    if case == "overflow":
        assert ours["overflow"].sum() > 100
    if case == "occupancy":  # termination shortens the marches
        assert ours["num_valid"].mean() < jax_marches["plain"]["num_valid"].mean()
    if case in ("ragged", "odd"):  # the bound falls inside a 16-step block
        assert ours["overflow"].any() and (ours["num_valid"] == CASES[case][1]).any()


def test_zero_rays(scene):
    """An empty batch gives every output at its shape with no rows."""
    none = np.zeros((0, 3), np.float32)
    res = march(scene["mesh"], torch.from_numpy(none), torch.from_numpy(none), max_steps=20)
    shapes = {k: tuple(v.shape) for k, v in _fields(res).items()}
    assert shapes == {"cells": (0, 20), "t0": (0, 20), "t1": (0, 20), "valid": (0, 20),
                      "num_valid": (0,), "hit": (0,), "overflow": (0,), "t_entry": (0,),
                      "vids": (0, 24), "pos": (0, 21, 4), "bary": (0, 21, 4)}


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
    ours, twin = (_fields(f(*args)) for f in (march_intervals, march_intervals_twin))
    for name, x in ours.items():
        y = twin[name]
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y), name
        assert torch.equal(a[name].view(torch.int32) if x.is_floating_point() else a[name],
                           y.view(torch.int32) if y.is_floating_point() else y), name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the march kernel runs only on the card")
    return torch.device("cuda")


def _kernel_and_twin(mesh, o, d, steps, use_occ):
    """K1 (one launch) and the twin on the same CUDA inputs, as fields."""
    args = (mesh.march_table, mesh.hull_cells, o, d,
            *hull_intersect(mesh.hull_eqs, o, d), steps, -(-steps // 16) * 16, 16,
            use_occ, float(-np.log(THRESHOLD)))
    before = cuda.launch_counts["march"]
    ker = _fields(march_intervals(*args))
    torch.cuda.synchronize()
    assert cuda.launch_counts["march"] == before + (o.shape[0] > 0)
    twin = _fields(march_intervals_twin(*args))
    return ({k: v.cpu().numpy() for k, v in ker.items()},
            {k: v.cpu().numpy() for k, v in twin.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_twin(case, scene, cuda_device):
    """Every field, padding included: the missed rays, overflow, and a
    bound that is not a multiple of 16."""
    use_occ, steps = CASES[case]
    mesh = scene["mesh"].with_occupancy(scene["occ"]) if use_occ else scene["mesh"]
    ker, twin = _kernel_and_twin(
        mesh.to(cuda_device), torch.from_numpy(scene["origins"]).to(cuda_device),
        torch.from_numpy(scene["directions"]).to(cuda_device), steps, use_occ)
    _assert_same_march(ker, twin, 1e-5, 1e-5)
    assert not ker["hit"][:2].any()


@pytest.fixture(scope="module")
def flagship_scene():
    """The flagship step's shape, 4096 rays at bound 384, on a 20,000-point
    sphere, with the shell occupancy column of ``scene``."""
    points, _ = make_sphere_scene(20_000, seed=0)
    mesh = build_mesh(points, device="cpu")
    centroids = mesh.vertices[mesh.cells.long()].mean(dim=1)
    occ = torch.where(centroids.norm(dim=1) > 0.85, 30.0, 0.0)
    origins, directions = sample_sphere_rays(np.random.default_rng(2), 4096)
    return dict(mesh=mesh, occ=occ, origins=origins, directions=directions)


@pytest.mark.cuda
@pytest.mark.parametrize("use_occ", [True, False], ids=["occupancy", "long"])
def test_kernel_matches_twin_at_the_flagship_shape(use_occ, flagship_scene, cuda_device):
    """4096 rays x 384 slots: with the occupancy column, and without it
    (rays that cross the whole ball)."""
    sc = flagship_scene
    mesh = sc["mesh"].with_occupancy(sc["occ"]) if use_occ else sc["mesh"]
    ker, twin = _kernel_and_twin(
        mesh.to(cuda_device), torch.from_numpy(sc["origins"]).to(cuda_device),
        torch.from_numpy(sc["directions"]).to(cuda_device), 384, use_occ)
    _assert_same_march(ker, twin, 1e-5, 1e-5)
    if not use_occ:
        assert ker["num_valid"].mean() > 50


@pytest.mark.cuda
def test_kernel_zero_rays(scene, cuda_device):
    none = torch.zeros((0, 3), device=cuda_device)
    ker, twin = _kernel_and_twin(scene["mesh"].to(cuda_device), none, none, 20, False)
    assert {k: v.shape for k, v in ker.items()} == {k: v.shape for k, v in twin.items()}


@pytest.mark.cuda
def test_one_launch_per_march(scene, cuda_device):
    """``march()`` is the hull slab and one K1 launch: ``march_intervals``
    launches K1 alone (K1 writes every output, no fill runs), nothing
    follows it in ``march()``, and nothing is copied from the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mesh = scene["mesh"].with_occupancy(scene["occ"]).to(cuda_device)
    o = torch.from_numpy(scene["origins"]).to(cuda_device)
    d = torch.from_numpy(scene["directions"]).to(cuda_device)
    t_in, t_out, facet, hit = hull_intersect(mesh.hull_eqs, o, d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        march_intervals(mesh.march_table, mesh.hull_cells, o, d, t_in, t_out, facet,
                        hit, 64, 64, 16, True, float(-np.log(THRESHOLD)))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "march_kernel" in names[0], names
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hull_intersect(mesh.hull_eqs, o, d)
        torch.cuda.synchronize()
    slab = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    before = cuda.launch_counts["march"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        march(mesh, o, d, max_steps=64, use_occupancy=True, occ_threshold=THRESHOLD)
        torch.cuda.synchronize()
    assert cuda.launch_counts["march"] == before + 1
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == len(slab) + 1 and "march_kernel" in names[-1], (slab, names)
    assert not [n for n in names if "memcpy" in n.lower()], names


@pytest.mark.cuda
def test_kernel_matches_golden_trace(golden, cuda_device):
    mesh = build_mesh(golden["points"], device=cuda_device)
    before = cuda.launch_counts["march"]
    res = march(mesh, torch.from_numpy(golden["origins"]).to(cuda_device),
                torch.from_numpy(golden["directions"]).to(cuda_device),
                max_steps=96)
    assert cuda.launch_counts["march"] == before + 1
    _check_golden(res, golden)
