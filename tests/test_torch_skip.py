"""The empty-space skip grid of the port (``ops/skip_grid.py``, the march's
sphere-trace prologue, the point-location walk K9 and the trainer's
rebuild) against the JAX package's ``ops/skip_grid.py``, ``march_features``
and ``Trainer``.

JAX is imported inside fixtures and tests only, so the CUDA cases also run
where JAX is absent: ``python -m pytest --noconftest -m cuda
tests/test_torch_skip.py``.
"""

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh, build_mesh
from tetranerf_torch.ops import cuda
from tetranerf_torch.ops.march import (
    locate_points,
    locate_points_twin,
    march,
    march_intervals,
    march_intervals_twin,
)
from tetranerf_torch.ops.skip_grid import (
    LOCATE_STEPS,
    build_skip_table,
    chebyshev_distance,
    make_skip_setup,
)
from tetranerf_torch.ops.traversal import hull_intersect
from tetranerf_torch.utils.synthetic import (
    camera_ray_targets,
    make_camera_scene,
    sample_camera_rays,
)

RESOLUTION = 24
MAX_STEPS = 96
DEPTH_CAP = float(-np.log(1e-3))
# Distances: cells agree exactly, but the JAX CPU build contracts the plane
# sums into FMAs while the port rounds each product (as K1 does,
# --fmad=false), so t differs by an ulp or two; the weights carry that ulp
# times |den| (tests/test_torch_march.py's tolerances).
T_ATOL = 1e-5
BARY_ATOL = 1e-3
EXACT = ("cells", "valid", "num_valid", "hit", "overflow", "vids", "pos")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ball_points():
    """``tests/conftest.py``'s ``ball_points``: 400 points in a unit ball."""
    pts = np.random.default_rng(7).normal(size=(2000, 3))
    return pts[np.linalg.norm(pts, axis=1) < 2.5][:400] * 0.4


def _core_occupancy(mesh, radius=0.25):
    centroids = mesh.vertices[mesh.cells.long()].mean(dim=1)
    return torch.where(centroids.norm(dim=1) < radius, 1e4, 0.0)


def _core_rays(n=64):
    """``tests/test_skip.py``'s rays: from a radius-3 shell at the core."""
    rng = np.random.default_rng(42)
    o = rng.normal(size=(n, 3))
    o *= 3.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.3, 0.3, size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grazing_rays(n=32):
    """``tests/test_skip.py``'s miss rays: tangent lines at ~0.72 from the
    centre, several voxels clear of the dense core."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    o = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.zeros(n)], axis=1)
    tangent = np.stack([-np.sin(ang), np.cos(ang), np.zeros(n)], 1)
    d = 0.72 * tangent - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def ball():
    mesh = build_mesh(_ball_points(), device="cpu")
    setup = make_skip_setup(mesh, RESOLUTION)
    occ = _core_occupancy(mesh)
    table = build_skip_table(occ, setup)
    return dict(mesh=mesh, setup=setup, occ=occ, table=table,
                grid=mesh.with_occupancy(occ).with_skip_grid(table, setup.meta))


@pytest.fixture(scope="module")
def camera():
    """The camera scene at 800 points, a grid at G=24 over its objects'
    cells (occupancy 1e3 within 0.05 of an object sphere's surface)."""
    from tetranerf_torch.utils.synthetic import _CAM_SPHERES

    points, colors = make_camera_scene(800, seed=0)
    mesh = build_mesh(points, device="cpu")
    centroids = mesh.vertices[mesh.cells.long()].mean(dim=1).double()
    near = torch.zeros(mesh.num_cells, dtype=torch.bool)
    for c, r in _CAM_SPHERES:
        dist = (centroids - torch.from_numpy(c)).norm(dim=1)
        near |= (dist - r).abs() < 0.05
    occ = torch.where(near, 1e3, 0.0).float()
    setup = make_skip_setup(mesh, RESOLUTION)
    table = build_skip_table(occ, setup)
    o, d = sample_camera_rays(np.random.default_rng(3), 128)
    return dict(points=points, colors=colors, mesh=mesh, setup=setup, occ=occ,
                table=table, grid=mesh.with_occupancy(occ).with_skip_grid(table, setup.meta),
                origins=o, directions=d)


def _jax_mesh(points):
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh

    return jax_build_mesh(points)


def _fields(res):
    return {"cells": res.cells, "t0": res.t0, "t1": res.t1, "valid": res.valid,
            "num_valid": res.num_valid, "hit": res.hit, "overflow": res.overflow,
            "t_entry": res.t_entry, "vids": res.stream.vids, "pos": res.stream.pos,
            "bary": res.stream.bary}


def _numpy(fields):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in fields.items()}


def _assert_same_march(ours, theirs, t_atol=T_ATOL, bary_atol=BARY_ATOL):
    for name in EXACT:
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    for name in ("t0", "t1"):
        fin = np.isfinite(theirs[name])
        np.testing.assert_array_equal(np.isfinite(ours[name]), fin, err_msg=name)
        np.testing.assert_allclose(ours[name][fin], theirs[name][fin], atol=t_atol, rtol=0)
    hit = theirs["hit"]
    np.testing.assert_allclose(ours["t_entry"][hit], theirs["t_entry"][hit],
                               atol=t_atol, rtol=0)
    np.testing.assert_allclose(ours["bary"], theirs["bary"], atol=bary_atol, rtol=0)


# ------------------------------------------------------------------ host part


def test_chebyshev_distance_matches_bruteforce():
    """``tests/test_skip.py``'s case: a sparse random occupied set on 9^3."""
    rng = np.random.default_rng(0)
    occ = rng.random((9, 9, 9)) < 0.05
    occ[4, 4, 4] = True
    d = chebyshev_distance(torch.from_numpy(occ), 6).numpy()
    idx = np.argwhere(occ)
    coords = np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"), -1)
    ref = np.min(np.max(np.abs(coords[:, :, :, None, :] - idx[None, None, None]), -1),
                 axis=-1)
    np.testing.assert_array_equal(d, np.minimum(ref, 6))


def test_make_skip_setup_matches_jax(ball):
    """Every field of the setup equal to JAX's on the ``ball_points`` mesh at
    G=24: the anchors (K9's twin against ``_walk_packed``), the fallbacks,
    the vertex and centroid voxels and the meta row, bit for bit."""
    from tetranerf_tpu.ops.skip_grid import make_skip_setup as jax_setup

    ref = jax_setup(_jax_mesh(_ball_points()), resolution=RESOLUTION)
    for name in ref._fields:
        ours, theirs = getattr(ball["setup"], name).numpy(), np.asarray(getattr(ref, name))
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        np.testing.assert_array_equal(ours.view(np.int32), theirs.view(np.int32), err_msg=name)
    anchors = ball["setup"].anchors.numpy()
    assert (anchors >= 0).any() and (anchors < 0).any()  # inside and outside the hull


@pytest.mark.parametrize("kind", ["core", "random"])
def test_build_skip_table_matches_jax(ball, kind):
    """The table bit for bit: the dense core of ``tests/test_skip.py``, and
    a random EMA with values on both sides of ``skip_eps``."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.skip_grid import build_skip_table as jax_table
    from tetranerf_tpu.ops.skip_grid import make_skip_setup as jax_setup

    occ = ball["occ"]
    if kind == "random":
        rng = np.random.default_rng(1)
        occ = torch.from_numpy(np.where(rng.random(ball["mesh"].num_cells) < 0.03,
                                        rng.random(ball["mesh"].num_cells) * 2e-3, 0.0)
                               .astype(np.float32))
    ref = jax_table(jnp.asarray(occ.numpy()),
                    jax_setup(_jax_mesh(_ball_points()), resolution=RESOLUTION))
    ours = build_skip_table(occ, ball["setup"]).numpy()
    np.testing.assert_array_equal(ours.view(np.int32), np.asarray(ref).view(np.int32))
    rho = ours[..., 0]
    assert (rho == 0).any() and (rho > 0).any()


def test_locate_points_twin_matches_walk_packed(ball):
    """The point-location walk from random seeds at random points, some
    outside the hull, against JAX ``_walk_packed`` at 4 and 48 steps; the
    wrapper runs the twin on CPU tensors."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import _walk_packed

    mesh = ball["mesh"]
    rng = np.random.default_rng(2)
    points = rng.uniform(-2.0, 2.0, size=(2000, 3)).astype(np.float32)
    seeds = rng.integers(-1, mesh.num_cells, size=2000).astype(np.int32)
    table = mesh.march_table
    for steps in (4, LOCATE_STEPS):
        ref = np.asarray(_walk_packed(jnp.asarray(table.numpy()), jnp.asarray(seeds),
                                      jnp.asarray(points), steps))
        ours = locate_points_twin(table, torch.from_numpy(seeds), torch.from_numpy(points),
                                  steps).numpy()
        np.testing.assert_array_equal(ours, ref)
    assert (ref == -1).sum() > (seeds == -1).sum()  # walks that left the hull
    before = dict(cuda.launch_counts)
    wrapped = locate_points(table, torch.from_numpy(seeds), torch.from_numpy(points),
                            LOCATE_STEPS)
    assert cuda.launch_counts == before and np.array_equal(wrapped.numpy(), ref)


# ---------------------------------------------------------------- the march


def _jax_march(jmesh, occ, table, meta, o, d, use_skip=True):
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import march_features
    from tetranerf_tpu.ops.skip_grid import attach_skip_grid

    meshed = attach_skip_grid(jmesh.with_occupancy(occ.numpy()), jnp.asarray(table.numpy()),
                              jnp.asarray(meta.numpy()))
    res = march_features(meshed, None, o, d, max_steps=MAX_STEPS, use_occupancy=True,
                         use_skip=use_skip)
    return _numpy(_fields(res))


def _port_march(mesh, o, d, use_skip=True, device="cpu"):
    res = march(mesh.to(device), torch.from_numpy(o).to(device),
                torch.from_numpy(d).to(device), max_steps=MAX_STEPS, use_occupancy=True,
                use_skip=use_skip)
    return _numpy(_fields(res))


@pytest.mark.parametrize("case", ["core", "miss", "off"])
def test_twin_march_with_grid_matches_jax(ball, case):
    """The twin's march with a grid against JAX ``march_features`` with a
    grid, every field: rays at the dense core (``tests/test_skip.py:87``),
    grazing rays the trace drops (``:135``), and ``use_skip=False`` with the
    grid attached, which must equal the march without one (``:175``)."""
    o, d = _grazing_rays() if case == "miss" else _core_rays()
    use_skip = case != "off"
    ours = _port_march(ball["grid"], o, d, use_skip)
    theirs = _jax_march(_jax_mesh(_ball_points()), ball["occ"], ball["table"],
                        ball["setup"].meta, o, d, use_skip)
    _assert_same_march(ours, theirs)
    plain = _port_march(ball["mesh"].with_occupancy(ball["occ"]), o, d)
    if case == "off":
        for name, x in plain.items():
            np.testing.assert_array_equal(x.view(np.int32) if x.dtype == np.float32 else x,
                                          ours[name].view(np.int32)
                                          if x.dtype == np.float32 else ours[name])
        return
    assert ours["num_valid"].sum() < plain["num_valid"].sum()  # the trace skipped cells
    if case == "miss":  # tests/test_skip.py's bounds: ~nothing left to march
        in_hull = plain["hit"]
        assert in_hull.sum() >= 16 and plain["num_valid"][in_hull].mean() > 8
        assert ours["num_valid"][in_hull].max() <= 4


def test_twin_march_on_the_camera_scene_matches_jax(camera):
    """The camera scene, cameras inside the hull: most of each chord crosses
    empty cells between the background shell and the objects."""
    o, d = camera["origins"], camera["directions"]
    ours = _port_march(camera["grid"], o, d)
    theirs = _jax_march(_jax_mesh(camera["points"]), camera["occ"], camera["table"],
                        camera["setup"].meta, o, d)
    _assert_same_march(ours, theirs)
    plain = _port_march(camera["mesh"].with_occupancy(camera["occ"]), o, d)
    assert ours["num_valid"].mean() < plain["num_valid"].mean()


def test_march_skips_only_with_occupancy(ball):
    """No grid without occupancy termination (the bound probes), as in JAX:
    the same march as the mesh without a grid."""
    o, d = (torch.from_numpy(x) for x in _core_rays(16))
    with_grid, without = (
        march(m, o, d, max_steps=MAX_STEPS).cells
        for m in (ball["grid"], ball["mesh"].with_occupancy(ball["occ"])))
    assert torch.equal(with_grid, without)


# -------------------------------------------------------------- the trainer


CAMERA_RAYS = 64
TRAIN_STEPS = 10
REFRESH = 4


def _camera_batch(rng):
    o, d = sample_camera_rays(rng, CAMERA_RAYS)
    return {"origins": o, "directions": d, "rgb": camera_ray_targets(o, d)}


def _port_trainer(cfg, camera, jmesh=None, seed=0):
    from tetranerf_torch.models import TetraNerf
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    mesh = (TorchMesh.from_tables(jmesh, device="cpu") if jmesh is not None
            else build_mesh(camera["points"], device="cpu"))
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=camera["colors"],
                      generator=torch.Generator().manual_seed(seed), device="cpu")
    return Trainer(TrainConfig(), model, mesh, device="cpu")


def _skip_configs():
    from test_torch_train import _configs

    return _configs("float32", skip_grid_resolution=16, occupancy_refresh_every=REFRESH)


def test_trainer_with_grid_matches_jax_trainer(camera):
    """A port trainer and a JAX trainer with ``skip_grid_resolution=16`` from
    the same weights, on the same camera-scene batches with the JAX step's
    random numbers: the grid attaches at the refresh of step 4 in both,
    ``march_version`` moves by the same steps, the losses agree within rtol
    1e-4, and the attached tables are bit-equal."""
    import jax
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    from tetranerf_torch.training.checkpoints import params_from_jax
    from test_torch_train import _step_uniforms

    jcfg, cfg = _skip_configs()
    jmesh = _jax_mesh(camera["points"])
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh),
                          point_colors=camera["colors"], mesh_devices=1)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    trainer = _port_trainer(cfg, camera, jmesh)
    params_from_jax(trainer.model, params)

    rng = np.random.default_rng(4)
    batches = [_camera_batch(rng) for _ in range(TRAIN_STEPS)]
    ref, ours = [], []
    for step, batch in enumerate(batches):
        out = jtrainer.train_step(batch)
        bounds = (jtrainer.tuned_max_steps or cfg.max_intersected_triangles,
                  jtrainer.tuned_bucket_steps)
        ref.append((float(out["loss"]), jtrainer.mesh_tables.skip_table.size > 0,
                    jtrainer._march_version))
        u = _step_uniforms(jax.random.fold_in(jtrainer.train_key, step), trainer.model,
                           CAMERA_RAYS, *bounds)
        out = trainer.train_step(batch, uniforms=u)
        ours.append((float(out["loss"]), trainer.mesh.has_skip_grid, trainer.march_version))
    np.testing.assert_allclose([x[0] for x in ours], [x[0] for x in ref], rtol=1e-4, atol=0)
    attached = [x[1] for x in ours]
    assert attached == [x[1] for x in ref] == [False] * REFRESH + [True] * (TRAIN_STEPS - REFRESH)
    bumps = np.diff([x[2] for x in ours])
    assert list(bumps) == list(np.diff([x[2] for x in ref]))
    np.testing.assert_array_equal(
        trainer.mesh.skip_table.numpy().view(np.int32),
        np.asarray(jtrainer.mesh_tables.skip_table).view(np.int32))
    np.testing.assert_array_equal(trainer.mesh.skip_meta.numpy(),
                                  np.asarray(jtrainer.mesh_tables.skip_meta))


def test_collapse_guard_attaches_no_grid_on_an_empty_ema(camera):
    """While the EMA is at most ``skip_grid_eps`` everywhere no grid
    attaches and ``march_version`` stays; once it rises above, one does."""
    _, cfg = _skip_configs()
    trainer = _port_trainer(cfg, camera)
    version = trainer.march_version
    trainer.occupancy = torch.zeros(trainer.mesh.num_cells)
    trainer.occupancy[::7] = cfg.skip_grid_eps / 2
    trainer._rebuild_skip_grid()
    assert not trainer.mesh.has_skip_grid and trainer.march_version == version
    assert trainer._skip_setup is None  # nothing built either
    trainer.occupancy = camera["occ"].clone()
    trainer._rebuild_skip_grid()
    assert trainer.mesh.has_skip_grid and trainer.march_version == version + 1
    np.testing.assert_array_equal(
        trainer.mesh.skip_table.numpy().view(np.int32),
        build_skip_table(camera["occ"], make_skip_setup(trainer.mesh, 16)).numpy()
        .view(np.int32))


def test_restored_trainer_rebuilds_the_same_grid(camera, tmp_path):
    """A checkpoint carries the EMA, not the grid: a fresh trainer restored
    from it rebuilds the saved trainer's grid bit for bit, on a new mesh."""
    _, cfg = _skip_configs()
    trainer = _port_trainer(cfg, camera)
    rng = np.random.default_rng(6)
    for _ in range(REFRESH + 1):
        trainer.train_step(_camera_batch(rng))
    assert trainer.mesh.has_skip_grid
    trainer.save_checkpoint(tmp_path / "ckpt")
    fresh = _port_trainer(cfg, camera, seed=1)
    mesh_before, version = fresh.mesh, fresh.march_version
    fresh.restore_checkpoint(tmp_path / "ckpt")
    assert fresh.mesh is not mesh_before and not mesh_before.has_skip_grid
    assert fresh.march_version > version
    np.testing.assert_array_equal(fresh.mesh.skip_table.numpy().view(np.int32),
                                  trainer.mesh.skip_table.numpy().view(np.int32))
    np.testing.assert_array_equal(fresh.mesh.skip_meta.numpy(),
                                  trainer.mesh.skip_meta.numpy())


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K9 run only on the card")
    return torch.device("cuda")


def _kernel_and_twin(mesh, o, d):
    args = (mesh.march_table, mesh.hull_cells, o, d,
            *hull_intersect(mesh.hull_eqs, o, d), MAX_STEPS, MAX_STEPS, 16, True,
            DEPTH_CAP, mesh.skip_table, mesh.skip_meta)
    before = cuda.launch_counts["march"]
    ker = _numpy(_fields(march_intervals(*args)))
    assert cuda.launch_counts["march"] == before + 1
    return ker, _numpy(_fields(march_intervals_twin(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["core", "miss", "camera"])
def test_kernel_with_grid_matches_twin(ball, camera, case, cuda_device):
    """K1's sphere-trace prologue: every output of its one launch against
    the twin's, rays the trace drops included."""
    scene = camera if case == "camera" else ball
    o, d = {"core": _core_rays, "miss": _grazing_rays}.get(
        case, lambda: (camera["origins"], camera["directions"]))()
    ker, twin = _kernel_and_twin(scene["grid"].to(cuda_device),
                                 torch.from_numpy(o).to(cuda_device),
                                 torch.from_numpy(d).to(cuda_device))
    _assert_same_march(ker, twin, 1e-5, 1e-5)


@pytest.mark.cuda
def test_locate_kernel_matches_twin(ball, cuda_device):
    """K9 over the G^3 voxel centres and random points, against its twin on
    the same CUDA inputs, exactly."""
    mesh = ball["mesh"].to(cuda_device)
    rng = np.random.default_rng(2)
    points = torch.from_numpy(rng.uniform(-2.0, 2.0, size=(5000, 3)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(-1, mesh.num_cells, size=5000).astype(np.int32))
    points, seeds = points.to(cuda_device), seeds.to(cuda_device)
    before = cuda.launch_counts["locate"]
    ker = locate_points(mesh.march_table, seeds, points, LOCATE_STEPS)
    assert cuda.launch_counts["locate"] == before + 1
    twin = locate_points_twin(mesh.march_table, seeds, points, LOCATE_STEPS)
    assert torch.equal(ker, twin)
    setup = make_skip_setup(mesh, RESOLUTION)
    assert torch.equal(setup.anchors.cpu(), ball["setup"].anchors)
