"""The serving path of the port against the JAX package: the static-camera
cache (``Trainer.cache_camera``, ``render_cached``, ``adaptive_budget``)
against the JAX trainer's and against the port's own ``render_rays``; the
viewer's camera helpers and PNG encoder; the viewer server (page, fast and
full frames, progressive bands, the march cache and its invalidation by
``march_version``, frames while another thread trains); and the steps after
which ``march_version`` advances, against the JAX trainer's."""

import dataclasses
import hashlib
import importlib
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from tetranerf_torch import viewer as port_viewer
from tetranerf_torch.geometry import TorchMesh, build_mesh
from tetranerf_torch.models import TetraNerf, tetranerf_preset
from tetranerf_torch.ops import fused
from tetranerf_torch.training.checkpoints import params_from_jax
from tetranerf_torch.training.trainer import TrainConfig, Trainer
from tetranerf_torch.utils import png
from tetranerf_torch.utils.synthetic import (
    make_sphere_scene,
    sample_sphere_rays,
    sphere_ray_targets,
)
from test_torch_train import _step_uniforms

# The module (``tetranerf_torch.ops.march`` is also the name of a function).
march_ops = importlib.import_module("tetranerf_torch.ops.march")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The tetra-nerf preset (8 buckets, occupancy) at the widths of
# tests/test_viewer.py, with its occupancy cadences shortened so that a few
# steps hold updates, a refresh and a transmittance retune.
SMALL = dict(num_samples=8, num_fine_samples=8, max_intersected_triangles=64,
             field_dim=8, hidden_size=16, compute_dtype="float32",
             occupancy_update_every=2, occupancy_refresh_every=4,
             occupancy_retune_every=4)
NUM_RAYS = 64
POSES = ([0, 2.5, 0.5], [2.5, 0.3, 0.4], [0.1, 0.0, 2.5])


def _batch(rng):
    o, d = sample_sphere_rays(rng, NUM_RAYS)
    return {"origins": o, "directions": d, "rgb": sphere_ray_targets(o, d)}


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(500, seed=3)


def _port_trainer(scene, steps=2, **overrides):
    """A port trainer on the CPU with seeded weights, after ``steps`` steps
    (the first tunes the bounds)."""
    points, colors = scene
    mesh = build_mesh(points, device="cpu")
    model = TetraNerf(tetranerf_preset(**dict(SMALL, **overrides)), mesh.num_vertices,
                      point_colors=colors, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    trainer = Trainer(TrainConfig(), model, mesh, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(steps):
        trainer.train_step(_batch(rng))
    return trainer


def _step(pair):
    """One step of both trainers on the same batch, the port fed the JAX
    step's random numbers; records whether each one's march_version moved."""
    import jax

    jt, trainer = pair["jtrainer"], pair["trainer"]
    step = trainer.step
    batch = _batch(pair["rng"])
    before = (trainer.march_version, jt.march_version)
    jt.train_step(batch)
    u = _step_uniforms(jax.random.fold_in(jt.train_key, step), trainer.model, NUM_RAYS,
                       jt.tuned_max_steps or SMALL["max_intersected_triangles"],
                       jt.tuned_bucket_steps)
    trainer.train_step(batch, uniforms=u)
    pair["advanced"].append((trainer.march_version > before[0],
                             jt.march_version > before[1]))


@pytest.fixture(scope="module")
def pair(scene):
    """The JAX trainer and the port's, on one mesh with the same weights,
    after two identical steps; and both cameras' depth-sorted caches of 96
    rays at chunk 32."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.presets import tetranerf_preset as jax_preset
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    points, colors = scene
    jmesh = jax_build_mesh(points)
    jcfg = jax_preset()
    jcfg.model = dataclasses.replace(jcfg.model, **SMALL)
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh), point_colors=colors,
                          mesh_devices=1)
    model = TetraNerf(tetranerf_preset(**SMALL), jmesh.num_vertices, device="cpu")
    params_from_jax(model, jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    trainer = Trainer(TrainConfig(), model, TorchMesh.from_tables(jmesh, device="cpu"),
                      device="cpu")
    pair = dict(jtrainer=jtrainer, trainer=trainer, rng=np.random.default_rng(13),
                advanced=[])
    for _ in range(2):
        _step(pair)
    o, d = sample_sphere_rays(np.random.default_rng(5), 96)
    pair["caches"] = (jtrainer.cache_camera(o, d, chunk=32, sort_by_depth=True),
                      trainer.cache_camera(o, d, chunk=32, sort_by_depth=True))
    return pair


# ------------------------------------------------------------- against JAX


def test_cache_camera_matches_jax(pair):
    """The depth sort's permutation, the chunks' bounds and every chunk's
    crossing counts and cells: exactly JAX's."""
    jc, pc = pair["caches"]
    np.testing.assert_array_equal(pc["perm"], jc["perm"])
    assert pc["bounds"] == list(jc["bounds"]) and len(set(pc["bounds"])) > 1
    assert (pc["chunk"], pc["num_rays"]) == (jc["chunk"], jc["num_rays"]) == (32, 96)
    for (jm, jo, jd), (pm, po, pd), t in zip(jc["chunks"], pc["chunks"], pc["bounds"]):
        assert pm.cells.shape == (32, t)
        np.testing.assert_array_equal(pm.num_valid.numpy(), np.asarray(jm.num_valid))
        np.testing.assert_array_equal(pm.cells.numpy(), np.asarray(jm.cells))
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("adaptive", [False, True], ids=["dense", "adaptive"])
def test_render_cached_matches_jax(pair, adaptive):
    """The re-shade of the sorted cache against JAX's: rgb within the
    render tolerance of tests/test_torch_model.py (JAX's stream blend
    contracts in bf16), masks equal."""
    jc, pc = pair["caches"]
    ref = pair["jtrainer"].render_cached(jc, adaptive_samples=adaptive)
    out = pair["trainer"].render_cached(pc, adaptive_samples=adaptive)
    np.testing.assert_array_equal(out["ray_mask"], np.asarray(ref["ray_mask"]))
    np.testing.assert_allclose(out["rgb"], np.asarray(ref["rgb"]), atol=2e-2, rtol=0)
    assert out["ray_mask"].sum() > 48  # the sphere fills most of the rays


@pytest.mark.parametrize("budget", [(None, None), (64, 64), (128, 0), (48, 16)])
def test_adaptive_budget_matches_jax(pair, budget):
    jc, pc = pair["caches"]
    for bounds in (pc["bounds"], [16, 48, 384, 512]):
        for ci in range(len(bounds)):
            assert pair["trainer"].adaptive_budget(bounds, ci, *budget) == \
                pair["jtrainer"].adaptive_budget(bounds, ci, *budget)


# ------------------------------------------------------ against render_rays


def test_render_cached_matches_render_rays(scene):
    """JAX's tests/test_model.py check on the port: the re-shade of an
    unsorted cache (96 rays, chunk 64) equals render_rays, and still does
    after 3 steps, which moved it."""
    trainer = _port_trainer(scene)
    o, d = sample_sphere_rays(np.random.default_rng(5), 96)
    cache = trainer.cache_camera(o, d, chunk=64)
    base = trainer.render_rays(o, d, chunk=64)
    cached = trainer.render_cached(cache)
    for k in ("rgb", "depth", "accumulation"):
        np.testing.assert_allclose(cached[k], base[k], atol=1e-6, rtol=0, err_msg=k)
    rng = np.random.default_rng(1)
    for _ in range(3):
        trainer.train_step(_batch(rng))
    after = trainer.render_cached(cache)
    np.testing.assert_allclose(after["rgb"], trainer.render_rays(o, d, chunk=64)["rgb"],
                               atol=1e-6, rtol=0)
    assert np.abs(after["rgb"] - cached["rgb"]).max() > 1e-5


def test_depth_sorted_reshade(scene, monkeypatch):
    """The sorted cache re-shaded densely equals the unsorted one; the
    adaptive re-shade stays within 30 dB of it; the sorted re-shade takes
    the plain forward (K8's wrapper is not reached), the unsorted one the
    bucketed forward."""
    trainer = _port_trainer(scene)
    o, d = sample_sphere_rays(np.random.default_rng(7), 96)
    gathers = []
    row_gather_batch = fused.row_gather_batch
    monkeypatch.setattr(fused, "row_gather_batch",
                        lambda jobs: gathers.append(len(jobs)) or row_gather_batch(jobs))
    dense = trainer.render_cached(trainer.cache_camera(o, d, chunk=32))
    assert len(gathers) == 3  # one per chunk
    scache = trainer.cache_camera(o, d, chunk=32, sort_by_depth=True)
    assert len(scache["bounds"]) == 3 and sorted(scache["perm"]) == list(range(96))
    del gathers[:]
    sorted_dense = trainer.render_cached(scache)
    adaptive = trainer.render_cached(scache, adaptive_samples=True)
    assert gathers == []
    for k in ("rgb", "depth", "accumulation"):
        np.testing.assert_allclose(sorted_dense[k], dense[k], atol=1e-5, rtol=0, err_msg=k)
    assert float(np.mean((adaptive["rgb"] - dense["rgb"]) ** 2)) < 1e-3


# ------------------------------------------------------ helpers and PNGs


@pytest.mark.parametrize("mode", ["rgb", "depth", "accumulation"])
def test_viewer_helpers_bit_equal_to_jax(mode):
    from tetranerf_tpu import viewer as jax_viewer

    rng = np.random.default_rng(4)
    out = {"rgb": rng.uniform(-0.1, 1.1, (24 * 24, 3)).astype(np.float32),
           "depth": rng.uniform(0.5, 4.0, (24 * 24, 1)).astype(np.float32),
           "accumulation": rng.uniform(0, 1, (24 * 24, 1)).astype(np.float32)}
    for pose in POSES:
        c2w = port_viewer._look_at(pose)
        np.testing.assert_array_equal(c2w, jax_viewer._look_at(pose))
        for got, want in zip(port_viewer._camera_rays(c2w, 24, 0.8),
                             jax_viewer._camera_rays(c2w, 24, 0.8)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    got = port_viewer._colorize(out, (24, 24), mode)
    want = jax_viewer._colorize(out, (24, 24), mode)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# write_png's bytes before it was built on encode_png (filter 0, 1).
_WRITE_PNG_SHA256 = {
    ((7, 5, 3), 0): "445cf315070d3b8ef54bf84278d653e5aaecef0d5f2c63ec4b75ae4286553b81",
    ((7, 5, 3), 1): "916ea4e8e9e911d1c543c1950ac127194a6f33e72b4c1d4070de354d546d03ca",
    ((6, 9, 4), 0): "55f91c5bf2dc6ac7738f46326e42fbcaab3c2dd57e8b073893b8914ee93249a8",
    ((6, 9, 4), 1): "4379e6b4641004888d159d7b40072556b1e990fcb49bb2f2ed206a9e6d6a73fb",
}


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 2), (13, 17, 3), (13, 17, 4)],
                         ids=["gray", "gray-alpha", "rgb", "rgba"])
def test_encode_png(tmp_path, shape):
    """Bytes that utils/png.py and PIL decode to the image; write_png writes
    the same bytes."""
    img = np.random.default_rng(len(shape) * 10 + shape[-1]).integers(
        0, 256, shape, dtype=np.uint8)
    for filter_type in (0, 1):
        data = png.encode_png(img, filter_type)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
        path = tmp_path / f"f{filter_type}.png"
        png.write_png(path, img, filter_type)
        assert path.read_bytes() == data
        np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(img.astype(np.float32))


def test_write_png_bytes_unchanged():
    """RGB and RGBA files byte for byte as write_png wrote them before it
    was built on encode_png."""
    rng = np.random.default_rng(0)
    for shape in ((7, 5, 3), (6, 9, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for filter_type in (0, 1):
            digest = hashlib.sha256(png.encode_png(img, filter_type)).hexdigest()
            assert digest == _WRITE_PNG_SHA256[shape, filter_type]


# ------------------------------------------------------------- the server


@pytest.fixture(scope="module")
def server(scene):
    viewer = port_viewer.ViewerServer(_port_trainer(scene), port=0, chunk=512,
                                      host="127.0.0.1").start()
    yield viewer
    viewer.stop()


def _post(viewer, body):
    req = urllib.request.Request(f"http://127.0.0.1:{viewer.port}/render",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "image/png"
        return np.asarray(Image.open(io.BytesIO(r.read())))


def test_viewer_page(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=60) as r:
        body = r.read().decode()
    assert "orbit" in body and "/render" in body


@pytest.mark.parametrize("quality", ["fast", "full"])
def test_viewer_frame(server, quality):
    img = _post(server, {"position": [0, 2.5, 0.5], "side": 32, "quality": quality})
    assert img.shape == (32, 32, 3)
    assert img[0, 0].min() > 200  # a corner ray misses: white background
    assert np.abs(img[16, 16].astype(int) - 255).max() > 0  # the sphere


@pytest.mark.parametrize("mode", ["depth", "accumulation"])
def test_viewer_gray_modes(server, mode):
    img = _post(server, {"position": [0, 2.5, 0.5], "side": 32, "quality": "fast",
                         "mode": mode})
    assert img.shape == (32, 32) and int(img[16, 16]) > int(img[0, 0])


def test_viewer_progressive_bands(server):
    """Row bands of a full frame put together give the full frame."""
    full = _post(server, {"position": [0, 2.5, 0.5], "side": 32, "quality": "full"})
    bands = [_post(server, {"position": [0, 2.5, 0.5], "side": 32, "quality": "full",
                            "rows": [y, y + 8]}) for y in range(0, 32, 8)]
    assert bands[0].shape == (8, 32, 3)
    np.testing.assert_array_equal(np.concatenate(bands), full)


def test_viewer_full_frame_hits_its_cache(server, monkeypatch):
    """The second request of a held pose re-shades its cached march: no new
    cache entry and no march; another pose gets its own entry."""
    marches = []
    march_intervals = march_ops.march_intervals
    monkeypatch.setattr(march_ops, "march_intervals",
                        lambda *a: marches.append(1) or march_intervals(*a))
    server._caches.clear()
    body = {"position": [2.5, 0, 0.3], "side": 32, "quality": "full"}
    first = _post(server, body)
    assert len(server._caches) == 1 and len(marches) == 4  # 2 chunks, 2 passes
    again = _post(server, body)
    assert len(server._caches) == 1 and len(marches) == 4
    np.testing.assert_array_equal(again, first)
    _post(server, dict(body, position=[0, 0, 2.5]))
    assert len(server._caches) == 2


def test_viewer_cache_invalidated_on_occupancy_advance(scene):
    """A march cached before an occupancy update is not re-shaded as
    current: march_version moved, the next full frame marches again, and
    its refine equals a fresh render of the rays (tests/test_viewer.py)."""
    trainer = _port_trainer(scene, steps=1, occupancy_update_every=1,
                            occupancy_refresh_every=0, occupancy_retune_every=0)
    viewer = port_viewer.ViewerServer(trainer, port=0, chunk=256)
    pos = [0, 2.5, 0.5]
    assert viewer.render_frame(pos, 16, "full")[:4] == b"\x89PNG"
    keys, version = set(viewer._caches), trainer.march_version
    rng = np.random.default_rng(1)
    for _ in range(3):
        trainer.train_step(_batch(rng))
    assert trainer.march_version > version
    viewer.render_frame(pos, 16, "full")
    assert len(viewer._caches) == 2 and set(viewer._caches) != keys
    o, d = port_viewer._camera_rays(port_viewer._look_at(pos), 16, viewer.camera_angle_x)
    cached = trainer.render_cached(trainer.cache_camera(o, d, chunk=256, sort_by_depth=True),
                                   adaptive_samples=True)
    np.testing.assert_allclose(cached["rgb"], trainer.render_rays(o, d, chunk=256)["rgb"],
                               atol=1e-5, rtol=0)


def test_viewer_frames_while_training(server):
    """Three fast frames served while another thread takes 6 steps."""
    trainer = server.trainer
    step, version = trainer.step, trainer.march_version
    rng = np.random.default_rng(2)
    batches = [_batch(rng) for _ in range(6)]

    def train():
        for b in batches:
            trainer.train_step(b)

    thread = threading.Thread(target=train)
    thread.start()
    try:
        frames = [_post(server, {"position": [2.5, 0.3, 0.4], "side": 16,
                                 "quality": "fast"}) for _ in range(3)]
    finally:
        thread.join(timeout=300)
    assert not thread.is_alive() and trainer.step == step + 6
    assert trainer.march_version > version
    assert all(f.shape == (16, 16, 3) for f in frames)


# ----------------------------------------------------- march_version


def test_march_version_advances_after_the_steps_jax_does(pair):
    """Steps 0-5 of the pair (an occupancy update every 2 steps, the
    refresh and the transmittance retune at 4): the port's counter advanced
    after exactly the steps after which JAX's did."""
    for _ in range(4):
        _step(pair)
    ours, theirs = zip(*pair["advanced"])
    assert ours == theirs == (True, False, True, False, True, False)
