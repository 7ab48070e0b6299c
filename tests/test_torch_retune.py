"""The trainer's bound retunes against the JAX trainer: the bucket
statistics, the cold tune's bucket bounds, the transmittance retune (main
bound, bucket bounds, the calibrated termination cap) over a short run, and
the port's counterparts of the JAX behaviour tests of the retunes."""

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh, build_mesh
from tetranerf_torch.models import TetraNerf, tetranerf_preset
from tetranerf_torch.render import Renderer
from tetranerf_torch.training import trainer as port_trainer
from tetranerf_torch.training.checkpoints import params_from_jax
from tetranerf_torch.training.trainer import TrainConfig, Trainer
from tetranerf_torch.utils.synthetic import (
    make_sphere_scene,
    sample_sphere_rays,
    sphere_ray_targets,
)
from test_torch_train import _batch, _configs, _step_uniforms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

NUM_RAYS = 64


# ------------------------------------------------------- the statistics


@pytest.mark.parametrize("k_buckets, percentile, margin", [
    (4, 100.0, 1.15), (8, 100.0, 1.5), (8, 99.0, 1.15), (3, 50.0, 1.15),
])
def test_bucket_statistics_match_jax(k_buckets, percentile, margin):
    """The numpy helpers are copies: equal on the same crossing counts,
    ties at the bound included."""
    from tetranerf_tpu.training import trainer as jax_trainer

    rng = np.random.default_rng(k_buckets)
    nv = np.minimum(rng.geometric(0.02, 1000), 256).astype(np.int32)
    need = np.minimum(nv, rng.integers(0, 300, 1000)).astype(np.int32)
    assert port_trainer.quantile_bucket_stats(nv, k_buckets, percentile) == \
        jax_trainer._quantile_bucket_stats(nv, k_buckets, percentile)
    assert port_trainer.ranked_chunk_stats(nv, need, k_buckets, percentile) == \
        jax_trainer._ranked_chunk_stats(nv, need, k_buckets, percentile)
    stats = port_trainer.quantile_bucket_stats(need, k_buckets, percentile)
    for full in (64, 256):
        assert port_trainer.bounds_from_stats(stats, full, margin) == \
            jax_trainer._bounds_from_stats(stats, full, margin)
        assert port_trainer.quantile_bucket_bounds(nv, k_buckets, full, percentile, margin) \
            == jax_trainer._quantile_bucket_bounds(nv, k_buckets, full, percentile, margin)


# ------------------------------------------- a short run against JAX


@pytest.fixture(scope="module")
def scene():
    """The 800-point sphere of ``tests/test_torch_train.py``."""
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh

    points, colors = make_sphere_scene(800, seed=0)
    return dict(colors=colors, jmesh=jax_build_mesh(points))


def test_nine_steps_with_two_retunes_match_jax_trainer(scene, capfd):
    """Four-bucket shading at bound 96, occupancy updated and refreshed
    every 4 steps and the transmittance retune at steps 4 and 8, from the
    JAX trainer's initial parameters with a density bias of 8 (so that
    rays exhaust their light mid-chord, the EMA learns it and the cap
    calibrates above its floor), and with its random numbers (per bucket,
    at the bounds of each step): the same main bound, bucket bounds and cap
    after the cold tune and after each retune, every loss held as in
    ``test_eight_train_steps_match_jax_trainer``, and the renders after
    the run at the tuned bounds and cap."""
    import jax
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    jcfg, cfg = _configs("float32", ray_buckets=4, max_intersected_triangles=96,
                         occupancy_update_every=4, occupancy_refresh_every=4,
                         occupancy_retune_every=4)
    jmesh = scene["jmesh"]
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh),
                          point_colors=scene["colors"], mesh_devices=1)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    params["field_output_density"]["bias"] = np.full_like(
        params["field_output_density"]["bias"], 8.0)
    jtrainer.state = jtrainer.state.replace(
        params=jax.device_put(params, jtrainer._params_sharding))
    model = TetraNerf(cfg, jmesh.num_vertices, device="cpu")
    params_from_jax(model, params)
    trainer = Trainer(TrainConfig(), model, TorchMesh.from_tables(jmesh, device="cpu"),
                      device="cpu")
    rng = np.random.default_rng(13)
    losses, ref_losses, bounds = [], [], []
    for step in range(9):
        batch = _batch(rng)
        ref_losses.append(float(jtrainer.train_step(batch)["loss"]))
        u = _step_uniforms(jax.random.fold_in(jtrainer.train_key, step), model, NUM_RAYS,
                           jtrainer.tuned_max_steps or cfg.max_intersected_triangles,
                           jtrainer.tuned_bucket_steps)
        losses.append(float(trainer.train_step(batch, uniforms=u)["loss"]))
        bounds.append(trainer.tuned_bucket_steps)
        assert trainer.tuned_max_steps == jtrainer.tuned_max_steps, step
        assert trainer.tuned_bucket_steps == jtrainer.tuned_bucket_steps, step
        # The EMA's depths the cap is sized from agree to ~1e-3 (the
        # occupancy update's tolerance in test_torch_train.py).
        np.testing.assert_allclose(trainer.occ_depth_cap, jtrainer._occ_cap, rtol=2e-3)
    assert len(trainer._cap_history) == len(jtrainer._cap_history) == 2
    assert bounds[0] is not None and max(bounds[0]) < 96  # the cold tune buckets
    assert bounds[-1] != bounds[0] and trainer.tuned_max_steps < 96  # the retunes moved them
    assert trainer.occ_depth_cap > -np.log(cfg.occupancy_threshold)
    # The JAX bf16 blend moves each loss by about 1e-6 of itself.
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=0)
    err = capfd.readouterr().err
    assert err.count("# retune@4: bound=") == 2 and err.count("# retune@8: bound=") == 2

    o, d = sample_sphere_rays(np.random.default_rng(21), 96)
    out = trainer.render_rays(o, d, chunk=48)
    ref = jtrainer.render_rays(o, d, chunk=48)
    np.testing.assert_array_equal(out["ray_mask"], np.asarray(ref["ray_mask"]))
    np.testing.assert_array_equal(out["traversal_overflow"],
                                  np.asarray(ref["traversal_overflow"]))
    # The blend's bf16 contraction in JAX, as in test_torch_model.py.
    np.testing.assert_allclose(out["rgb"], np.asarray(ref["rgb"]), atol=2e-2, rtol=0)
    batch_out = trainer.eval_batch({"origins": o[:48], "directions": d[:48]})
    np.testing.assert_array_equal(batch_out["rgb"].numpy(), out["rgb"][:48])


# ----------------------------------------- the JAX behaviour tests


def _small_trainer(**overrides):
    """The port's counterpart of ``tests/test_model.py``'s set-up: the
    600-point sphere, the narrowed config at bound 96, f32 MLPs, the retunes
    driven by hand; one step on 64 rays (the cold tune)."""
    points, colors = make_sphere_scene(600, seed=1)
    mesh = build_mesh(points, device="cpu")
    cfg = tetranerf_preset(num_samples=24, num_fine_samples=16, max_intersected_triangles=96,
                           field_dim=16, hidden_size=32, compute_dtype="float32",
                           occupancy_retune_every=0, **overrides)
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    trainer = Trainer(TrainConfig(), model, mesh, device="cpu")
    o, d = sample_sphere_rays(np.random.default_rng(7), 64)
    batch = {"origins": o, "directions": d, "rgb": sphere_ray_targets(o, d)}
    trainer.train_step(batch)
    return trainer, batch


def _set_occupancy(trainer, value):
    trainer.occupancy = torch.full((trainer.mesh.num_cells,), float(value))
    trainer._write_occupancy()


@pytest.mark.parametrize("ray_buckets", [1, 4])
def test_transmittance_retune_shrinks_and_regrows_bound(ray_buckets):
    """An opaque model (density bias +200) shrinks the bound, a transparent
    one (-200) grows it back, with a cold EMA (``tests/test_model.py:533``)."""
    trainer, batch = _small_trainer(ray_buckets=ray_buckets)
    cold = trainer.max_steps

    def with_density_bias(v):
        with torch.no_grad():
            trainer.model.field_output_density.bias.fill_(v)

    with_density_bias(200.0)
    shrunk = trainer.retune_with_transmittance(batch)
    assert shrunk < cold
    if ray_buckets > 1:
        bs = trainer.tuned_bucket_steps
        assert len(bs) == 3 and all(16 <= b <= shrunk for b in bs)
        assert all(b1 <= b2 for b1, b2 in zip(bs, bs[1:]))
    metrics = trainer.train_step(batch)  # runs at the tight bound
    assert np.isfinite(float(metrics["loss"])) and "overflow_rays" in metrics
    with_density_bias(-200.0)
    regrown = trainer.retune_with_transmittance(batch)
    assert regrown > shrunk


def test_occupancy_retune_shrinks_and_regrows_bound():
    """``occupancy_retune_mode="march"``: a dense EMA (50 everywhere) shrinks
    the bound with no overflow after it; an EMA at 0 grows it back
    (``tests/test_model.py:430``)."""
    trainer, batch = _small_trainer(occupancy_retune_mode="march")
    cold = trainer.max_steps
    _set_occupancy(trainer, 50.0)
    shrunk = trainer.retune_with_occupancy(batch)
    assert shrunk < cold
    assert int(trainer.train_step(batch)["overflow_rays"]) == 0
    _set_occupancy(trainer, 0.0)
    regrown = trainer.retune_with_occupancy(batch)
    assert regrown > shrunk


def test_termination_cap_calibrates_to_estimator_bias():
    """A zero EMA leaves the cap at the floor ``-log(threshold)``; an EMA at
    1000 (far above any real density) lifts it above 10x the floor
    (``tests/test_model.py:574``)."""
    trainer, batch = _small_trainer()
    floor = -np.log(trainer.model.config.occupancy_threshold)
    _set_occupancy(trainer, 0.0)
    trainer.retune_with_transmittance(batch)
    np.testing.assert_allclose(trainer.occ_depth_cap, floor)
    _set_occupancy(trainer, 1000.0)
    trainer.retune_with_transmittance(batch)
    assert trainer.occ_depth_cap > 10 * floor


def test_every_reader_takes_the_calibrated_cap(monkeypatch):
    """The train forward, the occupancy update, the march probe and the
    renders all march with the trainer's one cap once a retune has set it."""
    trainer, batch = _small_trainer(ray_buckets=4)
    _set_occupancy(trainer, 1000.0)
    trainer.retune_with_transmittance(batch)
    cap = trainer.occ_depth_cap
    seen = []
    real = port_trainer.march

    def spy(*args, **kwargs):
        seen.append(kwargs.get("occ_depth_cap"))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_trainer, "march", spy)
    from tetranerf_torch.ops import fused

    real_mf = fused.march

    def spy_mf(*args):
        seen.append(args[7] if len(args) > 7 else None)
        return real_mf(*args)

    monkeypatch.setattr(fused, "march", spy_mf)
    trainer.update_occupancy(batch)
    trainer._march_nv(*trainer._probe_rays(batch))
    trainer.train_step(batch)
    trainer.render_rays(batch["origins"], batch["directions"], chunk=64)
    assert len(seen) >= 4 and all(c == cap for c in seen), (seen, cap)
    r = trainer.renderer()
    assert (r.occ_depth_cap, r.max_steps, r.bucket_steps) == (
        cap, trainer.max_steps, trainer.tuned_bucket_steps)


def test_renderer_without_a_trainer_uses_the_untuned_split():
    trainer, batch = _small_trainer(ray_buckets=4)
    o = torch.from_numpy(batch["origins"])
    d = torch.from_numpy(batch["directions"])
    out = Renderer(trainer.model, trainer.mesh, "cpu").render_rays(o, d, chunk=64)
    with torch.inference_mode():
        ref = trainer.model.get_outputs(o, d, trainer.mesh, bucket_steps=(24, 48, 72))
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k].numpy(), err_msg=k)
    # num_samples / num_fine_samples pass straight through.
    fast = trainer.render_rays(o, d, chunk=64, num_samples=8, num_fine_samples=0)
    with torch.inference_mode():
        ref = trainer.model.get_outputs(
            o, d, trainer.mesh, max_steps=trainer.max_steps, num_samples=8,
            num_fine_samples=0, occ_depth_cap=trainer.occ_depth_cap,
            bucket_steps=trainer.tuned_bucket_steps)
    np.testing.assert_array_equal(fast["rgb"], ref["rgb"].numpy())
