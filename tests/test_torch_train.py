"""The port's train step against the JAX package: the train forward's loss
and gradients, RAdam with its schedule, and eight ``Trainer.train_step``s
from the same parameters, fed the JAX step's own random numbers."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh, build_mesh
from tetranerf_torch.models import TetraNerf, tetranerf_preset
from tetranerf_torch.training.checkpoints import params_from_jax
from tetranerf_torch.training.optim import make_optimizer, set_step
from tetranerf_torch.training.trainer import TrainConfig, Trainer
from tetranerf_torch.utils.synthetic import (
    make_sphere_scene,
    sample_sphere_rays,
    sphere_ray_targets,
)

# The slice's configuration (tetra-nerf preset, ray_buckets=1) narrowed.
SMALL = dict(field_dim=16, hidden_size=32, num_samples=16, num_fine_samples=16,
             max_intersected_triangles=64, ray_buckets=1)
THRESHOLD = 1e-4
NUM_RAYS = 64


def _batch(rng, num_rays=NUM_RAYS):
    o, d = sample_sphere_rays(rng, num_rays)
    return {"origins": o, "directions": d, "rgb": sphere_ray_targets(o, d)}


def _jax_uniforms(rng, num_rays, cfg, buckets=None):
    """The numbers the JAX train forward draws from ``rng``: the keys of
    ``TetraNerf._forward`` at the shapes of ``stratified_bins`` and
    ``pdf_sample`` (``ops/sampling.py:44``, ``:126``). With ``buckets``
    (``(K, plan)``, ``plan`` from the port's ``TetraNerf.bucket_plan``),
    those of the bucketed forward: ``rng`` split into K bucket keys
    (``models/tetra_nerf.py:513-517``), each bucket's numbers drawn at its
    own ray and sample counts; a list indexed by bucket."""
    import jax

    def draw(key, n, n_coarse, n_fine):
        k_coarse, k_fine, k_bg = jax.random.split(key, 3)
        return {
            "coarse": np.array(jax.random.uniform(k_coarse, (n, n_coarse + 1))),
            "fine": np.array(jax.random.uniform(k_fine, (n, n_fine + 1))),
            "background": np.array(jax.random.uniform(k_bg, (n, 3))),
        }

    if buckets is None:
        return draw(rng, num_rays, cfg.num_samples, cfg.num_fine_samples)
    k_buckets, plan = buckets
    keys = jax.random.split(rng, k_buckets)
    out = [None] * k_buckets
    for k, lo, hi, _, n_coarse, n_fine in plan:
        out[k] = draw(keys[k], hi - lo, n_coarse, n_fine)
    return out


def _step_uniforms(rng, model, num_rays, max_steps, bucket_steps):
    """:func:`_jax_uniforms` of a train forward of the port's ``model`` at
    these bounds: per bucket when the forward is bucketed."""
    cfg = model.config
    bounds = model.bucket_bounds(max_steps, None, bucket_steps)
    if cfg.ray_buckets < 2 or all(b >= max_steps for b in bounds):
        return _jax_uniforms(rng, num_rays, cfg)
    return _jax_uniforms(rng, num_rays, cfg, (len(bounds), model.bucket_plan(num_rays, bounds)))


def _jax_layout(model, grads=False):
    """The port's parameters (or their gradients) in the JAX package's tree
    layout."""
    def get(p):
        return (p.grad if grads else p.detach()).numpy()

    def linear(layer):
        return {"kernel": get(layer.weight).T, "bias": get(layer.bias)}

    return {
        "tetrahedra_field": get(model.tetrahedra_field),
        "mlp_base": [linear(layer) for layer in model.mlp_base.layers],
        "mlp_head": [linear(layer) for layer in model.mlp_head.layers],
        "field_output_color": linear(model.field_output_color),
        "field_output_density": linear(model.field_output_density),
    }


def _rel_err(ours, theirs):
    """Max abs difference over the max abs value of the reference."""
    theirs = np.asarray(theirs)
    return float(np.abs(np.asarray(ours) - theirs).max() / np.abs(theirs).max())


@pytest.fixture(scope="module")
def scene():
    """The 800-point sphere (JAX mesh with a shell occupancy column, as in
    tests/test_torch_model.py), its colours and a batch of 64 rays."""
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh

    points, colors = make_sphere_scene(800, seed=0)
    jmesh = jax_build_mesh(points)
    centroids = np.asarray(jmesh.vertices)[np.asarray(jmesh.cells)].mean(axis=1)
    occ = np.where(np.linalg.norm(centroids, axis=1) > 0.85, 30.0, 0.0)
    return dict(points=points, colors=colors, jmesh=jmesh,
                jmesh_occ=jmesh.with_occupancy(occ.astype(np.float32)),
                batch=_batch(np.random.default_rng(1)))


def _configs(compute_dtype, **extra):
    from tetranerf_tpu.training.presets import tetranerf_preset as jax_preset

    kw = dict(SMALL, compute_dtype=compute_dtype, **extra)
    jcfg = jax_preset()
    jcfg.model = dataclasses.replace(jcfg.model, **kw)
    return jcfg, tetranerf_preset(**kw)


# ------------------------------------------------- (d) loss and gradients


@pytest.mark.parametrize(
    "compute_dtype, fused",
    [("float32", False), ("bfloat16", False), ("bfloat16", True)],
    ids=["float32", "bfloat16", "bfloat16-fused"],
)
def test_train_forward_loss_and_gradients_match_jax(scene, compute_dtype, fused):
    """With ``fused``, both models run the fused MLP kernels forward and
    backward (the JAX ones in interpret mode, the port's twins here)."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle, TetraNerf as JaxTetraNerf

    jcfg, cfg = _configs(compute_dtype, fused_mlps=fused)
    jmesh = scene["jmesh_occ"]
    jmodel = JaxTetraNerf(jcfg.model, jmesh)
    params = jmodel.init_params(jax.random.PRNGKey(0), point_colors=scene["colors"])
    # Noise on the field so that every channel carries gradient.
    noise = np.random.default_rng(3).normal(scale=0.5, size=params["tetrahedra_field"].shape)
    params["tetrahedra_field"] = params["tetrahedra_field"] + noise.astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    b = scene["batch"]
    rng = jax.random.PRNGKey(11)
    cap = float(-np.log(THRESHOLD))

    def loss_fn(p):
        out = jmodel.get_outputs(
            p, RayBundle(jnp.asarray(b["origins"]), jnp.asarray(b["directions"])),
            rng=rng, train=True, mesh=jmesh.on_device(), occ_depth_cap=cap,
        )
        return jnp.mean(jnp.square(out["rgb"] - b["rgb"]))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(params)

    model = TetraNerf(cfg, jmesh.num_vertices, device="cpu")
    params_from_jax(model, params)
    out = model.get_outputs(
        torch.from_numpy(b["origins"]), torch.from_numpy(b["directions"]),
        TorchMesh.from_tables(jmesh, device="cpu"), occ_depth_cap=cap,
        train=True, uniforms=_jax_uniforms(rng, NUM_RAYS, cfg),
    )
    loss = model.loss(out, torch.from_numpy(b["rgb"]))
    loss.backward()
    # JAX blends endpoint features (forward and transpose) with a bf16
    # contraction even at float32 compute, and at bfloat16 also lerps
    # samples in bf16; the port computes both in f32. The PDF samples move
    # with the coarse densities, so everything downstream differs at that
    # level: tolerances are relative to each gradient's largest entry
    # (measured: MLPs within 7e-3, the field within 2.8e-2 at float32 and
    # 3.3e-2 at bfloat16; the loss within 3e-7 of itself).
    tol = {"float32": 5e-2, "bfloat16": 1e-1}[compute_dtype]
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-4 * float(loss_ref)
    ours = _jax_layout(model, grads=True)
    flat_ours = jax.tree_util.tree_leaves(ours)
    flat_ref = jax.tree_util.tree_leaves(grads_ref)
    assert len(flat_ours) == len(flat_ref) == 1 + 2 * (3 + 1) + 2 * 2
    for i, (a, r) in enumerate(zip(flat_ours, flat_ref)):
        assert a.shape == r.shape, i
        assert np.abs(np.asarray(r)).max() > 0, i
        assert _rel_err(a, r) <= tol, (i, _rel_err(a, r))


def test_train_appearance_rows_match_jax(scene):
    """With an appearance embedding, the train forward gives each ray its
    camera's row (``models/tetra_nerf.py:338-339``); eval takes the mean."""
    import jax
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf

    jcfg, cfg = _configs("float32", appearance_embed_dim=4)
    jmodel = JaxTetraNerf(jcfg.model, scene["jmesh"], num_train_images=3)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(1), point_colors=scene["colors"])
    )
    model = TetraNerf(cfg, scene["jmesh"].num_vertices, num_train_images=3, device="cpu")
    params_from_jax(model, params)
    rng = np.random.default_rng(14)
    fv = rng.normal(size=(6, 5, SMALL["field_dim"])).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cams = np.array([0, 2, 1, 1, 0, 2], np.int32)
    with torch.no_grad():
        for train, ci in ((True, cams), (False, None)):
            rgb_ref, _ = jmodel._field_mlps(params, fv, dirs, ci, train)
            rgb, _ = model.field_mlps(torch.from_numpy(fv), torch.from_numpy(dirs),
                                      None if ci is None else torch.from_numpy(ci))
            # f32 throughout; only the GEMM accumulation order differs.
            np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), atol=1e-5, rtol=0)


# --------------------------------------------------------------- (e) RAdam


def test_radam_and_schedule_match_optax():
    """Ten steps: RAdam's moments are unrectified for steps 1-5 (plain
    momentum) and rectified from step 6; the schedule decays tenfold over
    ten steps so that its evaluation point shows."""
    import jax
    import jax.numpy as jnp
    import optax
    from tetranerf_tpu.training.presets import TrainConfig as JaxTrainConfig
    from tetranerf_tpu.training.trainer import make_optimizer as jax_make_optimizer

    kw = dict(learning_rate=1e-2, learning_rate_final=1e-3, lr_max_steps=10)
    rng = np.random.default_rng(12)
    start = {"a": rng.normal(size=(5, 3)).astype(np.float32),
             "b": rng.normal(size=7).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in start.items()}
             for _ in range(10)]
    opt = jax_make_optimizer(JaxTrainConfig(**kw))
    ref = jax.tree_util.tree_map(jnp.asarray, start)
    state = opt.init(ref)
    ours = {k: torch.tensor(v, requires_grad=True) for k, v in start.items()}
    config = TrainConfig(**kw)
    optimizer = make_optimizer(list(ours.values()), config)
    for step, g in enumerate(grads):
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, ref)
        ref = optax.apply_updates(ref, updates)
        before = {k: p.detach().clone() for k, p in ours.items()}
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        set_step(optimizer, config, step)
        optimizer.step()
        for k in start:
            # Each step's update. Unrectified steps (1-5) agree to f32
            # rounding. From step 6, optax evaluates the rectification in
            # f32, where 1 - 0.999^t carries a relative error of ~1e-5 that
            # the factor (rho_t - 4) ~ 2 amplifies: r_t moves by up to ~1%
            # (torch computes it in float64). eps goes to sqrt(v_hat) in
            # optax and to sqrt(v) in torch: 1e-8 against |g| ~ 1 here.
            delta = (ours[k].detach() - before[k]).numpy()
            rtol = 1e-5 if step < 5 else 2e-2
            np.testing.assert_allclose(delta, np.asarray(updates[k]), rtol=rtol,
                                       atol=1e-7, err_msg=f"{k} step {step}")
    assert np.abs(ours["a"].detach().numpy() - start["a"]).max() > 1e-2


# ------------------------------------------------- (f) eight trainer steps


def test_eight_train_steps_match_jax_trainer(scene):
    """From the JAX trainer's initial parameters, with its random numbers:
    the tuned bound, the occupancy EMA after the step-0 update, every
    step's loss and the parameters after step 8. Occupancy is updated and
    refreshed every 4 steps here, so both run within the 8 steps."""
    import jax
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    jcfg, cfg = _configs("float32", occupancy_update_every=4, occupancy_refresh_every=4)
    jmesh = scene["jmesh"]
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh),
                          point_colors=scene["colors"], mesh_devices=1)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    model = TetraNerf(cfg, jmesh.num_vertices, device="cpu")
    params_from_jax(model, params)
    trainer = Trainer(TrainConfig(), model, TorchMesh.from_tables(jmesh, device="cpu"),
                      device="cpu")
    rng = np.random.default_rng(13)
    losses, ref_losses = [], []
    for step in range(8):
        batch = _batch(rng)
        u = _jax_uniforms(jax.random.fold_in(jtrainer.train_key, step), NUM_RAYS, cfg)
        ref_losses.append(float(jtrainer.train_step(batch)["loss"]))
        losses.append(float(trainer.train_step(batch, uniforms=u)["loss"]))
        if step == 0:
            assert trainer.tuned_max_steps == jtrainer.tuned_max_steps
            ema, ema_ref = trainer.occupancy.numpy(), np.asarray(jtrainer._occ)
            assert (ema_ref > 0).sum() > 100
            # Per-interval mean densities from bf16-interpolated (JAX) and
            # f32 (port) features; the same cells are crossed.
            np.testing.assert_array_equal(ema > 0, ema_ref > 0)
            assert _rel_err(ema, ema_ref) <= 1e-3
    assert trainer.step == 8
    # JAX's bf16 stream blend moves each loss by about 1e-6 of itself here.
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=0)
    # Parameters after 8 RAdam steps. Steps 1-5 move an entry by lr times
    # its momentum, steps 6-8 by lr * r_t * m / sqrt(v) with r_t <= 0.06,
    # so nothing moves more than ~1.5e-4. The MLPs agree to ~1% of the
    # rectified updates (optax's f32 rectification, above). A field entry
    # whose gradient is below the bf16 noise of JAX's blend can take a
    # rectified step of the other sign, up to 2 * lr * r_t: the field is
    # held to that at its maximum and four times tighter at its 99.9th
    # percentile, and its moves must correlate.
    final = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    ours = _jax_layout(model)
    field, start, ref = (p.pop("tetrahedra_field") for p in (ours, dict(params), final))
    diff = np.abs(field - ref)
    assert diff.max() <= 1.2e-4 and np.percentile(diff, 99.9) <= 3e-5
    assert np.corrcoef((field - start).ravel(), (ref - start).ravel())[0, 1] >= 0.999
    assert np.abs(ref - start).max() > 5e-5
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(final)):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


def test_train_step_draws_its_own_numbers_reproducibly():
    """Without injected uniforms the step draws from a generator seeded by
    the trainer's seed and the step count: two trainers agree."""
    points, colors = make_sphere_scene(300, seed=0)
    mesh = build_mesh(points, device="cpu")
    cfg = tetranerf_preset(**SMALL)
    losses = []
    for _ in range(2):
        model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                          generator=torch.Generator().manual_seed(0), device="cpu")
        trainer = Trainer(TrainConfig(seed=5), model, mesh, device="cpu")
        rng = np.random.default_rng(0)
        losses.append([float(trainer.train_step(_batch(rng, 32))["loss"])
                       for _ in range(3)])
    assert losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))


def test_trainer_imports_and_steps_without_jax(tmp_path):
    """The preset steps past its first retune with no JAX importable; and,
    with neither JAX, the JAX package nor Pillow importable (the GPU
    machine's installation), the CLI imports and a sphere dataset is
    written and loaded."""
    code = """
import sys
for blocked in ("jax", "tetranerf_tpu", "PIL"):
    sys.modules[blocked] = None  # any import of it now raises ImportError
import numpy as np, torch
torch.set_num_threads(1)  # the suite's workers share few cores
from tetranerf_torch import TetraNerf, TrainConfig, Trainer, build_mesh, tetranerf_preset
from tetranerf_torch.utils.synthetic import (make_sphere_scene, sample_sphere_rays,
                                             sphere_ray_targets)
points, colors = make_sphere_scene(300, seed=0)
mesh = build_mesh(points, device="cpu")
# The preset as it ships (8 buckets, the retune at step 128), narrowed.
cfg = tetranerf_preset(field_dim=8, hidden_size=16, num_samples=8, num_fine_samples=8,
                       max_intersected_triangles=64)
assert cfg.ray_buckets == 8 and cfg.occupancy_retune_every == 128
model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                  generator=torch.Generator().manual_seed(0), device="cpu")
o, d = sample_sphere_rays(np.random.default_rng(0), 16)
trainer = Trainer(TrainConfig(), model, mesh, device="cpu")
batch = {"origins": o, "directions": d, "rgb": sphere_ray_targets(o, d)}
for _ in range(130):
    metrics = trainer.train_step(batch)
    assert np.isfinite(float(metrics["loss"]))
assert trainer.step == 130 and len(trainer.tuned_bucket_steps) == 7
assert len(trainer._cap_history) == 1  # the retune at step 128 ran
assert np.isfinite(trainer.render_rays(o, d, chunk=8)["rgb"]).all()
import tetranerf_torch.training.cli
from tetranerf_torch.training.datasets import load_dataset
from tetranerf_torch.utils.synthetic_dataset import write_sphere_dataset
write_sphere_dataset(sys.argv[1], side=16, train=3, test=2, points=300)
for split, n in (("train", 3), ("test", 2)):
    ds = load_dataset(sys.argv[1], split)
    assert ds.images.shape == (n, 16, 16, 3) and ds.images.dtype == np.float32
    assert 0.0 <= ds.images.min() and ds.images.max() <= 1.0 and ds.images.min() < 1.0
leaked = [m for m in sys.modules if m.startswith(("jax", "tetranerf_tpu", "PIL"))
          and sys.modules[m] is not None]
assert not leaked, leaked
print("OK")
"""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "sphere")], capture_output=True,
        text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert "# retune@128: bound=" in proc.stderr


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (build_mesh, TorchMesh.from_tables, TetraNerf, Trainer):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
