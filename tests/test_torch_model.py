"""The port's TetraNerf against the JAX model on the same weights."""

import dataclasses

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh
from tetranerf_torch.models import TetraNerf, check_supported, tetranerf_preset
from tetranerf_torch.training.checkpoints import (
    load_reference_state_dict,
    params_from_jax,
    reference_state_dict,
)
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# The slice's configuration (tetra-nerf preset, ray_buckets=1) narrowed.
SMALL = dict(field_dim=16, hidden_size=32, num_samples=16, num_fine_samples=16,
             max_intersected_triangles=64, ray_buckets=1)
THRESHOLD = 1e-4


def _configs(compute_dtype, **extra):
    from tetranerf_tpu.training.presets import tetranerf_preset as jax_preset

    kw = dict(SMALL, compute_dtype=compute_dtype, **extra)
    return (dataclasses.replace(jax_preset().model, **kw),
            tetranerf_preset(**kw))


@pytest.fixture(scope="module")
def setup():
    """JAX mesh with a shell occupancy column, and JAX params whose field
    carries point colours plus noise (so every channel matters)."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh

    points, colors = make_sphere_scene(800, seed=0)
    jmesh = jax_build_mesh(points)
    centroids = np.asarray(jmesh.vertices)[np.asarray(jmesh.cells)].mean(axis=1)
    occ = np.where(np.linalg.norm(centroids, axis=1) > 0.85, 30.0, 0.0)
    jmesh = jmesh.with_occupancy(occ.astype(np.float32))
    origins, directions = sample_sphere_rays(np.random.default_rng(1), 128)
    return dict(jmesh=jmesh, mesh=TorchMesh.from_tables(jmesh, device="cpu"), colors=colors,
                origins=origins, directions=directions, jax=jax)


# JAX models, parameters and eval outputs by configuration, each computed
# once for the module (several tests share a configuration).
_JAX = {}


def _jax_model_and_params(setup, jcfg):
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf

    key = ("params", id(setup), repr(jcfg))
    if key not in _JAX:
        jax = setup["jax"]
        model = JaxTetraNerf(jcfg, setup["jmesh"])
        params = model.init_params(jax.random.PRNGKey(0), point_colors=setup["colors"])
        noise = np.random.default_rng(3).normal(
            scale=0.5, size=params["tetrahedra_field"].shape
        )
        params["tetrahedra_field"] = params["tetrahedra_field"] + noise.astype(np.float32)
        _JAX[key] = model, jax.tree_util.tree_map(np.asarray, params)
    return _JAX[key]


def _port_model(cfg, params, num_vertices):
    model = TetraNerf(cfg, num_vertices, device="cpu")
    params_from_jax(model, params)
    return model


def _jax_outputs(setup, jcfg):
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle

    key = ("outputs", id(setup), repr(jcfg))
    if key not in _JAX:
        model, params = _jax_model_and_params(setup, jcfg)
        rays = RayBundle(jnp.asarray(setup["origins"]), jnp.asarray(setup["directions"]))
        out = model.get_outputs(
            params, rays, rng=None, train=False, mesh=setup["jmesh"].on_device(),
            occ_depth_cap=float(-np.log(THRESHOLD)),
        )
        _JAX[key] = params, {k: np.asarray(v) for k, v in out.items()}
    return _JAX[key]


def _port_outputs(setup, cfg, params):
    model = _port_model(cfg, params, setup["mesh"].num_vertices)
    with torch.inference_mode():
        out = model.get_outputs(
            torch.from_numpy(setup["origins"]),
            torch.from_numpy(setup["directions"]), setup["mesh"],
        )
    return {k: v.numpy() for k, v in out.items()}


def test_params_from_jax_round_trips(setup):
    from tetranerf_tpu.training.checkpoints import (
        reference_state_dict as jax_reference_state_dict,
    )

    jcfg, cfg = _configs("float32")
    _, params = _jax_model_and_params(setup, jcfg)
    model = _port_model(cfg, params, setup["mesh"].num_vertices)
    ours = reference_state_dict(model)
    theirs = jax_reference_state_dict(params)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    other = TetraNerf(cfg, setup["mesh"].num_vertices, device="cpu")
    load_reference_state_dict(other, ours)
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)


def test_field_and_density_mlps_match_jax_at_float32(setup):
    jcfg, cfg = _configs("float32")
    jmodel, params = _jax_model_and_params(setup, jcfg)
    model = _port_model(cfg, params, setup["mesh"].num_vertices)
    rng = np.random.default_rng(4)
    fv = rng.normal(size=(8, 5, SMALL["field_dim"])).astype(np.float32)
    dirs = rng.normal(size=(8, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rgb_ref, dens_ref = jmodel._field_mlps(params, fv, dirs, None, False)
    dens_only_ref = jmodel._density_mlp(params, fv, dirs, None, False)
    with torch.inference_mode():
        rgb, dens = model.field_mlps(torch.from_numpy(fv), torch.from_numpy(dirs))
        dens_only = model.density_at(torch.from_numpy(fv))
    # f32 throughout; only the GEMM accumulation order differs.
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dens.numpy(), np.asarray(dens_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        dens_only.numpy(), np.asarray(dens_only_ref), atol=1e-5, rtol=1e-5
    )


@pytest.mark.parametrize(
    "compute_dtype, fused",
    [("float32", False), ("bfloat16", False), ("bfloat16", True)],
    ids=["float32", "bfloat16", "bfloat16-fused"],
)
def test_get_outputs_match_jax(setup, compute_dtype, fused):
    """With ``fused``, both models run the fused MLP kernels (the JAX one in
    interpret mode, the port's twins here)."""
    jcfg, cfg = _configs(compute_dtype, fused_mlps=fused)
    params, ref = _jax_outputs(setup, jcfg)
    out = _port_outputs(setup, cfg, params)
    np.testing.assert_array_equal(out["ray_mask"], ref["ray_mask"])
    np.testing.assert_array_equal(out["traversal_overflow"], ref["traversal_overflow"])
    # JAX's stream blend rounds the field rows and weights to bf16 for its
    # contraction at any compute dtype, in its model on the CPU as in the
    # eager op (its outputs equal those of a field rounded to bf16
    # beforehand); the port blends in f32. At these widths that moves rgb
    # by at most 5.7e-6 (float32) and 2.5e-5 (bfloat16, also the MLPs'
    # roundings), accumulation by 1.1e-5 and 2.7e-5: gates of 4.6-8.8x.
    gate = {"float32": 5e-5, "bfloat16": 2e-4}[compute_dtype]
    np.testing.assert_allclose(out["rgb"], ref["rgb"], atol=gate, rtol=0)
    np.testing.assert_allclose(out["accumulation"], ref["accumulation"], atol=gate, rtol=0)
    # Median depth is a sample distance: the same sample on both sides
    # when the two agree to far less than a sample spacing (~1e-2 here);
    # sample positions themselves differ by float rounding only.
    opaque = ref["accumulation"][:, 0] > 0.5
    assert opaque.sum() > 10
    same = np.isclose(out["depth"][opaque], ref["depth"][opaque], atol=1e-4, rtol=0)
    assert same.mean() >= 0.99


def test_last_sample_background_matches_jax(setup):
    jcfg, cfg = _configs("float32", background_color="last_sample")
    params, ref = _jax_outputs(setup, jcfg)
    out = _port_outputs(setup, cfg, params)
    np.testing.assert_array_equal(out["ray_mask"], ref["ray_mask"])
    # As test_get_outputs_match_jax's float32 gate (rgb here 6.3e-6 apart).
    np.testing.assert_allclose(out["rgb"], ref["rgb"], atol=5e-5, rtol=0)


def test_white_and_black_backgrounds(setup):
    outs = {}
    for color in ("white", "black"):
        cfg = tetranerf_preset(**SMALL, background_color=color)
        model = TetraNerf(cfg, setup["mesh"].num_vertices,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
        o = np.concatenate([setup["origins"][:32], np.float32([[5, 5, 5]])])
        d = np.concatenate([setup["directions"][:32], np.float32([[1, 0, 0]])])
        with torch.inference_mode():
            outs[color] = model.get_outputs(
                torch.from_numpy(o), torch.from_numpy(d), setup["mesh"]
            )
    white, black = outs["white"], outs["black"]
    assert not white["ray_mask"][-1]  # the last ray misses the scene
    assert torch.equal(white["rgb"][-1], torch.ones(3))
    assert torch.equal(black["rgb"][-1], torch.zeros(3))
    # rgb = sum(w * c) + (1 - acc) * background on every ray.
    torch.testing.assert_close(
        white["rgb"] - black["rgb"],
        (1.0 - black["accumulation"]).expand(-1, 3), atol=1e-6, rtol=0,
    )


@pytest.mark.parametrize("override, refused", [
    (dict(skip_grid_resolution=16), False),
    (dict(ray_buckets=8, bucket_merge_mlps=True), False),
    (dict(grad_stream_budget_per_ray=128), False),
    (dict(field_stream_dtype="bfloat16"), False),
    (dict(field_stream_dtype="float16"), False),
    (dict(field_stream_dtype="float8_e4m3fnuz"), False),
    (dict(field_stream_dtype="complex64"), True),
], ids=[f"override{i}" for i in range(7)])
def test_unported_settings_are_refused(override, refused):
    """The skip grid, merged-MLP buckets and both stream levers, the f16
    and float8_e4m3fnuz streams among them, are accepted and build; a
    stream dtype that JAX refuses too (complex64) raises
    ``NotImplementedError`` as JAX does."""
    cfg = tetranerf_preset(**dict(SMALL, **override))
    if not refused:
        check_supported(cfg)
        model = TetraNerf(cfg, 10, device="cpu")
        assert dataclasses.asdict(model.config) == dataclasses.asdict(cfg)
        return
    with pytest.raises(NotImplementedError):
        check_supported(cfg)
    with pytest.raises(NotImplementedError):
        TetraNerf(cfg, 10)


@pytest.mark.parametrize("hops", [0, 3])
def test_traversal_hops_other_than_one_or_two_are_refused(hops):
    cfg = tetranerf_preset(**dict(SMALL, traversal_hops=hops))
    with pytest.raises(ValueError, match="traversal_hops"):
        check_supported(cfg)
    with pytest.raises(ValueError, match="traversal_hops"):
        TetraNerf(cfg, 10)


@pytest.mark.parametrize("ray_buckets", [1, 2])
def test_two_hops_train_as_jax_two_hops_and_as_one_hop(ray_buckets):
    """``traversal_hops=2`` as ``tests/test_synthetic.py`` holds it in JAX:
    three train steps of the narrowed preset at bound 96 (so that two
    buckets split it), the occupancy EMA updated at every step, on a JAX
    mesh built with the two-hop table. With JAX's
    random numbers, the port at two hops takes the losses of the JAX
    trainer at two hops (to the trainer tests' tolerance), and the losses,
    EMA and parameters of the port at one hop exactly."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer
    from tetranerf_torch.training.trainer import TrainConfig, Trainer
    from test_torch_train import NUM_RAYS, _batch, _step_uniforms
    from test_torch_train import _configs as train_configs

    points, colors = make_sphere_scene(800, seed=0)
    jmesh = jax_build_mesh(points, two_hop_table=True)
    assert np.asarray(jmesh.march_table2).shape[0] == jmesh.num_cells
    jcfg, cfg = train_configs("float32", traversal_hops=2, ray_buckets=ray_buckets,
                              max_intersected_triangles=96, occupancy_update_every=1, occupancy_refresh_every=0,
                              occupancy_retune_every=0)
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh), point_colors=colors,
                          mesh_devices=1)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    trainers = {}
    for hops in (2, 1):
        model = TetraNerf(dataclasses.replace(cfg, traversal_hops=hops), jmesh.num_vertices,
                          device="cpu")
        params_from_jax(model, params)
        trainers[hops] = Trainer(TrainConfig(), model,
                                 TorchMesh.from_tables(jmesh, device="cpu"), device="cpu")
    rng = np.random.default_rng(13)
    losses, ref_losses = {2: [], 1: []}, []
    for step in range(3):
        batch = _batch(rng)
        ref_losses.append(float(jtrainer.train_step(batch)["loss"]))
        u = _step_uniforms(jax.random.fold_in(jtrainer.train_key, step), trainers[2].model,
                           NUM_RAYS, jtrainer.tuned_max_steps or cfg.max_intersected_triangles,
                           jtrainer.tuned_bucket_steps)
        for hops, trainer in trainers.items():
            losses[hops].append(float(trainer.train_step(batch, uniforms=u)["loss"]))
        assert trainers[2].tuned_bucket_steps == jtrainer.tuned_bucket_steps
    if ray_buckets == 2:  # the bucketed path ran: a bucket below the bound
        assert min(trainers[2].tuned_bucket_steps) < trainers[2].max_steps
    # The JAX bf16 blend moves each loss by about 1e-6 of itself
    # (test_eight_train_steps_match_jax_trainer).
    np.testing.assert_allclose(losses[2], ref_losses, rtol=1e-4, atol=0)
    assert losses[2] == losses[1]
    assert torch.equal(trainers[2].occupancy, trainers[1].occupancy)
    for a, b in zip(trainers[2].model.parameters(), trainers[1].model.parameters()):
        assert torch.equal(a, b)
