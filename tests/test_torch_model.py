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


def _jax_model_and_params(setup, jcfg):
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf

    jax = setup["jax"]
    model = JaxTetraNerf(jcfg, setup["jmesh"])
    params = model.init_params(jax.random.PRNGKey(0), point_colors=setup["colors"])
    noise = np.random.default_rng(3).normal(
        scale=0.5, size=params["tetrahedra_field"].shape
    )
    params["tetrahedra_field"] = params["tetrahedra_field"] + noise.astype(np.float32)
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(cfg, params, num_vertices):
    model = TetraNerf(cfg, num_vertices, device="cpu")
    params_from_jax(model, params)
    return model


def _jax_outputs(setup, jcfg):
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle

    model, params = _jax_model_and_params(setup, jcfg)
    rays = RayBundle(jnp.asarray(setup["origins"]), jnp.asarray(setup["directions"]))
    out = model.get_outputs(
        params, rays, rng=None, train=False, mesh=setup["jmesh"].on_device(),
        occ_depth_cap=float(-np.log(THRESHOLD)),
    )
    return params, {k: np.asarray(v) for k, v in out.items()}


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
    # JAX blends endpoint features with a bf16 contraction (Pallas
    # stream_blend) even at float32 compute, and at bfloat16 it also
    # interpolates samples in bf16; the port computes both in f32.
    np.testing.assert_allclose(out["rgb"], ref["rgb"], atol=2e-2, rtol=0)
    np.testing.assert_allclose(out["accumulation"], ref["accumulation"], atol=2e-2, rtol=0)
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
    np.testing.assert_allclose(out["rgb"], ref["rgb"], atol=2e-2, rtol=0)


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


@pytest.mark.parametrize("override", [
    dict(traversal_hops=2),
    dict(ray_buckets=8),
    dict(grad_stream_budget_per_ray=128),
    dict(field_stream_dtype="bfloat16"),
])
def test_unported_settings_are_refused(override):
    cfg = tetranerf_preset(**dict(SMALL, **override))
    with pytest.raises(NotImplementedError):
        check_supported(cfg)
    with pytest.raises(NotImplementedError):
        TetraNerf(cfg, 10)
