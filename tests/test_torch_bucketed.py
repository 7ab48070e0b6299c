"""Quantile-bucketed shading (``ray_buckets >= 2``) against the JAX model:
the march slice (K8's path, one bucket and all buckets of a plan in one
batch), the bucket bounds and budgets, the eval forward and the train
forward's loss and gradients; every bucket's endpoint features in one
batch (K2's path), and a cached march's stale features recomputed."""

import dataclasses

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh
from tetranerf_torch.models import TetraNerf, tetranerf_preset
from tetranerf_torch.ops.fused import march_features, slice_march, slice_march_buckets
from tetranerf_torch.ops.march import FusedMarch, MarchStream
from tetranerf_torch.training.checkpoints import params_from_jax
from tetranerf_torch.utils.shapes import inner_bound, scaled_budget
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays
from test_torch_train import _jax_layout, _rel_err, _step_uniforms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# The tetra-nerf preset narrowed, with 4 buckets.
SMALL = dict(field_dim=16, hidden_size=32, num_samples=16, num_fine_samples=16,
             max_intersected_triangles=64, ray_buckets=4)
THRESHOLD = 1e-4
CAP = float(-np.log(THRESHOLD))
K = SMALL["ray_buckets"]


def _configs(compute_dtype="float32", **extra):
    from tetranerf_tpu.training.presets import tetranerf_preset as jax_preset

    kw = dict(SMALL, compute_dtype=compute_dtype, **extra)
    return dataclasses.replace(jax_preset().model, **kw), tetranerf_preset(**kw)


@pytest.fixture(scope="module")
def setup():
    """The 800-point sphere with a shell occupancy column (crossing counts
    3-50 under the cap), 128 rays, and JAX parameters whose field carries
    point colours plus noise."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf

    points, colors = make_sphere_scene(800, seed=0)
    jmesh = jax_build_mesh(points)
    centroids = np.asarray(jmesh.vertices)[np.asarray(jmesh.cells)].mean(axis=1)
    occ = np.where(np.linalg.norm(centroids, axis=1) > 0.85, 30.0, 0.0)
    jmesh = jmesh.with_occupancy(occ.astype(np.float32))
    mesh = TorchMesh.from_tables(jmesh, device="cpu")
    origins, directions = sample_sphere_rays(np.random.default_rng(1), 128)
    jcfg, _ = _configs()
    params = JaxTetraNerf(jcfg, jmesh).init_params(jax.random.PRNGKey(0),
                                                   point_colors=colors)
    noise = np.random.default_rng(3).normal(scale=0.5, size=params["tetrahedra_field"].shape)
    params["tetrahedra_field"] = params["tetrahedra_field"] + noise.astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    # Each quantile chunk's deepest crossing count under the cap: covering
    # inner bounds, below the bound 64 (so the bucketed path runs).
    nv = march_features(mesh, None, torch.from_numpy(origins),
                        torch.from_numpy(directions), 64, use_occupancy=True,
                        occ_depth_cap=CAP).num_valid.numpy()
    snv = np.sort(nv)
    covering = tuple(int(snv[: len(snv) * (k + 1) // K].max()) for k in range(K - 1))
    assert max(covering) < 64
    return dict(jmesh=jmesh, mesh=mesh, origins=origins, directions=directions,
                params=params, covering=covering, nv=nv)


def _jax_model(setup, jcfg):
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf

    return JaxTetraNerf(jcfg, setup["jmesh"])


def _port_model(setup, cfg):
    model = TetraNerf(cfg, setup["mesh"].num_vertices, device="cpu")
    params_from_jax(model, setup["params"])
    return model


def _to_port(jres) -> FusedMarch:
    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    s = jres.stream
    return FusedMarch(
        cells=t(jres.cells), t1=t(jres.t1), t_entry=t(jres.t_entry),
        valid=t(jres.valid), num_valid=t(jres.num_valid), feats=None,
        hit=t(jres.hit), overflow=t(jres.overflow),
        stream=MarchStream(vids=t(s.vids), pos=t(s.pos), bary=t(s.bary)),
        t0s=t(jres.t0s),
    )


# ---------------------------------------------------------- the slice


@pytest.mark.parametrize("t", [64, 20])
def test_march_matches_jax_field_by_field(setup, t):
    """The march that the slices cut, the port's (its twin here) against
    JAX ``march_features`` under the shell column and the cap: every field
    of the layout K1 writes, with its dtype; the distances within 1e-5
    (the JAX CPU build contracts plane sums into FMAs), the weights within
    1e-3 (an ulp of t times a sliver cell's rate), the rest exact."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import march_features as jax_march_features

    jres = jax_march_features(
        setup["jmesh"].on_device(), None, jnp.asarray(setup["origins"]),
        jnp.asarray(setup["directions"]), t, use_occupancy=True,
        occ_threshold=THRESHOLD, occ_depth_cap=CAP,
    )
    ref = _to_port(jres)
    out = march_features(setup["mesh"], None, torch.from_numpy(setup["origins"]),
                         torch.from_numpy(setup["directions"]), t, use_occupancy=True,
                         occ_depth_cap=CAP)
    assert out.feats is None and ref.feats is None
    pairs = [(name, getattr(out, name), getattr(ref, name)) for name in
             ("cells", "t1", "t0s", "t_entry", "valid", "num_valid", "hit", "overflow")]
    pairs += [(name, getattr(out.stream, name), getattr(ref.stream, name))
              for name in ("vids", "pos", "bary")]
    for name, a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in ("t1", "t0s", "t_entry"):
            a, b = a[ref.hit], b[ref.hit]
            np.testing.assert_array_equal(torch.isfinite(a).numpy(), torch.isfinite(b).numpy())
            fin = torch.isfinite(b)
            np.testing.assert_allclose(a[fin].numpy(), b[fin].numpy(), atol=1e-5, rtol=0)
        elif name == "bary":
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3, rtol=0)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    if t == 20:
        assert out.overflow.any()


@pytest.mark.parametrize("t", [5, 16, 40, 64, 80])
def test_slice_march_matches_jax_field_by_field(setup, t):
    """The same march cut by both: a copy, so every field is equal bit for
    bit, truncation folded into ``overflow`` and ``num_valid`` recounted."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import _slice_march
    from tetranerf_tpu.ops.fused import march_features as jax_march_features

    jres = jax_march_features(
        setup["jmesh"].on_device(), None, jnp.asarray(setup["origins"]),
        jnp.asarray(setup["directions"]), 64, use_occupancy=True,
        occ_threshold=THRESHOLD, occ_depth_cap=CAP,
    )
    idx = np.random.default_rng(t).permutation(128)[:50].astype(np.int32)
    ref = _slice_march(jres, jnp.asarray(idx), t)
    out = slice_march(_to_port(jres), torch.from_numpy(idx), t)
    assert out.feats is None and ref.feats is None
    for name in ("cells", "t1", "t_entry", "valid", "num_valid", "hit", "overflow", "t0s"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
        assert getattr(out, name).dtype == torch.from_numpy(
            np.array(getattr(ref, name))).dtype, name
    for name in ("vids", "pos", "bary"):
        np.testing.assert_array_equal(getattr(out.stream, name).numpy(),
                                      np.asarray(getattr(ref.stream, name)), err_msg=name)
    if t < 40:
        assert out.overflow.any()  # deep rays lose their tails


def test_slice_march_buckets_matches_jax_for_every_bucket(setup):
    """One batch cuts all 8 buckets of a plan (quantile chunks of the
    crossing-count order, truncating and covering bounds, the last at the
    full bound): each bucket equal field by field to JAX ``_slice_march``
    of its rays, and the rays' origins and directions ride along."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import _slice_march
    from tetranerf_tpu.ops.fused import march_features as jax_march_features

    jres = jax_march_features(
        setup["jmesh"].on_device(), None, jnp.asarray(setup["origins"]),
        jnp.asarray(setup["directions"]), 64, use_occupancy=True,
        occ_threshold=THRESHOLD, occ_depth_cap=CAP,
    )
    res = _to_port(jres)
    _, cfg = _configs(ray_buckets=8)
    model = _port_model(setup, cfg)
    bounds = model.bucket_bounds(64, None, (4, 8, 12, 16, 24, 32, 48))
    order = torch.argsort(res.num_valid, stable=True)
    plan = model.bucket_plan(128, bounds)
    assert len(plan) == 8
    rays = (torch.from_numpy(setup["origins"]), torch.from_numpy(setup["directions"]))
    slices = slice_march_buckets(res, order, plan, rays)
    assert len(slices) == len(plan)
    for (_, lo, hi, t, *_), (out, (o_k, d_k)) in zip(plan, slices):
        idx = order[lo:hi]
        ref = _slice_march(jres, jnp.asarray(idx.numpy().astype(np.int32)), t)
        assert out.feats is None
        for name in ("cells", "t1", "t_entry", "valid", "num_valid", "hit", "overflow",
                     "t0s"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=f"{name} at bound {t}")
            assert getattr(out, name).dtype == torch.from_numpy(
                np.array(getattr(ref, name))).dtype, name
        for name in ("vids", "pos", "bary"):
            np.testing.assert_array_equal(getattr(out.stream, name).numpy(),
                                          np.asarray(getattr(ref.stream, name)),
                                          err_msg=f"{name} at bound {t}")
        assert torch.equal(o_k, rays[0][idx]) and torch.equal(d_k, rays[1][idx])
    assert any(sl.overflow.any() for sl, _ in slices[:-1])  # inner bounds truncate


def test_slice_march_is_the_one_bucket_case(setup):
    """``slice_march`` gives what ``slice_march_buckets`` gives for a plan
    of one bucket holding exactly those rays."""
    res = march_features(setup["mesh"], None, torch.from_numpy(setup["origins"]),
                         torch.from_numpy(setup["directions"]), 64, use_occupancy=True,
                         occ_depth_cap=CAP)
    idx = torch.from_numpy(np.random.default_rng(4).permutation(128)[:40])
    one = slice_march(res, idx, 20)
    (batch, rays), = slice_march_buckets(res, idx, [(0, 0, 40, 20)])
    assert rays == []
    for a, b in zip(one, batch):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        elif a is not None:
            assert torch.equal(a, b)


# ---------------------------------------------------- bounds and budgets


@pytest.mark.parametrize("max_steps, short, bucket_steps, k_buckets", [
    (64, None, None, 4), (384, None, None, 8), (40, None, None, 4),
    (256, 40, None, 8), (96, None, (8, 200, 30), 4), (512, None, (48, 96, 96, 128, 200, 256, 300), 8),
    (64, None, (20, 30, 40, 50, 60), 4),
])
def test_bucket_bounds_match_jax(setup, max_steps, short, bucket_steps, k_buckets):
    jcfg, cfg = _configs(ray_buckets=k_buckets)
    ref = _jax_model(setup, jcfg)._bucket_bounds(max_steps, short, bucket_steps)
    assert _port_model(setup, cfg).bucket_bounds(max_steps, short, bucket_steps) == ref


def test_bounds_and_budgets_match_the_jax_shape_policy():
    from tetranerf_tpu.utils import shapes

    for n in (0, 3, 13.9, 14, 16, 57, 101, 217, 384, 1000):
        assert inner_bound(n) == shapes.inner_bound(n)
        assert inner_bound(n, 1.5) == shapes.inner_bound(n, 1.5)
    for base in (0, 16, 128):
        for t in (16, 40, 100, 384):
            assert scaled_budget(base, t, 384) == shapes.scaled_budget(base, t, 384)


def test_bucket_plan_splits_equal_quantile_chunks(setup):
    _, cfg = _configs(ray_buckets=8, num_samples=128, num_fine_samples=128)
    model = _port_model(setup, cfg)
    plan = model.bucket_plan(4096, (48, 64, 96, 128, 160, 200, 256, 384))
    assert [(lo, hi) for _, lo, hi, *_ in plan] == [(512 * k, 512 * (k + 1)) for k in range(8)]
    assert [p[4] for p in plan] == [scaled_budget(128, t, 384) for t in
                                    (48, 64, 96, 128, 160, 200, 256, 384)]
    assert [k for k, *_ in model.bucket_plan(3, (16, 16, 32, 64))] == [1, 2, 3]


# ------------------------------------------------------ the eval forward


# The eval forwards of this module's setup by configuration and bounds,
# each computed once (several tests compare against the same one).
_JAX_REFS, _PORT_OUTS = {}, {}


def _jax_eval(setup, jcfg, bucket_steps):
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle

    key = (id(setup), repr(jcfg), bucket_steps)
    if key not in _JAX_REFS:
        rays = RayBundle(jnp.asarray(setup["origins"]), jnp.asarray(setup["directions"]))
        ref = _jax_model(setup, jcfg).get_outputs(
            setup["params"], rays, rng=None, train=False, mesh=setup["jmesh"].on_device(),
            occ_depth_cap=CAP, bucket_steps=bucket_steps,
        )
        _JAX_REFS[key] = {k: np.asarray(v) for k, v in ref.items()}
    return _JAX_REFS[key]


def _port_eval(setup, cfg, bucket_steps):
    key = (id(setup), repr(cfg), bucket_steps)
    if key not in _PORT_OUTS:
        with torch.inference_mode():
            out = _port_model(setup, cfg).get_outputs(
                torch.from_numpy(setup["origins"]), torch.from_numpy(setup["directions"]),
                setup["mesh"], occ_depth_cap=CAP, bucket_steps=bucket_steps,
            )
        _PORT_OUTS[key] = {k: v.numpy() for k, v in out.items()}
    return _PORT_OUTS[key]


def _eval(setup, jcfg, cfg, bucket_steps):
    return _port_eval(setup, cfg, bucket_steps), _jax_eval(setup, jcfg, bucket_steps)


def _plain(setup):
    """The unbucketed eval forward (``ray_buckets=1``) of the port."""
    return _port_eval(setup, _configs(ray_buckets=1)[1], None)


def _assert_close_to_jax(out, ref):
    np.testing.assert_array_equal(out["ray_mask"], ref["ray_mask"])
    np.testing.assert_array_equal(out["traversal_overflow"], ref["traversal_overflow"])
    # As in test_torch_model.py: JAX's stream blend rounds the field rows
    # and weights to bf16 (in its model on the CPU as in the eager op), the
    # port blends in f32: rgb at most 5.7e-6 and accumulation 1.1e-5 apart
    # in these float32 cases, so gates of 4.6-8.8x.
    np.testing.assert_allclose(out["rgb"], ref["rgb"], atol=5e-5, rtol=0)
    np.testing.assert_allclose(out["accumulation"], ref["accumulation"], atol=5e-5, rtol=0)


def test_covering_buckets_match_jax_and_the_unbucketed_forward(setup):
    """Bounds that cover each chunk and unscaled budgets: the bucketed
    forward computes the unbucketed one (as ``tests/test_model.py:323-373``
    holds for JAX)."""
    jcfg, cfg = _configs(bucket_adaptive_samples=False)
    out, ref = _eval(setup, jcfg, cfg, setup["covering"])
    _assert_close_to_jax(out, ref)
    assert not out["traversal_overflow"].any()
    plain = _plain(setup)
    np.testing.assert_array_equal(out["ray_mask"], plain["ray_mask"])
    np.testing.assert_array_equal(out["traversal_overflow"], plain["traversal_overflow"])
    # f32 throughout; only the MLP GEMMs' batch differs between the two.
    np.testing.assert_allclose(out["rgb"], plain["rgb"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["depth"], plain["depth"], atol=1e-4, rtol=0)


def test_adaptive_budgets_match_jax(setup):
    """Shallow buckets shade fewer samples (``scaled_budget``), at least the
    full budget's per-crossing density: close to the unbucketed forward."""
    jcfg, cfg = _configs(bucket_adaptive_samples=True)
    out, ref = _eval(setup, jcfg, cfg, setup["covering"])
    _assert_close_to_jax(out, ref)
    plain = _plain(setup)
    np.testing.assert_array_equal(out["ray_mask"], plain["ray_mask"])
    assert float(np.mean((out["rgb"] - plain["rgb"]) ** 2)) < 1e-3


def test_eight_bucket_eval_forward_matches_jax(setup):
    """The preset's 8 buckets, untuned bounds (a linear split of 64) and
    adaptive budgets: every bucket cut by the one batched slice."""
    jcfg, cfg = _configs(ray_buckets=8, bucket_adaptive_samples=True)
    out, ref = _eval(setup, jcfg, cfg, None)
    _assert_close_to_jax(out, ref)


def test_truncating_inner_bounds_match_jax_overflow(setup):
    jcfg, cfg = _configs(bucket_adaptive_samples=True)
    out, ref = _eval(setup, jcfg, cfg, (4, 8, 16))
    _assert_close_to_jax(out, ref)
    deep = setup["nv"] > 16
    assert deep.any() and out["traversal_overflow"].sum() > 0
    np.testing.assert_array_equal(out["traversal_overflow"] & ~deep, False)


def test_untuned_bounds_and_the_full_bound_path(setup):
    """Without tuned bounds the linear split (16, 32, 48, 64) is used; with
    every bound at ``max_steps`` bucketing is a no-op and the plain forward
    runs (no K8 slice)."""
    jcfg, cfg = _configs(bucket_adaptive_samples=True)
    out, ref = _eval(setup, jcfg, cfg, None)
    _assert_close_to_jax(out, ref)
    full = _port_eval(setup, cfg, (64, 64, 64))
    plain = _plain(setup)
    for k in full:
        np.testing.assert_array_equal(full[k], plain[k], err_msg=k)


# ----------------------------------------------------- the train forward


@pytest.mark.parametrize(
    "compute_dtype, fused",
    [("float32", False), ("bfloat16", False), ("bfloat16", True)],
    ids=["float32", "bfloat16", "bfloat16-fused"],
)
def test_bucketed_train_forward_loss_and_gradients_match_jax(setup, compute_dtype, fused):
    """Per-bucket random numbers from JAX's bucket keys; adaptive budgets
    (32 samples per round scale down to 16 in shallow buckets) and one
    truncating bucket (inner bounds below the covering ones)."""
    _check_train_forward_against_jax(setup, compute_dtype, fused_mlps=fused)


def _check_train_forward_against_jax(setup, compute_dtype, **extra):
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle

    jcfg, cfg = _configs(compute_dtype, num_samples=32, num_fine_samples=32, **extra)
    jmodel = _jax_model(setup, jcfg)
    inner = (16,) + setup["covering"][1:]
    o, d = setup["origins"][:64], setup["directions"][:64]
    target = np.random.default_rng(5).random((64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)

    def loss_fn(p):
        out = jmodel.get_outputs(
            p, RayBundle(jnp.asarray(o), jnp.asarray(d)), rng=rng, train=True,
            mesh=setup["jmesh"].on_device(), occ_depth_cap=CAP, bucket_steps=inner,
        )
        return jnp.mean(jnp.square(out["rgb"] - target))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(setup["params"])
    model = _port_model(setup, cfg)
    uniforms = _step_uniforms(rng, model, 64, 64, inner)
    assert isinstance(uniforms, list) and len(uniforms) == K
    assert len({u["coarse"].shape[1] for u in uniforms}) > 1  # budgets differ
    out = model.get_outputs(torch.from_numpy(o), torch.from_numpy(d), setup["mesh"],
                            occ_depth_cap=CAP, train=True, uniforms=uniforms,
                            bucket_steps=inner)
    loss = model.loss(out, torch.from_numpy(target))
    loss.backward()
    # The tolerances of test_torch_train.py's unbucketed case: JAX's bf16
    # blend contraction moves the PDF samples, so everything downstream
    # differs at that level, relative to each gradient's largest entry.
    tol = {"float32": 5e-2, "bfloat16": 1e-1}[compute_dtype]
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-4 * float(loss_ref)
    flat_ours = jax.tree_util.tree_leaves(_jax_layout(model, grads=True))
    flat_ref = jax.tree_util.tree_leaves(grads_ref)
    assert len(flat_ours) == len(flat_ref)
    for i, (a, r) in enumerate(zip(flat_ours, flat_ref)):
        assert a.shape == r.shape, i
        assert np.abs(np.asarray(r)).max() > 0, i
        assert _rel_err(a, r) <= tol, (i, _rel_err(a, r))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_merged_train_forward_loss_and_gradients_match_jax(setup, compute_dtype):
    """``bucket_merge_mlps`` on both sides (JAX ``_shade_buckets_merged``):
    the per-bucket case's loss and gradients at its tolerances."""
    _check_train_forward_against_jax(setup, compute_dtype, bucket_merge_mlps=True)


def test_merged_eval_forward_matches_jax(setup):
    """Four buckets merged at truncating inner bounds, adaptive budgets."""
    jcfg, cfg = _configs(bucket_adaptive_samples=True, bucket_merge_mlps=True)
    out, ref = _eval(setup, jcfg, cfg, (4, 8, 16))
    _assert_close_to_jax(out, ref)
    assert out["traversal_overflow"].sum() > 0


def _count_mlp_calls(model, monkeypatch):
    calls = {"field": 0, "density": 0}
    for name, key in (("field_mlps", "field"), ("density_mlp", "density")):
        fn = getattr(model, name)

        def counted(*args, fn=fn, key=key):
            calls[key] += 1
            return fn(*args)

        monkeypatch.setattr(model, name, counted)
    return calls


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_merged_path_matches_the_per_bucket_path(setup, monkeypatch, fused):
    """The port's merged path against its own per-bucket path on the same
    weights and random numbers (f32, CPU): the eval rgb within 1e-5, the
    train loss and field gradient within 1e-5 relative, with one call per
    MLP round in place of one per bucket. With ``fused_mlps`` the flag is
    ignored, as in JAX: the same calls as without it."""
    out, calls = {}, {}
    for merge in (False, True):
        _, cfg = _configs(bucket_merge_mlps=merge, fused_mlps=fused)
        model = _port_model(setup, cfg)
        calls[merge] = _count_mlp_calls(model, monkeypatch)
        o, d = (torch.from_numpy(x) for x in (setup["origins"], setup["directions"]))
        with torch.inference_mode():
            ev = model.get_outputs(o, d, setup["mesh"], occ_depth_cap=CAP,
                                   bucket_steps=setup["covering"])
        res = model.get_outputs(o, d, setup["mesh"], occ_depth_cap=CAP, train=True,
                                generator=torch.Generator().manual_seed(9),
                                bucket_steps=setup["covering"])
        loss = res["rgb"].square().mean()
        loss.backward()
        out[merge] = (ev, float(loss.detach()), model.tetrahedra_field.grad.clone())
    (ev0, loss0, g0), (ev1, loss1, g1) = out[False], out[True]
    for key in ev0:
        np.testing.assert_allclose(ev1[key].float().numpy(), ev0[key].float().numpy(),
                                   atol=1e-5, rtol=0, err_msg=key)
    assert abs(loss1 - loss0) <= 1e-5 * abs(loss0)
    assert float((g1 - g0).abs().max()) <= 1e-5 * float(g0.abs().max())
    per_bucket = {"field": 2 * K, "density": 2 * K}  # an eval and a train forward
    assert calls[False] == per_bucket
    assert calls[True] == (per_bucket if fused else {"field": 2, "density": 2})


def test_bucketed_train_forward_draws_per_bucket_from_the_generator(setup):
    """Without injected numbers each bucket draws its own from the step's
    generator, in bucket order: the same seed gives the same loss."""
    _, cfg = _configs()
    losses = []
    for _ in range(2):
        model = _port_model(setup, cfg)
        out = model.get_outputs(
            torch.from_numpy(setup["origins"]), torch.from_numpy(setup["directions"]),
            setup["mesh"], occ_depth_cap=CAP, train=True,
            generator=torch.Generator().manual_seed(9), bucket_steps=setup["covering"],
        )
        losses.append(float(out["rgb"].detach().square().mean()))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


@pytest.mark.parametrize("ray_buckets", [1, 4])
def test_cached_march_reshades_the_same_rays(setup, ray_buckets):
    """A geometry-only march of the same rays, re-shaded against the field
    (the cached-march branch of ``_forward``), gives the forward's outputs."""
    _, cfg = _configs(ray_buckets=ray_buckets)
    model = _port_model(setup, cfg)
    o = torch.from_numpy(setup["origins"])
    d = torch.from_numpy(setup["directions"])
    res = march_features(setup["mesh"], None, o, d, 64, use_occupancy=True,
                         occ_depth_cap=CAP)
    with torch.inference_mode():
        ref = model.get_outputs(o, d, setup["mesh"], occ_depth_cap=CAP,
                                bucket_steps=setup["covering"])
        out = model.get_outputs(o, d, setup["mesh"], cached_march=res,
                                bucket_steps=setup["covering"])
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("ray_buckets", [1, 4])
def test_cached_march_with_stale_features_is_reshaded(setup, ray_buckets):
    """A cached march that carries endpoint features of an older field is
    re-shaded against the current one: its ``feats`` are never used."""
    _, cfg = _configs(ray_buckets=ray_buckets)
    model = _port_model(setup, cfg)
    o = torch.from_numpy(setup["origins"])
    d = torch.from_numpy(setup["directions"])
    res = march_features(setup["mesh"], torch.randn(model.tetrahedra_field.shape), o, d,
                         64, use_occupancy=True, occ_depth_cap=CAP)
    assert res.feats is not None
    with torch.inference_mode():
        ref = model.get_outputs(o, d, setup["mesh"], occ_depth_cap=CAP,
                                bucket_steps=setup["covering"])
        out = model.get_outputs(o, d, setup["mesh"], cached_march=res,
                                bucket_steps=setup["covering"])
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_bucketed_forward_blends_every_bucket_in_one_batch(setup, monkeypatch):
    """The train forward over 4 buckets computes the endpoint features of
    all of them with one ``endpoint_features_batch`` call (one K2 launch on
    the card), and the one-stream path is not taken."""
    import tetranerf_torch.models.tetra_nerf as tetra_nerf

    calls = []
    batch = tetra_nerf.endpoint_features_batch

    def counting(field, streams, *levers):
        calls.append(len(streams))
        return batch(field, streams, *levers)

    def refuse(*args):
        raise AssertionError("a bucket recomputed its endpoint features alone")

    monkeypatch.setattr(tetra_nerf, "endpoint_features_batch", counting)
    monkeypatch.setattr(tetra_nerf, "endpoint_features", refuse)
    _, cfg = _configs()
    model = _port_model(setup, cfg)
    out = model.get_outputs(torch.from_numpy(setup["origins"]),
                            torch.from_numpy(setup["directions"]), setup["mesh"],
                            occ_depth_cap=CAP, train=True,
                            generator=torch.Generator().manual_seed(2),
                            bucket_steps=setup["covering"])
    out["rgb"].square().mean().backward()
    assert calls == [K]
    assert model.tetrahedra_field.grad.abs().max() > 0
