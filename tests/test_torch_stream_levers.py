"""The two stream levers of the endpoint features against the JAX package:
the gradient-stream budget (``grad_stream_budget_per_ray``, JAX
``_stream_gather``: the slots past the budget scatter no field gradient)
and the bf16 stream (``field_stream_dtype="bfloat16"``, JAX
``gather_rows_lowp``: bf16 rows both ways, the field gradient summed in
f32), at the function and at the model; the dropped set over two ranks;
and the instances of K2, K2b and K7 that the bf16 stream runs on the card
against their plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import build_mesh
from tetranerf_torch.models import TetraNerf, tetranerf_preset
from tetranerf_torch.ops import interp, scatter
from tetranerf_torch.ops.fused import endpoint_features, march_features, stream_budget_ids
from tetranerf_torch.ops.march import MarchStream
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays
from test_torch_parallel import _SplitGroup

FIELD_DIM = 16
CAP = float(-np.log(1e-4))
SMALL = dict(field_dim=FIELD_DIM, hidden_size=32, num_samples=16, num_fine_samples=16,
             max_intersected_triangles=64, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_exact(x):
    """``x`` rounded to bf16 and back: the JAX blend's bf16 operand casts
    are then exact, so only the order of f32 sums differs."""
    return torch.as_tensor(x).to(torch.bfloat16).float()


@pytest.fixture(scope="module")
def scene():
    """A 400-point sphere, 48 rays marched to 40 intervals (the port's twin
    of K1), the stream's weights made bf16-exact, and a field."""
    points, _ = make_sphere_scene(400, seed=0)
    mesh = build_mesh(points, device="cpu")
    o, d = sample_sphere_rays(np.random.default_rng(0), 48)
    res = march_features(mesh, None, torch.from_numpy(o), torch.from_numpy(d), 40)
    stream = res.stream._replace(bary=_bf16_exact(res.stream.bary))
    field = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (mesh.num_vertices, FIELD_DIM)).astype(np.float32))
    return dict(mesh=mesh, o=o, d=d, nv=res.num_valid, stream=stream, field=field)


def _jax_stream(stream):
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import MarchStream as JaxStream

    return JaxStream(*(jnp.asarray(x.numpy()) for x in stream))


def _jax_field_grad(field, stream, g, **kwargs):
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import endpoint_features as jax_endpoint_features

    js = _jax_stream(stream)
    _, vjp = jax.vjp(lambda f: jax_endpoint_features(f, js, **kwargs), jnp.asarray(field.numpy()))
    return np.asarray(vjp(jnp.asarray(g.numpy()))[0])


def _port_field_grad(field, stream, g, **kwargs):
    f = field.clone().requires_grad_()
    endpoint_features(f, stream, **kwargs).backward(g)
    return f.grad.numpy()


# -------------------------------------------------------- the budget


@pytest.mark.parametrize("where", ["none", "boundary", "straddle", "first"])
def test_budgeted_field_gradient_matches_jax(scene, where):
    """``stream_budget_ids`` into ``endpoint_features`` against JAX
    ``endpoint_features(field, stream, counts, grad_budget)``: a budget
    above the stream (nothing dropped), at a ray boundary, inside a ray
    (it keeps its first slots) and inside the first ray. The cotangent is
    bf16-exact, so the two differ by the order of f32 sums only."""
    stream, nv = scene["stream"], scene["nv"]
    width = stream.vids.shape[1]
    counts = torch.clamp_max(nv.long() + 4, width)
    ends = torch.cumsum(counts, 0)
    offs = ends - counts
    budget = {"none": int(ends[-1]) + 10, "boundary": int(offs[20]),
              "straddle": int(offs[20]) + 3, "first": 2}[where]
    g = _bf16_exact(np.random.default_rng(2).standard_normal(
        stream.pos.shape[:2] + (FIELD_DIM,)))
    last = torch.zeros(len(nv), dtype=torch.bool)
    last[-1] = True
    ids = stream_budget_ids(stream.vids, counts, offs, budget, last)
    ours = _port_field_grad(scene["field"], stream, g, scatter_ids=ids)
    ref = _jax_field_grad(scene["field"], stream, g, counts=nv.numpy() + 4,
                          grad_budget=budget)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    full = _port_field_grad(scene["field"], stream, g)
    kept = (ids >= 0).sum(dim=1)
    if where == "none":
        np.testing.assert_array_equal(ours, full)
        assert torch.equal(kept, counts)
    else:
        assert np.abs(ours - full).max() > 1e-3 * np.abs(full).max()
        assert int(kept.sum()) <= budget
        straddler = int(torch.searchsorted(ends, torch.tensor(budget), right=True))
        assert 0 < kept[straddler] < counts[straddler] or where == "boundary"
        assert kept[straddler + 1:].sum() == 0


# -------------------------------------------------------- the bf16 stream


def _crowded_stream(num_rays=32, num_end=33, num_stream=36, num_vertices=5, seed=3):
    """Random streams over 5 vertices: ~230 stream rows land on each vertex
    row of the field gradient (weights bf16-exact, four distinct slots per
    endpoint)."""
    rng = np.random.default_rng(seed)
    vids = rng.integers(0, num_vertices, (num_rays, num_stream)).astype(np.int32)
    pos = np.stack([np.stack([rng.choice(num_stream, 4, replace=False)
                              for _ in range(num_end)]) for _ in range(num_rays)])
    bary = rng.random((num_rays, num_end, 4))
    bary /= bary.sum(-1, keepdims=True)
    return MarchStream(vids=torch.from_numpy(vids), pos=torch.from_numpy(pos.astype(np.int32)),
                       bary=_bf16_exact(bary))


@pytest.mark.parametrize("crowded", [False, True], ids=["march", "crowded"])
def test_bf16_stream_matches_jax_gather_rows_lowp(scene, crowded):
    """The bf16 stream against JAX ``endpoint_features(..., stream_dtype=
    "bfloat16")`` (``gather_rows_lowp``): features to 1e-2 of their
    largest, the field gradient to 1e-3. On the crowded stream (~230 rows
    into each vertex row) the f32 sum is what holds it there: the same
    bf16 rows summed in bf16 miss by far more."""
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import endpoint_features as jax_endpoint_features

    stream = _crowded_stream() if crowded else scene["stream"]
    num_v = int(stream.vids.max()) + 1 if crowded else scene["mesh"].num_vertices
    field = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (num_v, FIELD_DIM)).astype(np.float32))
    g = _bf16_exact(np.random.default_rng(5).standard_normal(
        stream.pos.shape[:2] + (FIELD_DIM,)))
    feats = endpoint_features(field, stream, stream_dtype=torch.bfloat16)
    ref = np.asarray(jax_endpoint_features(jnp.asarray(field.numpy()), _jax_stream(stream),
                                           stream_dtype="bfloat16"))
    assert feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    ours = _port_field_grad(field, stream, g, stream_dtype=torch.bfloat16)
    ref_g = _jax_field_grad(field, stream, g, stream_dtype="bfloat16")
    err = np.abs(ours - ref_g).max() / np.abs(ref_g).max()
    assert err <= 1e-3, err
    if crowded:
        assert np.bincount(stream.vids.reshape(-1).numpy()).min() >= 200
        gsf = interp.stream_blend_backward(g, stream.pos, stream.bary, stream.vids.shape[1],
                                           torch.bfloat16)
        bf16_sum = torch.zeros((num_v, FIELD_DIM), dtype=torch.bfloat16).index_add_(
            0, stream.vids.reshape(-1).long(), gsf.reshape(-1, FIELD_DIM)).float().numpy()
        assert np.abs(bf16_sum - ref_g).max() / np.abs(ref_g).max() > 10 * max(err, 1e-4)


def test_bf16_stream_twins_keep_f32_where_jax_does(scene):
    """K2's bf16 twin writes f32; K2b's bf16 instance rounds the f32 sums
    once; K7's twin adds bf16 rows into an f32 table."""
    stream, field = scene["stream"], scene["field"]
    s = (stream.vids, stream.pos, stream.bary)
    out = interp.stream_blend_gather(field.to(torch.bfloat16), *s)
    ref = interp.stream_blend_gather(field.to(torch.bfloat16).float(), *s)
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    g = torch.randn(stream.pos.shape[:2] + (FIELD_DIM,), generator=torch.Generator().manual_seed(6))
    gsf = interp.stream_blend_backward(g, stream.pos, stream.bary, stream.vids.shape[1],
                                       torch.bfloat16)
    f32 = interp.stream_blend_backward(g, stream.pos, stream.bary, stream.vids.shape[1])
    assert gsf.dtype == torch.bfloat16 and torch.equal(gsf, f32.to(torch.bfloat16))
    idx = stream.vids.reshape(-1).clamp_min(0)
    table = scatter.scatter_add_rows(idx, gsf.reshape(-1, FIELD_DIM), field.shape[0])
    ref = scatter.scatter_add_rows(idx, gsf.reshape(-1, FIELD_DIM).float(), field.shape[0])
    assert table.dtype == torch.float32 and torch.equal(table, ref)


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def model_setup():
    """The port and JAX models on the 800-point sphere with a shell
    occupancy column (as ``tests/test_torch_bucketed.py``), 64 rays."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_torch.geometry import TorchMesh
    from tetranerf_torch.training.checkpoints import params_from_jax
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.presets import tetranerf_preset as jax_preset

    points, colors = make_sphere_scene(800, seed=0)
    jmesh = jax_build_mesh(points)
    centroids = np.asarray(jmesh.vertices)[np.asarray(jmesh.cells)].mean(axis=1)
    occ = np.where(np.linalg.norm(centroids, axis=1) > 0.85, 30.0, 0.0)
    jmesh = jmesh.with_occupancy(occ.astype(np.float32))
    o, d = sample_sphere_rays(np.random.default_rng(1), 64)
    jcfg = dataclasses.replace(jax_preset().model, ray_buckets=4, **SMALL)
    params = jax.tree_util.tree_map(np.asarray, JaxTetraNerf(jcfg, jmesh).init_params(
        jax.random.PRNGKey(0), point_colors=colors))

    def port_model(**extra):
        model = TetraNerf(tetranerf_preset(ray_buckets=4, **SMALL, **extra),
                          jmesh.num_vertices, device="cpu")
        params_from_jax(model, params)
        return model

    def jax_model(**extra):
        return JaxTetraNerf(dataclasses.replace(jcfg, **extra), jmesh)

    return dict(jmesh=jmesh, mesh=TorchMesh.from_tables(jmesh, device="cpu"), o=o, d=d,
                params=params, port_model=port_model, jax_model=jax_model)


BUCKETS = (24, 32, 40)


@pytest.mark.parametrize("bucket_steps", [BUCKETS, None], ids=["bucketed", "plain"])
def test_grad_stream_dropped_matches_jax_model(model_setup, bucket_steps):
    """``grad_stream_dropped`` of the train forward at 12 slots a ray, in
    four quantile buckets (each bucket its own budget, over its own rays)
    and un-bucketed: the JAX model's set, some rays dropped and some not."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle

    s = model_setup
    extra = dict(grad_stream_budget_per_ray=12)
    bounds = dict(bucket_steps=bucket_steps or (64, 64, 64))
    jmodel, jmesh = s["jax_model"](**extra), s["jmesh"].on_device()
    ref = np.asarray(jax.jit(lambda p, o, d: jmodel.get_outputs(
        p, RayBundle(o, d), rng=jax.random.PRNGKey(3), train=True, mesh=jmesh,
        occ_depth_cap=CAP, **bounds)["grad_stream_dropped"])(
            s["params"], jnp.asarray(s["o"]), jnp.asarray(s["d"])))
    with torch.no_grad():
        out = s["port_model"](**extra).get_outputs(
            torch.from_numpy(s["o"]), torch.from_numpy(s["d"]), s["mesh"],
            occ_depth_cap=CAP, train=True, generator=torch.Generator().manual_seed(3),
            **bounds)
    np.testing.assert_array_equal(out["grad_stream_dropped"].numpy(), ref)
    assert 0 < ref.sum() < ref.size


@pytest.mark.parametrize("bucket_steps", [BUCKETS, None], ids=["bucketed", "plain"])
@pytest.mark.parametrize("lever", ["budget", "bf16"])
def test_two_ranks_shade_as_one(model_setup, bucket_steps, lever):
    """A two-rank train forward (each rank's share through a group of two)
    against the one-process forward with the same generator: the dropped
    set and the rgb of each rank's rays, and the sum of the ranks' field
    gradients of ``sum(rgb)`` equal to the one-process gradient."""
    s = model_setup
    model = s["port_model"](**({"grad_stream_budget_per_ray": 12} if lever == "budget"
                               else {"field_stream_dtype": "bfloat16"}))
    o, d = torch.from_numpy(s["o"]), torch.from_numpy(s["d"])
    full = bucket_steps is None
    bounds = dict(bucket_steps=bucket_steps or (64, 64, 64))

    def forward(o_, d_, group=None):
        model.zero_grad(set_to_none=True)
        out = model.get_outputs(o_, d_, s["mesh"], occ_depth_cap=CAP, train=True,
                                generator=torch.Generator().manual_seed(7), group=group,
                                **bounds)
        out["rgb"].sum().backward()
        return out, model.tetrahedra_field.grad.clone()

    one, grad_one = forward(o, d)
    nv = march_features(s["mesh"], None, o, d, 64, use_occupancy=True,
                        occ_depth_cap=CAP).num_valid
    outs, grad_sum = [], torch.zeros_like(grad_one)
    for rank in range(2):
        rows = slice(32 * rank, 32 * (rank + 1))
        out, grad = forward(o[rows], d[rows], _SplitGroup(rank, 2, nv))
        outs.append(out)
        grad_sum += grad
    for key in ("rgb", "traversal_overflow") + (("grad_stream_dropped",)
                                                 if lever == "budget" else ()):
        both = torch.cat([out[key] for out in outs])
        torch.testing.assert_close(both, one[key], atol=1e-6, rtol=0)
    torch.testing.assert_close(grad_sum, grad_one, rtol=0,
                               atol=1e-5 * float(grad_one.abs().max()))
    if lever == "budget":
        assert 0 < int(one["grad_stream_dropped"].sum()) < 64 or full


@pytest.mark.parametrize("merge, fused, train, extra", [
    (True, False, True, {}),
    (True, False, True, {"grad_stream_budget_per_ray": 12}),
    (True, False, False, {"grad_stream_budget_per_ray": 12}),
    (True, False, True, {"field_stream_dtype": "bfloat16"}),
    (True, False, False, {"field_stream_dtype": "bfloat16"}),
    (True, True, True, {}),
    (False, False, True, {}),
], ids=[f"gate{i}" for i in range(7)])
def test_merged_mlp_gating_matches_jax(model_setup, monkeypatch, merge, fused, train, extra):
    """Which shading a bucketed forward takes, merged MLP rounds or per
    bucket, as the JAX model decides it: each side's two shading methods
    are replaced by spies that record the choice and stop the forward."""
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle, TetraNerf as JaxTetraNerf

    class Chose(Exception):
        pass

    def spy(name):
        def stop(*args, **kwargs):
            raise Chose(name)
        return stop

    s = model_setup
    kw = dict(bucket_merge_mlps=merge, fused_mlps=fused, **extra)
    monkeypatch.setattr(JaxTetraNerf, "_shade_buckets_merged", spy("merged"))
    monkeypatch.setattr(JaxTetraNerf, "_forward", spy("per-bucket"))
    with pytest.raises(Chose) as ref:
        s["jax_model"](**kw).get_outputs(
            s["params"], RayBundle(jnp.asarray(s["o"][:8]), jnp.asarray(s["d"][:8])),
            rng=None, train=train, mesh=s["jmesh"].on_device(), occ_depth_cap=CAP,
            bucket_steps=BUCKETS)
    model = s["port_model"](**kw)
    monkeypatch.setattr(model, "_shade_buckets_merged", spy("merged"))
    monkeypatch.setattr(model, "_shade", spy("per-bucket"))
    with pytest.raises(Chose) as ours, torch.no_grad():
        model.get_outputs(torch.from_numpy(s["o"][:8]), torch.from_numpy(s["d"][:8]),
                          s["mesh"], occ_depth_cap=CAP, train=train,
                          generator=torch.Generator().manual_seed(0), bucket_steps=BUCKETS)
    assert str(ours.value) == str(ref.value)
    assert model.merges_buckets(train) == (str(ref.value) == "merged")


# --------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 stream kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 64])
def test_bf16_blend_kernel_matches_twin(scene, cuda_device, feat):
    """K2's bf16-row instance: the widened rows blend as the twin's f32
    rows do (1e-5: the kernel may contract into FMAs)."""
    s = scene["stream"]
    field = torch.randn(scene["mesh"].num_vertices, feat).to(torch.bfloat16)
    args = [x.to(cuda_device) for x in (s.vids, s.pos, s.bary)]
    out = interp.stream_blend_gather(field.to(cuda_device), *args)
    ref = interp.stream_blend_gather_twin(field, s.vids, s.pos, s.bary)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 64])
def test_bf16_blend_backward_kernel_matches_twin(scene, cuda_device, feat):
    """K2b's bf16-out instance: f32 sums in another order, each rounded to
    bf16 once: within one bf16 rounding (2^-8 relative) of the twin."""
    s = scene["stream"]
    g = torch.randn(s.pos.shape[:2] + (feat,))
    out = interp.stream_blend_backward(g.to(cuda_device), s.pos.to(cuda_device),
                                       s.bary.to(cuda_device), s.vids.shape[1],
                                       torch.bfloat16)
    ref = interp.stream_blend_backward_twin(g, s.pos, s.bary, s.vids.shape[1])
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.cpu().float(), ref, rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 64, 3])
def test_bf16_scatter_kernel_matches_twin(cuda_device, feat):
    """K7's bf16-row instance on the crowded stream's ids (~230 rows a
    vertex) and ids out of range: f32 sums of the widened rows in atomic
    order (1e-4)."""
    s = _crowded_stream()
    idx = s.vids.reshape(-1).clone()
    idx[::7] = -1
    idx[::11] = 99
    vals = torch.randn(idx.shape[0], feat).to(torch.bfloat16)
    out = scatter.scatter_add_rows(idx.to(cuda_device), vals.to(cuda_device), 5)
    ref = scatter.scatter_add_rows_twin(idx, vals, 5)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)
