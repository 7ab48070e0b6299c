"""The two stream levers of the endpoint features against the JAX package:
the gradient-stream budget (``grad_stream_budget_per_ray``, JAX
``_stream_gather``: the slots past the budget scatter no field gradient)
and the low-precision streams (``field_stream_dtype`` "bfloat16",
"float16", "float8_e4m3fn", "float8_e5m2", JAX ``gather_rows_lowp``: rows
in that type both ways, the field gradient summed in f32), at the function
and at the model; the names ``check_supported`` takes; the rounding to
each type against ``jnp.astype``; the dropped set over two ranks; and the
instances of K2, K2b and K7 that the low-precision streams run on the card
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
from tetranerf_torch.ops.stream_dtypes import (BOUNDARY_CODES, boundary_values,
                                               one_rounding_bound, round_to, row_type)
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


# ---------------------------------------------- the f16 and fp8 streams


LOWP = ["float16", "float8_e4m3fn", "float8_e5m2"]

def _boundary(name):
    """``(f32 values, their codes)``: ``BOUNDARY_VALUES``, their negatives,
    NaN and -NaN, and the codes ``BOUNDARY_CODES`` gives them."""
    return np.float32(boundary_values(name)), np.array(BOUNDARY_CODES[name])


def _codes(t):
    """The bits of a 2- or 1-byte tensor as int64."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.uint8).long() & 0xFFFF


def _lowp_values(name):
    """Every finite value of the type, the midpoints between neighbours
    (exact ties) and the f32 values either side of each midpoint, with both
    signs: every rounding decision the type has."""
    import ml_dtypes

    np_type = np.float16 if name == "float16" else getattr(ml_dtypes, name)
    bits = np.arange(2 ** (8 * np.dtype(np_type).itemsize), dtype=np.uint32)
    vals = bits.astype(np.uint16 if np_type is np.float16 else np.uint8).view(np_type)
    vals = np.unique(vals.astype(np.float64)[np.isfinite(vals.astype(np.float64))])
    vals = vals[vals >= 0]
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    x = np.concatenate([vals.astype(np.float32), mids, np.nextafter(mids, np.float32(0)),
                        np.nextafter(mids, np.float32(np.inf))])
    return np.concatenate([x, -x])


@pytest.mark.parametrize("name", LOWP)
def test_stream_rounding_matches_jnp_astype(name):
    """:func:`round_to` (the field's cast, and K2b's twin's rounding)
    against ``jnp.astype`` bit for bit: at every rounding decision of the
    type and at the boundary values, whose codes are also the table the
    kernels are held to on the card."""
    import jax.numpy as jnp

    x, codes = _boundary(name)
    xs = np.concatenate([x, _lowp_values(name)])
    ours = _codes(round_to(torch.from_numpy(xs), getattr(torch, name))).numpy()
    ref = np.asarray(jnp.asarray(xs).astype(name))
    ref = ref.view(np.uint16 if ref.itemsize == 2 else np.uint8).astype(np.int64)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[:len(x)], codes)


def _jax_stream_grad(stream, g, name):
    """JAX's stream-row gradient (``stream_blend``'s VJP emits it in the
    primal's dtype, here the stream's type), widened to f32."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_interp import stream_blend

    pos, bary = jnp.asarray(stream.pos.numpy()), jnp.asarray(stream.bary.numpy())
    sf = jnp.zeros(stream.vids.shape + (FIELD_DIM,), name)
    _, vjp = jax.vjp(lambda x: stream_blend(x, pos, bary), sf)
    out = vjp(jnp.asarray(g.numpy()))[0]
    assert out.dtype == jnp.dtype(name)
    return torch.from_numpy(np.asarray(out.astype(jnp.float32)))


@pytest.mark.parametrize("name, crowded", [(name, False) for name in LOWP]
                         + [("float8_e4m3fn", True)],
                         ids=[f"{name}-march" for name in LOWP] + ["float8_e4m3fn-crowded"])
def test_lowp_stream_matches_jax_gather_rows_lowp(scene, name, crowded):
    """The f16 and fp8 streams against JAX ``endpoint_features(...,
    stream_dtype=name)`` and its VJP, with the field, ``bary`` and ``g``
    bf16-exact (so JAX's in-kernel bf16 casts lose nothing: every rounded
    row is bf16-exact too). Features: the same rows blended in f32 in
    another order, to 1e-6 of their largest entry.

    Stream-row gradients: the same f32 sums (exact products) rounded once to
    the type. The port's codes round the exact sum; JAX's f32 sums in
    another order move a code by one step where the sum sits at a rounding
    tie: those are counted (1-8 of 33,792 on the march's stream, none on
    the crowded one, which sums ~230 rows into each vertex row), each must be one step at a tie (the exact sum within
    an f32 sum's error bound of the midpoint), and they are at most 1e-3 of
    the codes. Field gradient: the same rows summed in f32 in
    another order, to 1e-6 of its largest entry plus, in each entry, the
    steps of the tie codes scattered there."""
    from tetranerf_tpu.ops.fused import endpoint_features as jax_endpoint_features
    import jax.numpy as jnp

    stream = _crowded_stream() if crowded else scene["stream"]
    num_v = int(stream.vids.max()) + 1 if crowded else scene["mesh"].num_vertices
    field = _bf16_exact(np.random.default_rng(4).standard_normal((num_v, FIELD_DIM)))
    g = _bf16_exact(np.random.default_rng(5).standard_normal(
        stream.pos.shape[:2] + (FIELD_DIM,)))
    dtype = getattr(torch, name)
    feats = endpoint_features(field, stream, stream_dtype=dtype)
    ref = np.asarray(jax_endpoint_features(jnp.asarray(field.numpy()), _jax_stream(stream),
                                           stream_dtype=name))
    assert feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())

    num_stream = stream.vids.shape[1]
    gsf = interp.stream_blend_backward(g, stream.pos, stream.bary, num_stream, dtype)
    ref_gsf = _jax_stream_grad(stream, g, name)
    exact = interp.stream_blend_backward(g.double(), stream.pos, stream.bary.double(),
                                         num_stream)
    assert torch.equal(_codes(gsf), _codes(round_to(exact.float(), dtype)))
    ties = gsf.float() != ref_gsf
    assert int(ties.sum()) <= 1e-3 * ties.numel()
    a, b, x = gsf[ties], ref_gsf[ties].to(dtype), exact[ties]
    assert torch.equal((_codes(a) - _codes(b)).abs(), torch.ones_like(_codes(a)))
    # At a tie: the exact sum within the error bound of an f32 sum of n
    # terms, n * 2^-24 * sum(|terms|), of the midpoint between the codes.
    terms = interp.stream_blend_backward(torch.ones_like(g), stream.pos,
                                         (stream.bary != 0).float(), num_stream)[ties]
    mass = interp.stream_blend_backward(g.abs().double(), stream.pos,
                                        stream.bary.abs().double(), num_stream)[ties]
    mid = (a.double() + b.double()) / 2
    assert torch.all((x - mid).abs() <= terms * 2.0 ** -24 * mass), (x, mid)

    ours = _port_field_grad(field, stream, g, stream_dtype=dtype)
    ref_g = _jax_field_grad(field, stream, g, stream_dtype=name)
    assert np.abs(ref_g).max() > 0
    steps = torch.where(ties, (gsf.float() - ref_gsf).abs(), 0.0)
    budget = scatter.scatter_add_rows_twin(stream.vids.reshape(-1).clamp_min(0),
                                           steps.reshape(-1, FIELD_DIM), num_v).numpy()
    assert np.all(np.abs(ours - ref_g) <= 1e-6 * np.abs(ref_g).max() + budget)


@pytest.mark.parametrize("name", LOWP)
def test_lowp_stream_twins_keep_f32_where_jax_does(scene, name):
    """K2's twin widens the type's rows and writes f32; K2b's rounds the
    f32 sums once, as ``jnp.astype`` does; K7's adds the widened rows into
    an f32 table."""
    stream, field = scene["stream"], scene["field"]
    dtype = getattr(torch, name)
    s = (stream.vids, stream.pos, stream.bary)
    rows = round_to(field * 64, dtype)  # past e4m3fn's range in places: NaN rows
    out = interp.stream_blend_gather(rows, *s)
    ref = interp.stream_blend_gather(rows.float(), *s)
    assert out.dtype == torch.float32 and torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.nan_to_num(), ref.nan_to_num())
    g = torch.randn(stream.pos.shape[:2] + (FIELD_DIM,),
                    generator=torch.Generator().manual_seed(6))
    gsf = interp.stream_blend_backward(g, stream.pos, stream.bary, stream.vids.shape[1], dtype)
    f32 = interp.stream_blend_backward(g, stream.pos, stream.bary, stream.vids.shape[1])
    assert gsf.dtype == dtype and torch.equal(_codes(gsf), _codes(round_to(f32, dtype)))
    idx = stream.vids.reshape(-1).clamp_min(0)
    table = scatter.scatter_add_rows(idx, gsf.reshape(-1, FIELD_DIM), field.shape[0])
    ref = scatter.scatter_add_rows(idx, gsf.reshape(-1, FIELD_DIM).float(), field.shape[0])
    assert table.dtype == torch.float32 and torch.equal(table, ref)


# The names ``field_stream_dtype`` may take, as JAX's ``endpoint_features``
# reads them: run, or refused with an exception type.
STREAM_NAMES = ["float32", "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2",
                "float64", "half", "double", "float8_e4m3fnuz", "float6_e2m3fn", "int8",
                "uint4", "complex64", "float128", "bogus", "float8_e5m2fnuz",
                "float8_e4m3b11fnuz", "float8_e3m4", "float8_e4m3", "float8_e8m0fnu",
                "float4_e2m1fn"]


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_check_supported_takes_the_names_jax_takes(name):
    """``check_supported`` runs each name JAX's ``endpoint_features`` runs
    and differentiates (integer types pass its forward and fail in the
    VJP), and raises JAX's exception type for each it refuses."""
    import warnings

    import jax
    import jax.numpy as jnp
    from tetranerf_torch.models import check_supported
    from tetranerf_tpu.ops.fused import MarchStream as JaxStream
    from tetranerf_tpu.ops.fused import endpoint_features as jax_endpoint_features

    rng = np.random.default_rng(0)
    js = JaxStream(jnp.asarray(rng.integers(0, 7, (2, 6)).astype(np.int32)),
                   jnp.asarray(rng.integers(0, 6, (2, 5, 4)).astype(np.int32)),
                   jnp.asarray(rng.random((2, 5, 4)).astype(np.float32)))
    field = jnp.asarray(rng.standard_normal((7, 4)).astype(np.float32))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # float64 without x64
            _, vjp = jax.vjp(lambda f: jax_endpoint_features(f, js, stream_dtype=name), field)
            vjp(jnp.ones((2, 5, 4)))
        ref = None
    except Exception as exc:  # noqa: BLE001 - the type is what is compared
        ref = type(exc)
    cfg = tetranerf_preset(field_stream_dtype=name)
    if ref is None:
        check_supported(cfg)
    else:
        with pytest.raises(ref):
            check_supported(cfg)


def test_float64_stream_is_the_f32_stream(scene):
    """``"float64"`` (and ``"double"``) is the f32 stream on both sides, as
    JAX computes it with x64 off: the model's stream dtype is None, and
    JAX's features and field gradient equal its f32 stream's."""
    import warnings

    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import endpoint_features as jax_endpoint_features

    for name in ("float64", "double"):
        model = TetraNerf(tetranerf_preset(**SMALL, field_stream_dtype=name), 10, device="cpu")
        assert model.stream_levers(True) == (None, None)
        assert model.stream_levers(False) == (None, None)
    stream, field = scene["stream"], scene["field"]
    g = _bf16_exact(np.random.default_rng(5).standard_normal(
        stream.pos.shape[:2] + (FIELD_DIM,)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f64 = np.asarray(jax_endpoint_features(jnp.asarray(field.numpy()), _jax_stream(stream),
                                               stream_dtype="float64"))
        g64 = _jax_field_grad(field, stream, g, stream_dtype="float64")
    f32 = np.asarray(jax_endpoint_features(jnp.asarray(field.numpy()), _jax_stream(stream)))
    np.testing.assert_array_equal(f64, f32)
    np.testing.assert_array_equal(g64, _jax_field_grad(field, stream, g))


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
    (True, False, True, {"field_stream_dtype": "float16"}),
    (True, False, False, {"field_stream_dtype": "float8_e4m3fn"}),
    (True, False, True, {"field_stream_dtype": "float8_e5m2"}),
    (True, False, True, {"field_stream_dtype": "float64"}),
], ids=[f"gate{i}" for i in range(11)])
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


@pytest.mark.parametrize("name", ["float16", "float8_e4m3fn", "float8_e5m2", "float64"])
def test_trainer_steps_with_each_stream_dtype(name):
    """The trainer takes each ``field_stream_dtype`` JAX's model runs: the
    narrowed preset (8 buckets) trains 3 steps with finite losses, and the
    f16 stream moves the field as the f32 stream does, to the rounding of
    its rows (the first step's field update to 1e-2 of its largest)."""
    from tetranerf_torch.training.trainer import TrainConfig, Trainer
    from tetranerf_torch.utils.synthetic import sphere_ray_targets

    points, colors = make_sphere_scene(300, seed=0)
    mesh = build_mesh(points, device="cpu")
    o, d = sample_sphere_rays(np.random.default_rng(0), 16)
    batch = {"origins": o, "directions": d, "rgb": sphere_ray_targets(o, d)}

    def first_update(stream_dtype, steps):
        cfg = tetranerf_preset(field_dim=8, hidden_size=16, num_samples=8,
                               num_fine_samples=8, max_intersected_triangles=64,
                               field_stream_dtype=stream_dtype)
        model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                          generator=torch.Generator().manual_seed(0), device="cpu")
        trainer = Trainer(TrainConfig(), model, mesh, device="cpu")
        before = model.tetrahedra_field.detach().clone()
        losses = [float(trainer.train_step(batch)["loss"]) for _ in range(steps)]
        assert np.isfinite(losses).all()
        return losses, model.tetrahedra_field.detach() - before

    losses, update = first_update(name, 3)
    if name == "float16":
        _, ref = first_update("float32", 1)
        _, update = first_update(name, 1)
        assert float(ref.abs().max()) > 0
        torch.testing.assert_close(update, ref, rtol=0, atol=1e-2 * float(ref.abs().max()))


# The train forward's loss scaled so that the stream-row cotangents reach
# float8_e4m3fn's range (its smallest step is 2^-9; at the mean loss's
# scale nearly all of them round to zero, on both sides).
LOSS_SCALE = 2.0 ** 12


@pytest.mark.parametrize("name", ["float16", "float8_e4m3fn"])
def test_lowp_stream_train_forward_matches_jax_model(model_setup, name):
    """A train forward with ``field_stream_dtype=name`` in four buckets, and
    the field gradient of its scaled loss, against the JAX model's
    (``jax.jit(jax.value_and_grad)``) with the same random numbers. JAX's
    blend rounds the stream rows to bf16 in the jitted model as in the
    eager op (its f32 and bf16 streams give equal outputs, and so does a
    field rounded to bf16 beforehand), the port's blends them in f32; so
    the features differ by a bf16 rounding, the PDF samples move with them,
    and the loss and gradients differ at that level (measured: the loss by
    1.0e-6 and 7.7e-8 of itself, the field gradient by 9.6e-3 and 3.0e-2 of
    its largest entry, float16 and float8_e4m3fn): the loss to 1e-5, the
    field gradient to 2e-2 and 6e-2 (e4m3fn's coarser cotangent codes flip
    with the samples; 24% of its field gradient is nonzero, 64% of f16's)."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.models.tetra_nerf import RayBundle
    from test_torch_train import _rel_err, _step_uniforms

    s = model_setup
    jmodel, jmesh = s["jax_model"](field_stream_dtype=name), s["jmesh"].on_device()
    target = np.random.default_rng(5).random((64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)

    def loss_fn(p):
        out = jmodel.get_outputs(p, RayBundle(jnp.asarray(s["o"]), jnp.asarray(s["d"])),
                                 rng=rng, train=True, mesh=jmesh, occ_depth_cap=CAP,
                                 bucket_steps=BUCKETS)
        return LOSS_SCALE * jnp.mean(jnp.square(out["rgb"] - target))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(s["params"])
    model = s["port_model"](field_stream_dtype=name)
    out = model.get_outputs(torch.from_numpy(s["o"]), torch.from_numpy(s["d"]), s["mesh"],
                            occ_depth_cap=CAP, train=True, bucket_steps=BUCKETS,
                            uniforms=_step_uniforms(rng, model, 64, 64, BUCKETS))
    loss = LOSS_SCALE * model.loss(out, torch.from_numpy(target))
    loss.backward()
    ref_g = np.asarray(grads_ref["tetrahedra_field"])
    ours = model.tetrahedra_field.grad.numpy()
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-5 * float(loss_ref)
    assert (ref_g != 0).mean() > 0.05
    assert _rel_err(ours, ref_g) <= {"float16": 2e-2, "float8_e4m3fn": 6e-2}[name]


# --------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stream kernels' low-precision instances run "
                    "only on the card")
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


def _launched(fn):
    """``fn()``, and the launches it made by counter."""
    from tetranerf_torch.ops import cuda

    before = dict(cuda.launch_counts)
    out = fn()
    return out, {k: n - before[k] for k, n in cuda.launch_counts.items() if n != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", LOWP)
def test_stream_rounding_on_the_card_matches_jnp_astype(cuda_device, name):
    """The field's cast on the card (:func:`round_to`, torch ops) and K2b's
    instance (each boundary value the f32 sum of one endpoint of weight 1)
    give the codes ``jnp.astype`` gives, bit for bit. K2b's sums are the
    card's arithmetic, whose NaN is positive: -NaN is left to the cast."""
    x, codes = _boundary(name)
    dtype = getattr(torch, name)
    got = _codes(round_to(torch.from_numpy(x).to(cuda_device), dtype).cpu()).numpy()
    np.testing.assert_array_equal(got, codes)
    x, codes = x[:-1], codes[:-1]
    n = len(x)
    g = torch.from_numpy(np.repeat(x[:, None], 2, axis=1))[None].contiguous()
    pos = torch.full((1, n, 4), n, dtype=torch.int32)  # the zero weights: slot n
    pos[0, :, 0] = torch.arange(n, dtype=torch.int32)
    bary = torch.zeros((1, n, 4))
    bary[..., 0] = 1.0
    gsf, launched = _launched(lambda: interp.stream_blend_backward(
        g.to(cuda_device), pos.to(cuda_device), bary.to(cuda_device), n + 1, dtype).cpu())
    assert gsf.dtype == dtype and launched == {
        "stream_blend_backward" + row_type(dtype).suffix: 1}
    np.testing.assert_array_equal(_codes(gsf[0, :n]).numpy(),
                                  np.repeat(codes[:, None], 2, axis=1))


def _all_codes(dtype):
    """Every code of a 2- or 1-byte ``dtype``, as a tensor of that type."""
    size = torch.empty((), dtype=dtype).element_size()
    codes = np.arange(2 ** (8 * size), dtype=np.uint16 if size == 2 else np.uint8)
    return torch.from_numpy(codes.view(np.int16) if size == 2 else codes).view(dtype)


def _all_finite_rows(dtype, feat=16):
    """Every finite value of ``dtype`` once, as ``[V, feat]`` rows (zeros
    pad the last)."""
    vals = _all_codes(dtype)
    vals = vals[vals.float().isfinite()]
    pad = (-vals.numel()) % feat
    return torch.cat([vals, torch.zeros(pad, dtype=dtype)]).reshape(-1, feat)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LOWP)
def test_lowp_blend_kernel_matches_twin(scene, cuda_device, name):
    """K2's instance for the type: the widened rows blend as the twin's f32
    rows do (1e-5: the kernel may contract into FMAs) at widths 16 and 64
    (4-element loads) and 6 (2-element loads); and every finite value of
    the type, each the one weighted row of an endpoint, widens exactly."""
    s = scene["stream"]
    dtype = getattr(torch, name)
    counter = "stream_blend_gather" + row_type(dtype).suffix
    args = [x.to(cuda_device) for x in (s.vids, s.pos, s.bary)]
    for feat in (16, 64, 6):
        field = round_to(torch.randn(scene["mesh"].num_vertices, feat), dtype)
        out, launched = _launched(lambda: interp.stream_blend_gather(
            field.to(cuda_device), *args))
        ref = interp.stream_blend_gather_twin(field, s.vids, s.pos, s.bary)
        assert out.dtype == torch.float32 and launched == {counter: 1}
        torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)
    rows = _all_finite_rows(dtype)
    num = rows.shape[0]
    vids = torch.arange(num, dtype=torch.int32)[:, None]
    pos = torch.zeros((num, 1, 4), dtype=torch.int32)
    bary = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(num, 1, 4).contiguous()
    out = interp.stream_blend_gather(rows.to(cuda_device), vids.to(cuda_device),
                                     pos.to(cuda_device), bary.to(cuda_device))
    assert torch.equal(out[:, 0].cpu(), rows.float())


@pytest.mark.cuda
@pytest.mark.parametrize("name", LOWP)
def test_lowp_blend_backward_kernel_matches_twin(scene, cuda_device, name):
    """K2b's instance for the type: f32 sums in another order than the
    twin's, each rounded once to the type: within one rounding of the
    twin's f32 sums (``one_rounding_bound``) plus 1e-6 for the order of the
    f32 sums (of unit-scale terms; a sum may cancel to near zero), for four
    seeds' cotangents at each width. Prints the largest ``err - bound``
    (run with ``-s`` to read the room the bound leaves)."""
    s = scene["stream"]
    dtype = getattr(torch, name)
    counter = "stream_blend_backward" + row_type(dtype).suffix
    for feat in (16, 64):
        for seed in range(4):
            g = torch.randn(s.pos.shape[:2] + (feat,),
                            generator=torch.Generator().manual_seed(seed))
            out, launched = _launched(lambda: interp.stream_blend_backward(
                g.to(cuda_device), s.pos.to(cuda_device), s.bary.to(cuda_device),
                s.vids.shape[1], dtype))
            ref = interp.stream_blend_backward_twin(g, s.pos, s.bary, s.vids.shape[1])
            assert out.dtype == dtype and launched == {counter: 1}
            err = (out.cpu().float() - ref).abs()
            bound = one_rounding_bound(ref, dtype, sum_atol=1e-6)
            room = float((err - bound).max())
            print(f"K2b {name} width {feat} seed {seed}: max(err - bound) {room:.3g}")
            assert room <= 0, room


@pytest.mark.cuda
@pytest.mark.parametrize("name", LOWP)
def test_lowp_scatter_kernel_matches_twin(cuda_device, name):
    """K7's instance for the type on the crowded stream's ids (~230 rows a
    vertex) and ids out of range at widths 16, 64 and 3 (4-, 2- and
    1-element loads): f32 sums of the widened rows in atomic order (1e-4);
    and every value of the type, NaN and infinity included, each the one
    row of its table row, widens exactly."""
    s = _crowded_stream()
    dtype = getattr(torch, name)
    counter = "scatter_add_rows" + row_type(dtype).suffix
    idx = s.vids.reshape(-1).clone()
    idx[::7] = -1
    idx[::11] = 99
    for feat in (16, 64, 3):
        vals = round_to(torch.randn(idx.shape[0], feat), dtype)
        out, launched = _launched(lambda: scatter.scatter_add_rows(
            idx.to(cuda_device), vals.to(cuda_device), 5))
        ref = scatter.scatter_add_rows_twin(idx, vals, 5)
        assert out.dtype == torch.float32 and launched == {counter: 1}
        torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)
    vals = _all_codes(dtype).reshape(-1, 16)
    rows = torch.arange(vals.shape[0], dtype=torch.int32)
    out = scatter.scatter_add_rows(rows.to(cuda_device), vals.to(cuda_device), vals.shape[0])
    torch.testing.assert_close(out.cpu(), vals.float(), atol=0, rtol=0, equal_nan=True)
