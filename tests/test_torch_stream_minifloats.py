"""The seven 8- and 4-bit field streams that torch has no dtype for
(``field_stream_dtype`` "float8_e4m3fnuz", "float8_e5m2fnuz",
"float8_e4m3b11fnuz", "float8_e3m4", "float8_e4m3", "float8_e8m0fnu",
"float4_e2m1fn"; rows of ``uint8`` codes) against the JAX package: the
rounding and the widening against ``jnp.astype`` bit for bit, the
endpoint features and their field gradient against JAX's
``endpoint_features`` with ``stream_dtype=name`` and its VJP, and a model
train forward against JAX's; then, on the card, K2, K2b and K7's software
instances against their plain versions and the rounding's boundary codes."""

import numpy as np
import pytest
import torch

from tetranerf_torch.ops import interp, scatter
from tetranerf_torch.ops.fused import endpoint_features
from tetranerf_torch.ops.stream_dtypes import (BOUNDARY_CODES, STREAM_TYPES, boundary_values,
                                               one_rounding_bound, round_to, widen)
from test_torch_stream_levers import (BUCKETS, CAP, FIELD_DIM, LOSS_SCALE,  # noqa: F401
                                      _bf16_exact, _crowded_stream, _jax_stream, _launched,
                                      _one_torch_thread, _port_field_grad, cuda_device,
                                      model_setup, scene)

MINI = [name for name, t in STREAM_TYPES.items() if t.minifloat]


def _all_codes(name):
    """Every code of the type (16 for float4_e2m1fn) as ``uint8``."""
    return torch.arange(16 if name == "float4_e2m1fn" else 256, dtype=torch.uint8)


def _jnp_codes(x, name):
    """``jnp.asarray(x).astype(name)``'s codes as int64."""
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(np.float32(x)).astype(name)).view(np.uint8).astype(np.int64)


def _jnp_widen(codes, name):
    """The f32 values of ``codes`` as ``jnp.astype(float32)`` gives them."""
    import jax.numpy as jnp
    import ml_dtypes

    return np.asarray(jnp.asarray(codes.numpy().view(getattr(ml_dtypes, name)))
                      .astype(jnp.float32))


def _rounding_inputs(name):
    """Every value of the type, the midpoints between neighbours and the
    f32 values either side of each, with both signs; ±0, ±inf, ±NaN and
    the boundary values; 10,000 seeded normals at three scales."""
    vals = _jnp_widen(_all_codes(name), name).astype(np.float64)
    vals = np.unique(vals[np.isfinite(vals)])
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    x = np.concatenate([vals.astype(np.float32), mids, np.nextafter(mids, np.float32(-np.inf)),
                        np.nextafter(mids, np.float32(np.inf))])
    rng = np.random.default_rng(0)
    normals = [rng.standard_normal(10_000).astype(np.float32) * s for s in (2.0 ** -8, 1, 64)]
    return np.concatenate([x, -x, np.float32(boundary_values(name))] + normals)


@pytest.mark.parametrize("name", MINI)
def test_round_to_matches_jnp_astype(name):
    """:func:`round_to` (integer torch ops on the f32 bits) gives the codes
    ``jnp.astype`` gives, bit for bit; ``BOUNDARY_CODES`` are its codes of
    the boundary values (the table the kernels are held to on the card)."""
    x = _rounding_inputs(name)
    ours = round_to(torch.from_numpy(x), name)
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.long().numpy(), _jnp_codes(x, name))
    np.testing.assert_array_equal(_jnp_codes(boundary_values(name), name),
                                  np.array(BOUNDARY_CODES[name]))


@pytest.mark.parametrize("name", MINI)
def test_widen_matches_jnp_astype(name):
    """:func:`widen` of every code is ``jnp.astype(float32)``'s value, bit
    for bit, and NaN where that is NaN."""
    codes = _all_codes(name)
    ours = widen(codes, name).numpy()
    ref = _jnp_widen(codes, name)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    keep = ~np.isnan(ref)
    np.testing.assert_array_equal(ours[keep].view(np.uint32), ref[keep].view(np.uint32))


def _jax_stream_grad_codes(stream, g, name):
    """JAX's stream-row gradient (``stream_blend``'s VJP emits it in the
    primal's dtype, here the stream's type) as codes."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_interp import stream_blend

    pos, bary = jnp.asarray(stream.pos.numpy()), jnp.asarray(stream.bary.numpy())
    sf = jnp.zeros(stream.vids.shape + (g.shape[-1],), name)
    _, vjp = jax.vjp(lambda x: stream_blend(x, pos, bary), sf)
    out = vjp(jnp.asarray(g.numpy()))[0]
    assert out.dtype == jnp.dtype(name)
    return torch.from_numpy(np.asarray(out).view(np.uint8).copy())


def _jax_features_and_grad(field, stream, g, name):
    """JAX's ``endpoint_features(field, stream, stream_dtype=name)`` and its
    field gradient at cotangent ``g``, from one ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import endpoint_features as jax_endpoint_features

    js = _jax_stream(stream)
    out, vjp = jax.vjp(lambda f: jax_endpoint_features(f, js, stream_dtype=name),
                       jnp.asarray(field.numpy()))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g.numpy()))[0])


def _field(num_v):
    """A bf16-exact field of two column blocks: standard normal, then
    positive entries with one in 100 set to +-1e6 (past each type's range
    but float8_e8m0fnu's, whose -1e6 is NaN), so that in the second block
    some rays' slot rows hold a NaN or an infinity in a column and others
    none. Columns blend apart, so one call covers both."""
    rng = np.random.default_rng(4)
    normal = rng.standard_normal((num_v, FIELD_DIM))
    edge = rng.random(normal.shape) < 0.01
    edges = np.where(edge, 1e6 * rng.choice([-1.0, 1.0], normal.shape),
                     np.abs(rng.standard_normal(normal.shape)) + 0.25)
    return _bf16_exact(np.concatenate([normal, edges], axis=1))


@pytest.mark.parametrize("name", MINI)
def test_minifloat_stream_matches_jax(scene, name):
    """The stream against JAX ``endpoint_features(..., stream_dtype=name)``
    and its VJP (:func:`_field`'s two blocks), with the field, ``bary`` and
    ``g`` bf16-exact (so JAX's in-kernel bf16 casts lose nothing: every
    value of the seven types is bf16-exact). Features: NaN where JAX's are
    (its dense blend spreads a slot's NaN or infinity over the ray's
    column: ``interp.dense_nan``), infinities equal, the rest the same rows
    blended in f32 in another order, to 1e-6 of each block's largest entry.
    float8_e8m0fnu has no zero and no sign, so its normal block is NaN
    nearly everywhere on both sides.

    Stream-row gradients: the port's codes and JAX's are the f64 sums
    rounded once, except where an f32 sum (each side's order) may cross a
    rounding boundary (a tie, or float8_e8m0fnu's 0): there each is a code
    that a value within the f32 sums' error bound of the exact sum rounds
    to, and such codes are at most 1e-3 of them. Field gradient: NaN where JAX's is, the rest
    the same rows summed in f32 in another order, to 1e-6 of its largest
    entry plus, in each entry, the steps of the boundary codes scattered
    there."""
    stream, t = scene["stream"], STREAM_TYPES[name]
    num_v = scene["mesh"].num_vertices
    field = _field(num_v)
    width = field.shape[1]
    g = _bf16_exact(np.random.default_rng(5).standard_normal(stream.pos.shape[:2] + (width,)))
    feats = endpoint_features(field, stream, stream_dtype=name)
    ref_all, ref_g = _jax_features_and_grad(field, stream, g, name)
    assert feats.dtype == torch.float32
    for block in ("normal", "edges"):
        cols = slice(0, FIELD_DIM) if block == "normal" else slice(FIELD_DIM, width)
        ours, ref = feats.numpy()[..., cols], ref_all[..., cols]
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        fin = np.isfinite(ref)
        inf = ~fin & ~np.isnan(ref)
        np.testing.assert_array_equal(ours[inf], ref[inf])
        if fin.any():
            np.testing.assert_allclose(ours[fin], ref[fin], rtol=0,
                                       atol=1e-6 * np.abs(ref[fin]).max())
        if block == "edges" or name != "float8_e8m0fnu":
            assert fin.mean() > 0.3  # finite endpoints to compare
        if block == "edges" and name != "float4_e2m1fn":
            assert 0 < (~fin).sum() and (~fin).mean() < 0.9  # columns with and without

    num_stream = stream.vids.shape[1]
    gsf = interp.stream_blend_backward(g, stream.pos, stream.bary, num_stream, name)
    assert gsf.dtype == torch.uint8
    exact = interp.stream_blend_backward(g.double(), stream.pos, stream.bary.double(),
                                         num_stream)
    ref_gsf = _jax_stream_grad_codes(stream, g, name)
    # Each f32 sum lies within n 2^-24 sum(|terms|) of the exact sum.
    terms = interp.stream_blend_backward(torch.ones_like(g), stream.pos,
                                         (stream.bary != 0).float(), num_stream)
    mass = interp.stream_blend_backward(g.abs().double(), stream.pos,
                                        stream.bary.abs().double(), num_stream)
    err = terms.double() * 2.0 ** -24 * mass
    lo, hi = round_to((exact - err).float(), name), round_to((exact + err).float(), name)
    edge = lo != hi
    assert int(edge.sum()) <= 1e-3 * edge.numel()
    # Rounding is monotone between the NaNs: a code between lo's and hi's
    # values, or NaN where either is.
    vlo, vhi = widen(lo, t), widen(hi, t)
    for codes in (gsf, ref_gsf):
        assert torch.equal(codes[~edge], round_to(exact.float(), name)[~edge])
        v = widen(codes, t)
        ok = (v.isnan() & (vlo.isnan() | vhi.isnan())) | (
            (v >= torch.where(vlo.isnan(), -float("inf"), vlo))
            & (v <= torch.where(vhi.isnan(), float("inf"), vhi)))
        assert torch.all(ok[edge])
    moved = gsf != ref_gsf

    ours_g = _port_field_grad(field, stream, g, stream_dtype=name)
    np.testing.assert_array_equal(np.isnan(ours_g), np.isnan(ref_g))
    steps = torch.where(moved, (widen(gsf, t) - widen(ref_gsf, t)).abs(), 0.0)
    budget = scatter.scatter_add_rows_twin(stream.vids.reshape(-1).clamp_min(0),
                                           steps.reshape(-1, width), num_v).numpy()
    keep = ~np.isnan(ref_g)
    assert keep.any()
    scale = np.abs(ref_g[keep]).max()
    assert np.all(np.abs(ours_g - ref_g)[keep] <= 1e-6 * scale + budget[keep])


def test_dense_nan_rule_by_hand():
    """One ray of four slots and three endpoints, float8_e3m4 rows; slots 2
    and 3 hold an infinity (100 overflows) in column 0. Endpoint 0 weights
    neither: NaN (JAX: ``0 * inf``). Endpoint 1 weights slot 2 twice (one
    slot) and not slot 3: NaN. Endpoint 2 weights both: infinity. Column
    1 stays finite; JAX's ``endpoint_features`` gives the same."""
    import jax.numpy as jnp
    from tetranerf_torch.ops.march import MarchStream
    from tetranerf_tpu.ops.fused import endpoint_features as jax_endpoint_features

    x = torch.tensor([[1.0, 2.0], [4.0, 0.5], [100.0, 8.0], [100.0, 1.0]])
    stream = MarchStream(vids=torch.tensor([[0, 1, 2, 3]], dtype=torch.int32),
                         pos=torch.tensor([[[0, 1, 0, 0], [2, 0, 2, 1], [2, 3, 0, 1]]],
                                          dtype=torch.int32),
                         bary=torch.tensor([[[0.5, 0.5, 0.0, 0.0]] + [[0.25] * 4] * 2]))
    out = interp.stream_blend_gather(round_to(x, "float8_e3m4"), *stream, "float8_e3m4")
    inf = float("inf")
    want = torch.tensor([[[float("nan"), 1.25], [float("nan"), 4.625], [inf, 2.875]]])
    torch.testing.assert_close(out, want, atol=0, rtol=0, equal_nan=True)
    ref = jax_endpoint_features(jnp.asarray(x.numpy()), _jax_stream(stream),
                                stream_dtype="float8_e3m4")
    torch.testing.assert_close(out, torch.from_numpy(np.asarray(ref)), atol=0, rtol=0,
                               equal_nan=True)


# The train forward's loss scale of each type: the stream-row cotangents at
# the same multiple of the type's smallest step as LOSS_SCALE puts them for
# float8_e4m3fnuz (2^12 x its 2^-10; float4_e2m1fn's step is 2^-1, so
# 2^21). The field-gradient gates are tests/test_torch_stream_levers.py's
# float8_e4m3fn gate (6e-2).
MODEL_SCALES = {"float8_e4m3fnuz": LOSS_SCALE, "float4_e2m1fn": 2.0 ** 21,
                "float8_e8m0fnu": LOSS_SCALE}
MODEL_GATES = {"float8_e4m3fnuz": 6e-2, "float4_e2m1fn": 6e-2}


@pytest.mark.parametrize("name", list(MODEL_SCALES))
def test_minifloat_train_forward_matches_jax_model(model_setup, name):
    """A train forward with ``field_stream_dtype=name`` in four buckets, and
    the field gradient of its scaled loss, against the JAX model's with the
    same random numbers, at the gates of the f16 and fp8 streams' model
    test (the loss to 1e-5 of itself, the field gradient to
    :data:`MODEL_GATES` of its largest entry; measured: the loss 7.7e-8
    and 2.4e-7 of itself, the field gradient 3.0e-2 and 5.0e-2,
    float8_e4m3fnuz and float4_e2m1fn; 30% of either field gradient is
    nonzero). JAX's blend rounds the rows' weights to bf16, so its samples
    move and cotangent codes flip with them; float4_e2m1fn's one
    significand bit makes a flip up to half an entry, and at other loss
    scales its error was 0.11-0.14 (2^20, 2^24), 0.5 at 2^16 (1% nonzero).
    With float8_e8m0fnu the field's entries below zero are NaN on both
    sides: the loss is NaN in both models, and so is every field gradient
    entry JAX's is."""
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
        return MODEL_SCALES[name] * jnp.mean(jnp.square(out["rgb"] - target))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(s["params"])
    model = s["port_model"](field_stream_dtype=name)
    out = model.get_outputs(torch.from_numpy(s["o"]), torch.from_numpy(s["d"]), s["mesh"],
                            occ_depth_cap=CAP, train=True, bucket_steps=BUCKETS,
                            uniforms=_step_uniforms(rng, model, 64, 64, BUCKETS))
    loss = MODEL_SCALES[name] * model.loss(out, torch.from_numpy(target))
    loss.backward()
    ref_g = np.asarray(grads_ref["tetrahedra_field"])
    ours = model.tetrahedra_field.grad.numpy()
    if name == "float8_e8m0fnu":
        assert np.isnan(float(loss_ref)) and np.isnan(float(loss.detach()))
        assert np.isnan(ours[np.isnan(ref_g)]).all() and np.isnan(ref_g).any()
        return
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-5 * float(loss_ref)
    assert (ref_g != 0).mean() > 0.05
    assert _rel_err(ours, ref_g) <= MODEL_GATES[name]


# --------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", MINI)
def test_minifloat_rounding_on_the_card_matches_jnp_astype(cuda_device, name):
    """The field's cast on the card (:func:`round_to`, torch ops) and K2b's
    instance (each boundary value the f32 sum of one endpoint of weight 1)
    give ``BOUNDARY_CODES``, the codes ``jnp.astype`` gives, bit for bit.
    K2b's sums are the card's arithmetic, whose NaN is positive and whose
    0 + -0 is +0: -NaN and -0 are left to the cast."""
    x = torch.tensor(boundary_values(name))
    codes = torch.tensor(BOUNDARY_CODES[name], dtype=torch.uint8)
    assert torch.equal(round_to(x.to(cuda_device), name).cpu(), codes)
    sums = ~(torch.signbit(x) & ((x == 0) | x.isnan()))
    x, codes = x[sums], codes[sums]
    n = x.numel()
    g = x[None, :, None].expand(1, n, 2).contiguous()
    pos = torch.full((1, n, 4), n, dtype=torch.int32)  # the zero weights: slot n
    pos[0, :, 0] = torch.arange(n, dtype=torch.int32)
    bary = torch.zeros((1, n, 4))
    bary[..., 0] = 1.0
    gsf, launched = _launched(lambda: interp.stream_blend_backward(
        g.to(cuda_device), pos.to(cuda_device), bary.to(cuda_device), n + 1, name).cpu())
    assert launched == {"stream_blend_backward" + STREAM_TYPES[name].suffix: 1}
    assert torch.equal(gsf[0, :n], codes[:, None].expand(n, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", MINI)
def test_minifloat_blend_kernel_matches_twin(scene, cuda_device, name):
    """K2's software instance: the widened rows blend as the twin's do
    (1e-5: the kernel may contract into FMAs), NaN where the twin's are
    (the dense-NaN rule), at widths 16 and 64 (4-code loads) and 6 (2-code
    loads), on a normal field and on one scaled past the type's range in
    places; and every code, each the one weighted row of its one-slot ray,
    widens exactly."""
    s = scene["stream"]
    counter = "stream_blend_gather" + STREAM_TYPES[name].suffix
    args = [x.to(cuda_device) for x in (s.vids, s.pos, s.bary)]
    for feat in (16, 64, 6):
        for scale in (1.0, 40.0):
            x = torch.randn(scene["mesh"].num_vertices, feat,
                            generator=torch.Generator().manual_seed(feat))
            field = round_to(x * scale, name)
            out, launched = _launched(lambda: interp.stream_blend_gather(
                field.to(cuda_device), *args, name))
            ref = interp.stream_blend_gather_twin(field, s.vids, s.pos, s.bary, name)
            assert out.dtype == torch.float32 and launched == {counter: 1}
            torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0, equal_nan=True)
    codes = torch.cat([_all_codes(name), torch.zeros(16, dtype=torch.uint8)])
    rows = codes[:codes.numel() // 16 * 16].reshape(-1, 16)
    num = rows.shape[0]
    vids = torch.arange(num, dtype=torch.int32)[:, None]
    pos = torch.zeros((num, 1, 4), dtype=torch.int32)
    bary = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(num, 1, 4).contiguous()
    out = interp.stream_blend_gather(rows.to(cuda_device), vids.to(cuda_device),
                                     pos.to(cuda_device), bary.to(cuda_device), name)
    torch.testing.assert_close(out[:, 0].cpu(), widen(rows, name), atol=0, rtol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MINI)
def test_minifloat_blend_backward_kernel_matches_twin(scene, cuda_device, name):
    """K2b's software instance: its codes are K2b's f32 instance's sums
    rounded as :func:`round_to` rounds, bit for bit, and where the twin's
    f32 sums are in the type's range (rounding to a finite value of it)
    within one rounding of them (``one_rounding_bound``) plus 1e-6 for the
    order of the f32 sums, at widths 16 and 64 for four seeds."""
    s = scene["stream"]
    t = STREAM_TYPES[name]
    counter = "stream_blend_backward" + t.suffix
    pos, bary = s.pos.to(cuda_device), s.bary.to(cuda_device)
    for feat in (16, 64):
        for seed in range(4):
            g = torch.randn(s.pos.shape[:2] + (feat,),
                            generator=torch.Generator().manual_seed(seed))
            out, launched = _launched(lambda: interp.stream_blend_backward(
                g.to(cuda_device), pos, bary, s.vids.shape[1], name))
            f32 = interp.stream_blend_backward(g.to(cuda_device), pos, bary, s.vids.shape[1])
            assert out.dtype == torch.uint8 and launched == {counter: 1}
            assert torch.equal(out.cpu(), round_to(f32.cpu(), name))
            ref = interp.stream_blend_backward_twin(g, s.pos, s.bary, s.vids.shape[1])
            inside = widen(round_to(ref, name), name).isfinite() & (ref.abs() <= widen(
                torch.tensor([t.max_code], dtype=torch.uint8), name))
            err = (widen(out.cpu(), name) - ref).abs()
            assert torch.all((err <= one_rounding_bound(ref, name, sum_atol=1e-6))[inside])


@pytest.mark.cuda
@pytest.mark.parametrize("name", MINI)
def test_minifloat_scatter_kernel_matches_twin(cuda_device, name):
    """K7's software instance on the crowded stream's ids (~230 rows a
    vertex) and ids out of range at widths 16, 64 and 3 (4-, 2- and 1-code
    loads): f32 sums of the widened rows in atomic order (1e-4); and every
    code, each the one row of its table row, widens exactly."""
    s = _crowded_stream()
    counter = "scatter_add_rows" + STREAM_TYPES[name].suffix
    idx = s.vids.reshape(-1).clone()
    idx[::7] = -1
    idx[::11] = 99
    for feat in (16, 64, 3):
        vals = round_to(torch.randn(idx.shape[0], feat,
                                    generator=torch.Generator().manual_seed(feat)), name)
        out, launched = _launched(lambda: scatter.scatter_add_rows(
            idx.to(cuda_device), vals.to(cuda_device), 5, name))
        ref = scatter.scatter_add_rows_twin(idx, vals, 5, name)
        assert out.dtype == torch.float32 and launched == {counter: 1}
        torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0, equal_nan=True)
    vals = _all_codes(name).reshape(-1, 16)
    rows = torch.arange(vals.shape[0], dtype=torch.int32)
    out = scatter.scatter_add_rows(rows.to(cuda_device), vals.to(cuda_device), vals.shape[0],
                                   name)
    torch.testing.assert_close(out.cpu(), widen(vals, name), atol=0, rtol=0, equal_nan=True)
