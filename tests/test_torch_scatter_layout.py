"""K7's zero-code table (``StreamType.zero_mask``, ``csrc/common.cuh``
``ZeroCode``): the codes K7 skips unread before it widens a row are
exactly the codes whose value is +0 or -0, for every code of every narrow
row type, by the port's widening and by ``ml_dtypes`` through
``jnp.astype``. The kernel's own copy of the table is held to this one on
the card (``tests/test_torch_backward.py``, ``-m cuda``).

JAX is imported inside tests only.
"""

import numpy as np
import pytest
import torch

from tetranerf_torch.ops.stream_dtypes import STREAM_TYPES, widen

NARROW = [name for name in STREAM_TYPES if name != "float32"]


def all_codes(name):
    """Every code of the row type ``name`` in its storage dtype: 256 of an
    8-bit type (a 4-bit type's byte too), 65,536 of bf16 and f16."""
    t = STREAM_TYPES[name]
    if t.storage.itemsize == 1:
        codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        return codes if t.minifloat else codes.view(t.storage)
    return torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(t.storage)


def code_bits(codes):
    """The codes as non-negative integers."""
    if codes.element_size() == 1:
        return codes.view(torch.uint8).long()
    return codes.view(torch.int16).long() & 0xFFFF


def zero_by_mask(name, codes):
    mask = STREAM_TYPES[name].zero_mask
    if mask is None:
        return torch.zeros(codes.shape, dtype=torch.bool)
    return (code_bits(codes) & mask) == 0


@pytest.mark.parametrize("name", NARROW)
def test_zero_mask_is_the_codes_that_widen_to_zero(name):
    """The table against the port's widening (``stream_dtypes.widen``) over
    every code: +0 and -0 where the type has both, only 0x00 for the fnuz
    types (0x80 is their NaN), 0x0 and 0x8 in float4_e2m1fn's low nibble,
    none for float8_e8m0fnu."""
    codes = all_codes(name)
    want = widen(codes, name) == 0
    got = zero_by_mask(name, codes)
    assert torch.equal(got, want)
    t = STREAM_TYPES[name]
    expected = {"unsigned": 1, "nan": 0}.get(t.zero, 2)
    if name == "float4_e2m1fn":
        expected = 2 * 16  # the high nibble is not read
    assert int(got.sum()) == expected


@pytest.mark.parametrize("name", NARROW)
def test_zero_mask_is_the_codes_ml_dtypes_reads_as_zero(name):
    """The table against ``jnp.astype(float32)`` of every code viewed as the
    ``ml_dtypes`` type."""
    import jax.numpy as jnp
    import ml_dtypes

    codes = all_codes(name)
    raw = code_bits(codes).numpy().astype(np.uint8 if codes.element_size() == 1 else np.uint16)
    values = np.asarray(jnp.asarray(raw.view(jnp.dtype(name))).astype(jnp.float32))
    assert jnp.dtype(name) == np.dtype(getattr(ml_dtypes, name, name))
    assert np.array_equal(zero_by_mask(name, codes).numpy(), values == 0)


def test_zero_mask_of_f32_rows():
    """The f32 instance's mask on f32 bit patterns: +0 and -0 only (not the
    smallest subnormals, NaN or infinity)."""
    bits = torch.tensor([0, 1 << 31, 1, (1 << 31) | 1, 0x7F800000, 0x7FC00000, 0x00800000,
                         -1], dtype=torch.int64).to(torch.int32)
    values = bits.view(torch.float32)
    mask = STREAM_TYPES["float32"].zero_mask
    assert torch.equal((bits.long() & mask) == 0, values == 0)
    assert int(((bits.long() & mask) == 0).sum()) == 2


# ------------------------------------------- the padding slots K7 skips

FIELD_DIM = 16
# The twin and JAX sum in f32 in other orders (tests/test_torch_scatter_jax.py).
SUM_ATOL = 1e-4


@pytest.fixture(scope="module")
def march():
    """A 400-point sphere, 48 rays marched to 40 intervals (the port's twin
    of K1): some rays use every slot of the stream, others few."""
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.ops.fused import march_features
    from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays

    points, _ = make_sphere_scene(400, seed=0)
    mesh = build_mesh(points, device="cpu")
    o, d = sample_sphere_rays(np.random.default_rng(0), 48)
    res = march_features(mesh, None, torch.from_numpy(o), torch.from_numpy(d), 40)
    width = res.stream.vids.shape[1]
    used = res.num_valid.long() + 4
    assert bool((used < width).any()) and bool((used >= width).any())
    return dict(res=res, num_v=mesh.num_vertices)


def _field_grad(march, name, g, num_valid):
    """The port's field gradient of the march's stream in row type ``name``
    at cotangent ``g``, and the jobs its K7 got."""
    from tetranerf_torch.ops import interp
    from tetranerf_torch.ops.fused import endpoint_features

    res = march["res"]
    field = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (march["num_v"], FIELD_DIM)).astype(np.float32))
    if name == "float8_e8m0fnu":  # no sign: its field's magnitudes
        field = field.abs()
    field.requires_grad_()
    seen = []
    real = interp.scatter_add_rows_batch

    def spy(jobs, num_rows, row_type=None):
        seen.append(list(jobs))
        return real(jobs, num_rows, row_type)

    interp.scatter_add_rows_batch = spy
    try:
        endpoint_features(field, res.stream, stream_dtype=name,
                          num_valid=res.num_valid if num_valid else None).backward(g)
    finally:
        interp.scatter_add_rows_batch = real
    (jobs,) = seen
    return field.grad, jobs


@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_dropping_padding_slots_leaves_the_field_gradient(march, name):
    """With the march's ``num_valid``, K7's job carries it (its rows past
    each ray's ``num_valid + 4`` are not read), and the field gradient is
    the one without, bit for bit and NaN where it is NaN. float8_e8m0fnu's
    padding rows are NaN (its rounding of 0), and row 0 is NaN either way,
    as JAX's ``gather_rows_lowp`` makes it."""
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        march["res"].stream.pos.shape[:2] + (FIELD_DIM,)).astype(np.float32))
    full, (full_job,) = _field_grad(march, name, g, num_valid=False)
    cut, (cut_job,) = _field_grad(march, name, g, num_valid=True)
    assert len(full_job) == 2 and len(cut_job) == 3
    assert torch.equal(cut.isnan(), full.isnan())
    assert torch.equal(cut.nan_to_num().view(torch.int32), full.nan_to_num().view(torch.int32))
    assert bool(full[0].isnan().all()) == (name == "float8_e8m0fnu")


# A 2-byte type, a type whose only zero code is 0x00 and the type without
# zero (every type's scatter against JAX: tests/test_torch_scatter_jax.py).
JAX_TYPES = ("bfloat16", "float8_e4m3fnuz", "float8_e8m0fnu")


@pytest.mark.parametrize("name", JAX_TYPES)
def test_stream_job_without_padding_matches_jax_lowp_vjp(march, name):
    """The K7 job of the stream's rows in row type ``name`` (seeded stream
    gradients rounded to it, K2b's rounding of 0 in the padding slots) with
    the march's ``num_valid``, through the twin, against ``jax.vjp`` of
    ``gather_rows_lowp`` with those rows as its cotangent over every slot
    (ids clamped at 0): NaN where JAX's is (float8_e8m0fnu's row 0 among
    them), the rest to the order of f32 sums."""
    import jax
    import jax.numpy as jnp
    from tetranerf_torch.ops.scatter import scatter_add_rows_batch_twin
    from tetranerf_torch.ops.stream_dtypes import round_to
    from tetranerf_tpu.ops.fused import gather_rows_lowp

    res = march["res"]
    vids = res.stream.vids
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(vids.shape + (FIELD_DIM,)).astype(np.float32)
    used = np.arange(vids.shape[1])[None, :] < res.num_valid.numpy()[:, None] + 4
    vals[~used] = 0.0  # K2b's padding rows
    if name == "float8_e8m0fnu":
        vals = np.abs(vals)
    rows = round_to(torch.from_numpy(vals), name).reshape(-1, FIELD_DIM).contiguous()
    ids = vids.clamp_min(0).reshape(-1)
    job = (ids, rows, res.num_valid)
    ours = scatter_add_rows_batch_twin([job], march["num_v"], name).numpy()
    field = jnp.zeros((march["num_v"], FIELD_DIM), jnp.float32)
    cot = jnp.asarray(widen(rows, name).numpy()).astype(name).reshape(
        vids.shape + (FIELD_DIM,))
    _, vjp = jax.vjp(lambda f: gather_rows_lowp(f, jnp.asarray(vids.numpy()), name), field)
    ref = np.asarray(vjp(cot)[0])
    assert np.array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(np.nan_to_num(ours), np.nan_to_num(ref), atol=SUM_ATOL, rtol=0)
    assert bool(np.isnan(ours[0]).all()) == (name == "float8_e8m0fnu")


def test_budgeted_stream_job_without_padding_matches_jax(march):
    """The gradient-stream budget with the padding slots skipped: the K7
    job of f32 stream rows with ``stream_budget_ids``' ids (a budget inside
    a ray) and the march's ``num_valid``, through the twin, against
    ``jax.vjp`` of JAX's ``_stream_gather`` (counts ``num_valid + 4``) with
    those rows as its cotangent, to the order of f32 sums."""
    import jax
    import jax.numpy as jnp
    from tetranerf_torch.ops.fused import stream_budget_ids
    from tetranerf_torch.ops.scatter import scatter_add_rows_batch_twin
    from tetranerf_tpu.ops.fused import _stream_gather

    res = march["res"]
    vids, nv = res.stream.vids, res.num_valid
    counts = torch.clamp_max(nv.long() + 4, vids.shape[1])
    ends = torch.cumsum(counts, 0)
    offs = ends - counts
    budget = int(offs[20]) + 3
    last = torch.zeros(len(nv), dtype=torch.bool)
    last[-1] = True
    ids = stream_budget_ids(vids, counts, offs, budget, last)
    rng = np.random.default_rng(4)
    rows = rng.standard_normal(vids.shape + (FIELD_DIM,)).astype(np.float32)
    rows[np.arange(vids.shape[1])[None, :] >= counts.numpy()[:, None]] = 0.0  # padding
    job = (ids.reshape(-1), torch.from_numpy(rows).reshape(-1, FIELD_DIM), nv)
    ours = scatter_add_rows_batch_twin([job], march["num_v"]).numpy()
    field = jnp.zeros((march["num_v"], FIELD_DIM), jnp.float32)
    _, vjp = jax.vjp(lambda f: _stream_gather(f, jnp.asarray(vids.numpy()),
                                              jnp.asarray(nv.numpy() + 4), budget), field)
    ref = np.asarray(vjp(jnp.asarray(rows))[0])
    np.testing.assert_allclose(ours, ref, atol=SUM_ATOL, rtol=0)
    assert np.abs(ref).max() > 0


def stream_job(rng, rays, width, num_rows, feat, name):
    """A stream job ``(ids, rows, num_valid)`` of ``rays`` x ``width`` slots
    in the row type ``name``: ``num_valid`` from 0 to ``width`` (some rays
    without padding), ids in range or -1, the padding slots' ids mostly 0
    with runs of others, and garbage in the padding rows (random codes,
    which K7 must not read)."""
    nv = rng.integers(0, width + 1, rays).astype(np.int32)
    ids = rng.integers(-1, num_rows, (rays, width)).astype(np.int32)
    pad = np.arange(width)[None, :] >= nv[:, None] + 4
    ids[pad] = np.where(rng.random(int(pad.sum())) < 0.7, 0,
                        np.repeat(rng.integers(0, num_rows, int(pad.sum()) // 3 + 1), 3)
                        [:int(pad.sum())])
    vals = rng.standard_normal((rays * width, feat)).astype(np.float32)
    if name == "float8_e8m0fnu":
        vals = np.abs(vals)
    rows = round_to_codes(vals, name)
    return (torch.from_numpy(ids.reshape(-1)), rows, torch.from_numpy(nv)), pad.reshape(-1)


def round_to_codes(vals, name):
    from tetranerf_torch.ops.stream_dtypes import round_to

    return round_to(torch.from_numpy(vals), name).contiguous()


@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_twin_takes_padding_rows_as_the_rounding_of_zero(name):
    """A stream job's padding rows are not read: the twin with
    ``num_valid`` on rows with garbage there equals the twin without it on
    the same rows with K2b's rounding of 0 in their place (nothing for a
    type with a zero, NaN on every padding id for float8_e8m0fnu)."""
    from tetranerf_torch.ops.scatter import scatter_add_rows_batch_twin

    (ids, rows, nv), pad = stream_job(np.random.default_rng(6), 40, 24, 50, 8, name)
    assert pad.any() and not pad.all()
    clean = rows.clone()
    clean[torch.from_numpy(pad)] = round_to_codes(np.zeros((1, 8), np.float32), name)
    got = scatter_add_rows_batch_twin([(ids, rows, nv)], 50, name)
    want = scatter_add_rows_batch_twin([(ids, clean)], 50, name)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert bool(got[0].isnan().all()) == (name == "float8_e8m0fnu")
