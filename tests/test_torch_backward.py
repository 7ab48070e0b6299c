"""The backward kernels' twins (K2b stream-blend transpose, K3b sample-interp
transpose, K7 row scatter-add, one job or a batch) against a float64 numpy
oracle and the JAX package's VJPs, the autograd Functions under
``gradcheck``, and the kernels (on a GPU) against the twins.

JAX is imported inside tests only, so the CUDA cases also run where JAX is
absent: ``python -m pytest --noconftest -m cuda tests/test_torch_backward.py``.
"""

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import build_mesh
from tetranerf_torch.models.tetra_nerf import GradientScaler
from tetranerf_torch.ops import cuda
from tetranerf_torch.ops.fused import ray_bounds
from tetranerf_torch.ops.interp import (
    SampleInterp,
    StreamBlendGather,
    StreamBlendGatherBatch,
    sample_interp_backward,
    sample_interp_backward_twin,
    stream_blend_backward,
    stream_blend_backward_twin,
    stream_blend_gather_twin,
)
from tetranerf_torch.ops.march import march
from tetranerf_torch.ops.scatter import (
    gather_rows,
    scatter_add_rows,
    scatter_add_rows_batch,
    scatter_add_rows_batch_twin,
    scatter_add_rows_twin,
)
from tetranerf_torch.ops.stream_dtypes import STREAM_TYPES, round_to, widen
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays
from test_torch_scatter_jax import hot_jobs
from test_torch_scatter_layout import all_codes, stream_job

FIELD_DIM = 16
MAX_STEPS = 64
# f32 sums of a handful of products, against float64.
ORACLE_ATOL = 1e-5
# The JAX Pallas transposes contract in bfloat16 (tests/test_pallas_interp.py:50).
BF16_ATOL, BF16_RTOL = 5e-2, 1e-2


@pytest.fixture(scope="module")
def scene():
    """The 800-point sphere marched by 64 rays, sample distances that cover
    every interval plus a margin before and after each ray's range (so
    masked samples are exercised), and random cotangents."""
    points, _ = make_sphere_scene(800, seed=0)
    mesh = build_mesh(points, device="cpu")
    origins, directions = sample_sphere_rays(np.random.default_rng(1), 64)
    res = march(mesh, torch.from_numpy(origins), torch.from_numpy(directions),
                max_steps=MAX_STEPS)
    nears, fars, _, _, ray_mask = ray_bounds(res)
    u = torch.linspace(-0.05, 1.05, 41)
    distances = (nears[:, None] + u[None] * (fars - nears)[:, None]).contiguous()
    rng = np.random.default_rng(2)
    s = res.stream
    return dict(
        points=points, mesh=mesh, res=res, ray_mask=ray_mask,
        distances=distances, origins=origins, directions=directions,
        field=rng.uniform(-1, 1, (mesh.num_vertices, FIELD_DIM)).astype(np.float32),
        g_end=rng.standard_normal(s.pos.shape[:2] + (FIELD_DIM,)).astype(np.float32),
        g_samp=rng.standard_normal(distances.shape + (FIELD_DIM,)).astype(np.float32),
    )


def _interp_args(scene):
    res = scene["res"]
    return (res.t0.contiguous(), res.t1.contiguous(), res.num_valid,
            scene["ray_mask"], scene["distances"])


# ------------------------------------------------------------ (a) oracles


def test_blend_backward_twin_matches_float64_oracle(scene):
    s = scene["res"].stream
    rows = slice(0, 8)  # the python-loop oracle is slow; 8 rays x 65 endpoints
    pos, bary = s.pos[rows], s.bary[rows]
    g = scene["g_end"][rows]
    num_stream = s.vids.shape[1]
    out = stream_blend_backward_twin(torch.from_numpy(g), pos, bary, num_stream)
    ref = np.zeros((g.shape[0], num_stream, FIELD_DIM))
    p, b = pos.numpy(), bary.numpy().astype(np.float64)
    for r in range(g.shape[0]):
        for e in range(g.shape[1]):
            for j in range(4):
                ref[r, p[r, e, j]] += b[r, e, j] * g[r, e].astype(np.float64)
    np.testing.assert_allclose(out.numpy(), ref, atol=ORACLE_ATOL, rtol=0)
    assert np.abs(ref).max() > 0.1  # not a comparison of zeros


def test_interp_backward_twin_matches_float64_oracle(scene):
    res = scene["res"]
    t0, t1 = res.t0.numpy(), res.t1.numpy()
    nv, mask_r = res.num_valid.numpy(), scene["ray_mask"].numpy()
    dist, g = scene["distances"].numpy(), scene["g_samp"]
    out = sample_interp_backward_twin(*_interp_args(scene), torch.from_numpy(g))
    ref = np.zeros((t1.shape[0], t1.shape[1] + 1, FIELD_DIM))
    kept = 0
    for r in range(t1.shape[0]):
        for s, d in enumerate(dist[r]):
            k = int(np.sum(t1[r] <= d))
            if not (mask_r[r] and k < nv[r] and d >= t0[r, k]):
                continue
            kept += 1
            frac = np.clip((np.float64(d) - t0[r, k]) / max(t1[r, k] - t0[r, k], 1e-20), 0, 1)
            ref[r, k] += (1 - frac) * g[r, s]
            ref[r, k + 1] += frac * g[r, s]
    assert 0 < kept < dist.size  # masked samples are exercised
    np.testing.assert_allclose(out.numpy(), ref, atol=ORACLE_ATOL, rtol=0)


def test_scatter_twin_matches_float64_oracle():
    rng = np.random.default_rng(3)
    idx = rng.integers(-2, 60, 500).astype(np.int32)  # some < 0, some >= 50
    vals = rng.standard_normal((500, 24)).astype(np.float32)
    out = scatter_add_rows_twin(torch.from_numpy(idx), torch.from_numpy(vals), 50)
    ref = np.zeros((50, 24))
    keep = (idx >= 0) & (idx < 50)
    np.add.at(ref, idx[keep], vals[keep].astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, atol=ORACLE_ATOL, rtol=0)


# ------------------------------------------------- (b) the JAX VJPs


def test_blend_backward_matches_jax_vjp(scene):
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_interp import stream_blend

    s = scene["res"].stream
    pos, bary = jnp.asarray(s.pos.numpy()), jnp.asarray(s.bary.numpy())
    stream_field = jnp.asarray(scene["field"])[jnp.maximum(jnp.asarray(s.vids.numpy()), 0)]
    _, vjp = jax.vjp(lambda sf: stream_blend(sf, pos, bary), stream_field)
    (ref,) = vjp(jnp.asarray(scene["g_end"]))
    out = stream_blend_backward(torch.from_numpy(scene["g_end"]), s.pos, s.bary,
                                s.vids.shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BF16_ATOL,
                               rtol=BF16_RTOL)


def test_field_gradient_matches_jax_endpoint_features(scene):
    """K2b then K7 (StreamBlendGather's backward) against the VJP of the
    JAX ``endpoint_features``: the Pallas transpose, then autodiff's scatter
    of ``field[max(vids, 0)]``."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import MarchStream as JaxStream, endpoint_features

    s = scene["res"].stream
    jstream = JaxStream(*(jnp.asarray(x.numpy()) for x in (s.vids, s.pos, s.bary)))
    _, vjp = jax.vjp(lambda f: endpoint_features(f, jstream), jnp.asarray(scene["field"]))
    (ref,) = vjp(jnp.asarray(scene["g_end"]))
    field = torch.from_numpy(scene["field"]).requires_grad_()
    out = StreamBlendGather.apply(field, s.vids, s.pos, s.bary)
    out.backward(torch.from_numpy(scene["g_end"]))
    np.testing.assert_allclose(field.grad.numpy(), np.asarray(ref), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    assert np.abs(np.asarray(ref)).max() > 1.0


@pytest.fixture(scope="module")
def jax_interp(scene):
    """A JAX march of the same rays with endpoint features, and the port's
    twin inputs taken from it."""
    import jax.numpy as jnp
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.ops.fused import march_features, ray_bounds as jax_bounds

    jres = march_features(
        jax_build_mesh(scene["points"]), jnp.asarray(scene["field"]),
        scene["origins"], scene["directions"], max_steps=MAX_STEPS,
    )
    nears, fars, _, _, ray_mask = jax_bounds(jres)
    u = np.linspace(-0.05, 1.05, 41, dtype=np.float32)
    nears, fars = np.asarray(nears), np.asarray(fars)
    distances = (nears[:, None] + u[None, :] * (fars - nears)[:, None]).astype(np.float32)
    args = tuple(torch.from_numpy(np.array(x)) for x in (
        jres.t0, jres.t1, jres.num_valid, ray_mask, distances))
    return jres, distances, ray_mask, args


@pytest.mark.parametrize("mode", ["matmul", "pallas"])
def test_interp_backward_matches_jax_vjp(scene, jax_interp, mode):
    """``"matmul"`` (the JAX default ``interp_mode``, ``_interp_matmul_bwd``)
    at float32 is exact; ``"pallas"`` (``_interp_bwd``) contracts in bf16."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import sample_features

    jres, distances, ray_mask, args = jax_interp
    use_matmul = True if mode == "matmul" else "pallas"

    def f(feats):
        return sample_features(jres._replace(feats=feats), distances, ray_mask,
                               use_matmul=use_matmul, compute_dtype=jnp.float32)[0]

    _, vjp = jax.vjp(f, jres.feats)
    (ref,) = vjp(jnp.asarray(scene["g_samp"]))
    out = sample_interp_backward(*args, torch.from_numpy(scene["g_samp"]))
    atol, rtol = (ORACLE_ATOL, 0) if mode == "matmul" else (BF16_ATOL, BF16_RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=rtol)
    assert np.abs(np.asarray(ref)).max() > 1.0


def test_scatter_matches_jax_scatter_add_rows():
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_scatter import scatter_add_rows as jax_scatter

    rng = np.random.default_rng(4)
    idx = rng.integers(-1, 300, 1000).astype(np.int32)  # -1 rows are dropped
    vals = rng.standard_normal((1000, 64)).astype(np.float32)
    ref = jax_scatter(jnp.asarray(idx), jnp.asarray(vals), 300, window_rows=64,
                      chunk=256, interpret=True)
    out = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(vals), 300)
    # Both sum in f32, in different orders.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ORACLE_ATOL, rtol=0)


def _scatter_jobs(rng, sizes, num_rows, feat):
    """Jobs ``(idx i32[n], vals f32[n, feat])``: ids in ``[-1, num_rows +
    30)``, so -1, out-of-range and repeated ids; every third row zero."""
    jobs = []
    for n in sizes:
        idx = rng.integers(-1, num_rows + 30, n).astype(np.int32)
        vals = rng.standard_normal((n, feat)).astype(np.float32)
        vals[::3] = 0.0
        jobs.append((torch.from_numpy(idx), torch.from_numpy(vals)))
    return jobs


def test_scatter_batch_twin_matches_jax_scatter_of_the_concatenation():
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_scatter import scatter_add_rows as jax_scatter

    jobs = _scatter_jobs(np.random.default_rng(12), (700, 290, 10), 300, 64)
    idx = torch.cat([i for i, _ in jobs])
    assert (idx == -1).any() and (idx >= 300).any() and len(idx.unique()) < len(idx)
    ref = jax_scatter(jnp.asarray(idx.numpy()), jnp.asarray(torch.cat([v for _, v in jobs]).numpy()),
                      300, window_rows=64, chunk=256, interpret=True)
    out = scatter_add_rows_batch_twin(jobs, 300)
    # Both sum in f32, in different orders.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ORACLE_ATOL, rtol=0)


def test_scatter_one_job_case_is_the_single_scatter():
    (idx, vals), = _scatter_jobs(np.random.default_rng(13), (500,), 50, 24)
    twin = scatter_add_rows_twin(idx, vals, 50)
    assert torch.equal(scatter_add_rows(idx, vals, 50), twin)
    assert torch.equal(scatter_add_rows_batch([(idx, vals)], 50), twin)


def test_gather_rows_gradient_matches_jax():
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_scatter import gather_rows as jax_gather_rows

    rng = np.random.default_rng(5)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    idx = rng.integers(-1, 40, (12, 7)).astype(np.int32)  # -1 reads row 0
    cot = rng.standard_normal((12, 7, 16)).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda t: jax_gather_rows(t, jnp.asarray(idx), True),
                           jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_()
    out = gather_rows(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref_out))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=ORACLE_ATOL, rtol=0)


# ---------------------------------------------------------- (c) gradcheck


def test_gradcheck_stream_blend_gather():
    rng = np.random.default_rng(6)
    vids = torch.from_numpy(rng.integers(-1, 12, (3, 9)).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 9, (3, 6, 4)).astype(np.int32))
    bary = torch.from_numpy(rng.uniform(-1, 1, (3, 6, 4)))
    bary[:, -1] = 0.0  # a padding endpoint
    field = torch.from_numpy(rng.standard_normal((12, 4))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f: StreamBlendGather.apply(f, vids, pos, bary), (field,)
    )


def _tiny_streams(rng, num_vertices):
    """Three tiny streams of different (R, U, E) in float64, stream ids in
    ``[-1, V)``, the last endpoint of each ray padding."""
    streams = []
    for rays, slots, ends in ((3, 9, 6), (2, 5, 3), (4, 7, 4)):
        vids = torch.from_numpy(rng.integers(-1, num_vertices, (rays, slots)).astype(np.int32))
        pos = torch.from_numpy(rng.integers(0, slots, (rays, ends, 4)).astype(np.int32))
        bary = torch.from_numpy(rng.uniform(-1, 1, (rays, ends, 4)))
        bary[:, -1] = 0.0
        streams.append((vids, pos, bary))
    return streams


def test_gradcheck_stream_blend_gather_batch():
    rng = np.random.default_rng(14)
    flat = [x for s in _tiny_streams(rng, 12) for x in s]
    field = torch.from_numpy(rng.standard_normal((12, 4))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f: StreamBlendGatherBatch.apply(f, None, None, None, *flat), (field,)
    )


def test_batch_field_gradient_is_the_per_stream_sum_and_jax(scene):
    """One backward node for three streams of different (R, T): its one
    field gradient equals the sum of the per-stream ``StreamBlendGather``
    gradients (both in float64, so only the order of the sums differs), and
    the VJP of the JAX ``endpoint_features`` of each."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.fused import MarchStream as JaxStream, endpoint_features
    from test_torch_interp import _three_streams

    streams = [(s.vids, s.pos, s.bary) for s in _three_streams(scene)]
    rng = np.random.default_rng(15)
    gs = [torch.from_numpy(rng.standard_normal(pos.shape[:2] + (FIELD_DIM,)))
          for _, pos, _ in streams]
    field = torch.from_numpy(scene["field"]).double().requires_grad_()
    outs = StreamBlendGatherBatch.apply(
        field, None, None, None, *(x for s in streams for x in s)
    )
    assert len(outs) == 3 and len({o.grad_fn for o in outs}) == 1
    torch.autograd.backward(outs, gs)
    per_stream = torch.zeros_like(field)
    for s, g in zip(streams, gs):
        f = torch.from_numpy(scene["field"]).double().requires_grad_()
        StreamBlendGather.apply(f, *s).backward(g)
        per_stream += f.grad
    torch.testing.assert_close(field.grad, per_stream, atol=1e-6, rtol=0)

    jstreams = [JaxStream(*(jnp.asarray(x.numpy()) for x in s)) for s in streams]
    _, vjp = jax.vjp(lambda f: [endpoint_features(f, js) for js in jstreams],
                     jnp.asarray(scene["field"]))
    (ref,) = vjp([jnp.asarray(g.float().numpy()) for g in gs])
    np.testing.assert_allclose(field.grad.numpy(), np.asarray(ref), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    assert np.abs(np.asarray(ref)).max() > 1.0


def test_gradcheck_sample_interp(scene):
    args = tuple(x[:3] for x in _interp_args(scene))
    max_t = args[1].shape[1]
    feats = torch.from_numpy(
        np.random.default_rng(7).standard_normal((3, max_t + 1, 4))
    ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f: SampleInterp.apply(*args, f)[0], (feats,)
    )


def test_gradcheck_gather_rows():
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.standard_normal((7, 3))).requires_grad_()
    idx = torch.from_numpy(rng.integers(-1, 7, (5, 2)).astype(np.int32))
    assert torch.autograd.gradcheck(lambda t: gather_rows(t, idx), (table,))


def test_gradcheck_gradient_scaler():
    """The backward is the forward's derivative only at ``scaling = 1``
    (elsewhere it scales on purpose): gradcheck there, and the scaled
    backward against its definition."""
    rng = np.random.default_rng(9)
    colors = torch.from_numpy(rng.standard_normal((2, 5, 3))).requires_grad_()
    sigmas = torch.from_numpy(rng.standard_normal((2, 5))).requires_grad_()
    ones = torch.ones(2, 5, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda c, s: GradientScaler.apply(c, s, ones), (colors, sigmas)
    )
    scaling = torch.from_numpy(rng.uniform(0, 1, (2, 5)))
    c, s = GradientScaler.apply(colors, sigmas, scaling)
    assert torch.equal(c, colors) and torch.equal(s, sigmas)
    g_c = torch.from_numpy(rng.standard_normal((2, 5, 3)))
    g_s = torch.from_numpy(rng.standard_normal((2, 5)))
    torch.autograd.backward((c, s), (g_c, g_s))
    torch.testing.assert_close(colors.grad, g_c * scaling[..., None], atol=0, rtol=0)
    torch.testing.assert_close(sigmas.grad, g_s * scaling, atol=0, rtol=0)


def test_backward_wrappers_run_the_twins_on_cpu(scene):
    before = dict(cuda.launch_counts)
    s = scene["res"].stream
    field = torch.from_numpy(scene["field"]).requires_grad_()
    out = StreamBlendGather.apply(field, s.vids, s.pos, s.bary)
    assert torch.equal(out, stream_blend_gather_twin(field.detach(), s.vids, s.pos, s.bary))
    out.sum().backward()
    assert cuda.launch_counts == before


# ------------------------------------------------------ (h) on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 64])
def test_blend_backward_kernel_matches_twin(scene, cuda_device, feat):
    s = scene["res"].stream
    g = torch.from_numpy(
        np.random.default_rng(feat).standard_normal(s.pos.shape[:2] + (feat,))
        .astype(np.float32)
    ).to(cuda_device)
    pos, bary = s.pos.to(cuda_device), s.bary.to(cuda_device)
    before = cuda.launch_counts["stream_blend_backward"]
    out = stream_blend_backward(g, pos, bary, s.vids.shape[1])
    torch.cuda.synchronize()
    assert cuda.launch_counts["stream_blend_backward"] == before + 1
    ref = stream_blend_backward_twin(g, pos, bary, s.vids.shape[1])
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_interp_backward_kernel_matches_twin(scene, cuda_device, order):
    """Sorted samples take the kernel's register-carry path; shuffled ones
    make it add into slots it has flushed before."""
    t0, t1, num_valid, ray_mask, distances = _interp_args(scene)
    if order == "shuffled":
        perm = torch.from_numpy(np.random.default_rng(11).permutation(distances.shape[1]))
        distances = distances[:, perm]
    args = tuple(x.to(cuda_device).contiguous()
                 for x in (t0, t1, num_valid, ray_mask, distances))
    g = torch.from_numpy(scene["g_samp"]).to(cuda_device)
    before = cuda.launch_counts["sample_interp_backward"]
    out = sample_interp_backward(*args, g)
    torch.cuda.synchronize()
    assert cuda.launch_counts["sample_interp_backward"] == before + 1
    torch.testing.assert_close(out, sample_interp_backward_twin(*args, g),
                               atol=1e-5, rtol=0)


def _rows(vals, name):
    """f32 rows ``vals`` in the row type ``name`` (float8_e8m0fnu, which has
    no sign, from their magnitudes; its zero rows round to NaN)."""
    if name == "float8_e8m0fnu":
        vals = vals.abs()
    return round_to(vals, name).contiguous()


def _typed_jobs(jobs, name, device):
    return [(i.to(device), _rows(v, name).to(device)) for i, v in jobs]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_matches_twin(cuda_device, name):
    """Every instance through the one-job entry point: ids -2 to past the
    table, every third row zero (zero rows issue no atomics)."""
    rng = np.random.default_rng(10)
    idx = torch.from_numpy(rng.integers(-2, 1100, 20000).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((20000, 64)).astype(np.float32))
    vals[::3] = 0.0
    rows = _rows(vals, name)
    counter = "scatter_add_rows" + STREAM_TYPES[name].suffix
    before = cuda.launch_counts[counter]
    out = scatter_add_rows(idx.to(cuda_device), rows.to(cuda_device), 1000, name).cpu()
    assert cuda.launch_counts[counter] == before + 1
    twin = scatter_add_rows_twin(idx, rows, 1000, name)
    assert torch.equal(out.isnan(), twin.isnan())
    # Float atomics add in a run-dependent order: equal to rounding only.
    torch.testing.assert_close(out.nan_to_num(), twin.nan_to_num(), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [64, 6, 3])
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_batch_kernel_matches_twin(cuda_device, feat, name):
    """Eight jobs (one of them empty) into one table in one launch: -1,
    out-of-range, repeated ids and zero rows; F=6 and 3 take narrower lane
    loads (a 2-element table vector at 6, single elements at 3)."""
    jobs = _scatter_jobs(np.random.default_rng(feat), (20000, 7000, 0, 1, 3000, 12000, 64, 999),
                         1000, feat)
    _twin_checked(_typed_jobs(jobs, name, cuda_device), 1000, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_batch_kernel_splits_a_long_job_list(cuda_device, name):
    """More jobs than one launch takes (64): two launches, the second adds
    into the table the first zeroed."""
    jobs = _scatter_jobs(np.random.default_rng(16), [500] * 70, 300, 64)
    _twin_checked(_typed_jobs(jobs, name, cuda_device), 300, name, launches=2)


def _twin_checked(jobs, num_rows, name=None, launches=1):
    """K7 on ``jobs`` (on the card) in ``launches`` launches of its row
    type's counter, against the twin on the CPU (on the card
    ``scatter_add_`` flushes subnormals): NaN in the same places, the rest
    to rounding (float atomics add in a run-dependent order). Returns the
    table and the twin's, both on the CPU."""
    counter = "scatter_add_rows" + (STREAM_TYPES[name].suffix if name else "")
    before = cuda.launch_counts[counter]
    out = scatter_add_rows_batch(jobs, num_rows, name).cpu()
    assert cuda.launch_counts[counter] == before + launches
    twin = scatter_add_rows_batch_twin([tuple(x.cpu() for x in job) for job in jobs], num_rows,
                                       name)
    assert out.dtype == torch.float32 and torch.equal(out.isnan(), twin.isnan())
    torch.testing.assert_close(out.nan_to_num(), twin.nan_to_num(), atol=1e-4, rtol=0)
    return out, twin


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_matches_twin_on_a_hot_list(cuda_device, name):
    """Every instance on a train step's kind of job list: 60% of the rows on
    id 0 (mostly zero rows), ids out of range, empty jobs; float8_e8m0fnu's
    zero rows are NaN, all on id 0, and its 2^-127 adds as a subnormal."""
    jobs = hot_jobs(np.random.default_rng(20), (60_000, 0, 9_000, 1, 4_000), 1000, 64, name)
    _twin_checked([(i.to(cuda_device), v.to(cuda_device)) for i, v in jobs], 1000, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_matches_twin_at_model_shard_width(cuda_device, name):
    """F = 64, 32 (a model shard's columns of the flagship field: 32-byte
    rows of a 1-byte type, two 16-byte lanes) and 33 (single elements)."""
    for feat in (64, 32, 33):
        jobs = hot_jobs(np.random.default_rng(feat), [5_000] * 8, 2_000, feat, name)
        _twin_checked([(i.to(cuda_device), v.to(cuda_device)) for i, v in jobs], 2_000, name)


@pytest.mark.cuda
def test_scatter_kernel_keeps_nan_rows_and_subnormals(cuda_device):
    """f32 rows with NaN and infinities on a hot id and elsewhere: NaN where
    the twin has it. float8_e8m0fnu rows of 2^-127 (code 0), 1 (127) and
    NaN (255) on a few ids, NaN mostly: the twin's table exactly (sums of
    2^-127 are exact, and below 1's last bit), the subnormal 2^-127 kept."""
    jobs = hot_jobs(np.random.default_rng(21), (20_000, 3_000), 500, 64)
    vals = jobs[0][1]
    vals[::97, 5] = float("nan")
    vals[::89, 7] = float("inf")
    vals[::2][(jobs[0][0][::2] == 0)] = float("nan")
    _twin_checked([(i.to(cuda_device), v.to(cuda_device)) for i, v in jobs], 500)
    rng = np.random.default_rng(25)
    ids = torch.from_numpy(rng.integers(0, 5, 30_000).astype(np.int32))
    codes = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), (30_000, 64),
                                        p=[0.02, 0.01, 0.97]))
    codes[ids == 4] = 0
    # Row 5: one 2^-127, a subnormal sum.
    jobs = [(ids, codes), (torch.tensor([5], dtype=torch.int32), codes[ids == 4][:1])]
    jobs = [(i.to(cuda_device), v.to(cuda_device)) for i, v in jobs]
    out, twin = _twin_checked(jobs, 6, "float8_e8m0fnu")
    assert torch.equal(out.nan_to_num(), twin.nan_to_num())
    assert bool(out[:4].isnan().all())
    assert bool((out[4] == int((ids == 4).sum()) * 2.0 ** -127).all())
    assert bool((out[5] == 2.0 ** -127).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_keeps_nan_rows_of_every_type(cuda_device, name):
    """Rows rounded from f32 values with NaN components on the hot id and
    elsewhere (NaN codes where the type has them; float4_e2m1fn rounds NaN
    to -0): NaN exactly where the twin's."""
    jobs = hot_jobs(np.random.default_rng(26), (20_000, 3_000), 500, 64)
    vals = jobs[0][1]
    vals[::97, 5] = float("nan")
    vals[::2][(jobs[0][0][::2] == 0)] = float("nan")
    _twin_checked(_typed_jobs(jobs, name, cuda_device), 500, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_takes_more_than_64_jobs_of_a_hot_list(cuda_device, name):
    """70 jobs of the hot-id kind: two launches, the second adding into the
    first's table."""
    jobs = hot_jobs(np.random.default_rng(22), [900] * 70, 300, 64, name)
    _twin_checked([(i.to(cuda_device), v.to(cuda_device)) for i, v in jobs], 300, name,
                  launches=2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_alignment(cuda_device, name):
    """Values one element and 8 bytes off a 16-byte boundary take the
    narrower lane loads (one element, 8 bytes); a values address that is
    not a multiple of its element size is refused with
    cudaErrorMisalignedAddress."""
    t = STREAM_TYPES[name]
    (idx, vals), = hot_jobs(np.random.default_rng(23), (3_000,), 200, 64, name)
    size = vals.element_size()
    idx = idx.to(cuda_device)
    for shift in (1, 8 // size):
        big = torch.zeros((vals.numel() + shift,), dtype=vals.dtype)
        big[shift:] = vals.reshape(-1)
        big = big.to(cuda_device)
        _twin_checked([(idx, big[shift:].view(vals.shape))], 200, name)
    if size > 1:
        out = torch.empty((200, 64), device=cuda_device)
        arr, num = next(cuda.job_chunks(64, [(idx.data_ptr(), big.data_ptr() + 1, 3_000, 0, 0)]))
        with pytest.raises(RuntimeError, match="misaligned"):
            cuda.launch("scatter_add_rows" + t.suffix, "tetranerf_scatter_add_rows_batch",
                        cuda_device, arr, num, out.data_ptr(), 200, 64, 1, t.code)


def _codes_by_kind(name):
    """The codes of the row type ``name`` (f32: a few values) by what they
    widen to: ``zero`` (+0 and -0), ``nan``, ``inf``, ``finite`` (nonzero,
    at most 4 in magnitude)."""
    if name == "float32":
        codes = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), float("inf"),
                              -float("inf"), 0.5, -1.25, 3.0, 2.0 ** -10])
    else:
        codes = all_codes(name)
    value = widen(codes, name)
    return {"zero": codes[value == 0], "nan": codes[value.isnan()],
            "inf": codes[value.isinf()],
            "finite": codes[value.isfinite() & (value != 0) & (value.abs() <= 4)]}


def _code_rows(rng, pools, probs, shape):
    """Rows of codes drawn from the ``pools`` (of one dtype) with ``probs``."""
    kinds = rng.choice(len(pools), size=shape, p=probs)
    out = torch.empty(shape, dtype=pools[0].dtype)
    for k, pool in enumerate(pools):
        where = torch.from_numpy(kinds == k)
        pick = torch.from_numpy(rng.integers(0, len(pool), int(where.sum())))
        out[where] = pool[pick]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_adds_nothing_of_zero_codes(cuda_device, name):
    """Rows of code 0 only, then rows of every code that encodes +-0 (both
    signs, float4_e2m1fn's high nibble set too), on a hot id and elsewhere:
    the table stays +0, bit for bit, in one launch. float8_e8m0fnu has no
    zero: its code 0 is 2^-127, added as the twin adds it."""
    rng = np.random.default_rng(27)
    zero = _codes_by_kind(name)["zero"]
    ids = torch.from_numpy(rng.integers(-1, 300, 12_000).astype(np.int32))
    ids[rng.random(12_000) < 0.5] = 0
    for pool in ((zero[:1] if name != "float8_e8m0fnu" else all_codes(name)[:1]), zero):
        if not len(pool):
            continue
        rows = _code_rows(rng, [pool], [1.0], (12_000, 64))
        jobs = [(ids.to(cuda_device), rows.to(cuda_device))]
        out, twin = _twin_checked(jobs, 300, name)
        assert torch.equal(out.view(torch.int32), twin.view(torch.int32))
        if name != "float8_e8m0fnu":
            assert not bool(out.view(torch.int32).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_nan_and_inf_codes_beside_zeros(cuda_device, name):
    """16-byte lanes whose codes mix +-0 with NaN, infinity and finite codes
    (each where the type has them): NaN where the twin's, infinities where
    the twin's, the rest to rounding."""
    rng = np.random.default_rng(28)
    kinds = _codes_by_kind(name)
    pools, probs = [], []
    for kind, p in (("zero", 0.7), ("nan", 0.01), ("inf", 0.01), ("finite", 0.28)):
        if len(kinds[kind]):
            pools.append(kinds[kind])
            probs.append(p)
    probs = np.array(probs) / sum(probs)
    ids = torch.from_numpy(rng.integers(0, 2_000, 20_000).astype(np.int32))
    ids[rng.random(20_000) < 0.3] = 0
    rows = _code_rows(rng, pools, probs, (20_000, 64))
    out, twin = _twin_checked([(ids.to(cuda_device), rows.to(cuda_device))], 2_000, name)
    assert torch.equal(out.isinf(), twin.isinf())
    assert torch.equal(out[out.isinf()], twin[twin.isinf()])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_TYPES))
def test_scatter_kernel_skips_stream_padding(cuda_device, name):
    """Stream jobs with ``num_valid`` (F = 64 and 32, 70 jobs: two
    launches): garbage in the padding rows, which the kernel must not read,
    the padding ids in runs; the twin's table (``used_rows``: nothing for a
    type with a zero, NaN on every padding id for float8_e8m0fnu)."""
    rng = np.random.default_rng(29)
    for feat, count in ((64, 3), (32, 70)):
        jobs = [stream_job(rng, 60, 37, 400, feat, name)[0] for _ in range(count)]
        _twin_checked([tuple(x.to(cuda_device) for x in job) for job in jobs], 400, name,
                      launches=1 if count <= 64 else 2)


@pytest.mark.cuda
def test_scatter_zero_codes_are_the_stream_types_table(cuda_device):
    """The kernels' zero-code table (``common.cuh`` ``ZeroCode``) is
    ``StreamType.zero_mask`` for every row type (-1: no zero)."""
    fn = cuda.entry("tetranerf_row_zero_mask")
    for t in STREAM_TYPES.values():
        assert fn(t.code) == (-1 if t.zero_mask is None else t.zero_mask), t.name
    assert fn(99) == -2


@pytest.mark.cuda
def test_gather_rows_backward_is_the_scatter_of_clamped_ids(cuda_device):
    """``gather_rows``' backward (ids clamped at 0, as JAX's ``gather_rows``
    does) on the card: one K7 launch, the twin of the clamped ids."""
    rng = np.random.default_rng(24)
    ids = torch.from_numpy(rng.integers(-3, 300, (64, 40)).astype(np.int32)).to(cuda_device)
    table = torch.randn((300, 64), device=cuda_device, requires_grad=True)
    g = torch.randn((64, 40, 64), device=cuda_device)
    before = cuda.launch_counts["scatter_add_rows"]
    gather_rows(table, ids).backward(g)
    torch.cuda.synchronize()
    assert cuda.launch_counts["scatter_add_rows"] == before + 1
    want = scatter_add_rows_batch_twin([(ids.clamp_min(0).reshape(-1), g.reshape(-1, 64))], 300)
    torch.testing.assert_close(table.grad, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_flagship_step_launches_k2_once_k2b_per_bucket_k7_once(cuda_device):
    """The preset's 8 buckets (narrowed widths, tuned inner bounds below the
    march bound): one train forward and backward launches K2 once, K2b once
    per bucket and K7 once, and its field gradient is the CPU twins'."""
    from tetranerf_torch.models import TetraNerf, tetranerf_preset

    points, colors = make_sphere_scene(800, seed=0)
    cfg = tetranerf_preset(field_dim=16, hidden_size=32, num_samples=16,
                           num_fine_samples=16, max_intersected_triangles=64,
                           use_occupancy_field=False, compute_dtype="float32")
    mesh = build_mesh(points, device="cpu")
    origins, directions = sample_sphere_rays(np.random.default_rng(17), 256)
    steps = (8, 16, 24, 32, 40, 48, 56)
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    plan = model.bucket_plan(256, model.bucket_bounds(64, None, steps))
    assert len(plan) == 8
    rng = np.random.default_rng(18)
    uniforms = [{"coarse": rng.random((hi - lo, ns + 1), np.float32),
                 "fine": rng.random((hi - lo, nf + 1), np.float32),
                 "background": rng.random((hi - lo, 3), np.float32)}
                for _, lo, hi, _, ns, nf in plan]
    grads = []
    for dev in ("cpu", cuda_device):
        model = model.to(dev)
        model.zero_grad(set_to_none=True)
        before = dict(cuda.launch_counts)
        out = model.get_outputs(torch.from_numpy(origins).to(dev),
                                torch.from_numpy(directions).to(dev), mesh.to(dev),
                                train=True, uniforms=uniforms, bucket_steps=steps)
        out["rgb"].square().mean().backward()
        grads.append(model.tetrahedra_field.grad.to("cpu", copy=True))
    torch.cuda.synchronize()
    launched = {k: cuda.launch_counts[k] - before[k] for k in before}
    assert launched["stream_blend_gather"] == 1, launched
    assert launched["stream_blend_backward"] == 8, launched
    assert launched["scatter_add_rows"] == 1, launched
    assert launched["row_gather"] == 1, launched
    # K7's atomics add in a run-dependent order, K2/K2b/K3 in another order
    # than the twins: the chip smoke's field-gradient tolerance.
    scale = float(grads[0].abs().max())
    assert scale > 0 and float((grads[1] - grads[0]).abs().max()) <= 5e-2 * scale


@pytest.mark.cuda
def test_autograd_functions_launch_the_backward_kernels(scene, cuda_device):
    s = scene["res"].stream
    dev_stream = [x.to(cuda_device) for x in (s.vids, s.pos, s.bary)]
    field = torch.from_numpy(scene["field"]).to(cuda_device).requires_grad_()
    g = torch.from_numpy(scene["g_end"]).to(cuda_device)
    before = dict(cuda.launch_counts)
    StreamBlendGather.apply(field, *dev_stream).backward(g)
    torch.cuda.synchronize()
    for name in ("stream_blend_gather", "stream_blend_backward", "scatter_add_rows"):
        assert cuda.launch_counts[name] == before[name] + 1, name
    cpu = torch.from_numpy(scene["field"]).requires_grad_()
    StreamBlendGather.apply(cpu, s.vids, s.pos, s.bary).backward(g.cpu())
    torch.testing.assert_close(field.grad.cpu(), cpu.grad, atol=1e-4, rtol=0)


def _bucket_intervals(num_rays, max_t, num_samples, order, seed):
    """Intervals of a flagship bucket's shape without a march: per ray a
    sorted run of ``num_valid`` intervals (0 to ``max_t``) from its entry
    point, ``+inf`` past it, one ray in ten masked, and ``num_samples``
    distances over the run plus a margin before and after it."""
    rng = np.random.default_rng(seed)
    num_valid = rng.integers(0, max_t + 1, num_rays).astype(np.int32)
    t_entry = rng.uniform(0.0, 1.0, num_rays).astype(np.float32)
    lengths = rng.exponential(0.01, (num_rays, max_t)).astype(np.float32)
    t1 = t_entry[:, None] + np.cumsum(lengths, axis=1, dtype=np.float32)
    t1[np.arange(max_t)[None, :] >= num_valid[:, None]] = np.inf
    t0 = np.concatenate([t_entry[:, None], t1[:, :-1]], axis=1)
    far = np.where(num_valid > 0, t1[np.arange(num_rays), np.maximum(num_valid - 1, 0)],
                   t_entry + 0.1)
    u = np.linspace(-0.02, 1.02, num_samples, dtype=np.float32)
    distances = t_entry[:, None] + u[None] * (far - t_entry)[:, None]
    if order == "shuffled":
        distances = distances[:, rng.permutation(num_samples)]
    ray_mask = rng.random(num_rays) > 0.1
    g = rng.standard_normal((num_rays, num_samples, 64)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                 (t0, t1, num_valid, ray_mask, distances.astype(np.float32), g))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("num_samples", [33, 257])
def test_interp_backward_kernel_matches_twin_at_a_bucket_shape(cuda_device, num_samples,
                                                               order):
    """A flagship bucket: 512 rays, T=232, the budgets' floor (S=33) and
    the full budget (S=257); within the chip smoke's tolerance."""
    args = tuple(x.to(cuda_device) for x in
                 _bucket_intervals(512, 232, num_samples, order, num_samples))
    before = cuda.launch_counts["sample_interp_backward"]
    out = sample_interp_backward(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts["sample_interp_backward"] == before + 1
    assert out.shape == (512, 233, 64)
    torch.testing.assert_close(out, sample_interp_backward_twin(*args), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_interp_backward_kernel_is_deterministic(cuda_device, order):
    """No atomics: two launches on the same inputs give the same bits."""
    args = tuple(x.to(cuda_device) for x in _bucket_intervals(512, 232, 257, order, 5))
    first = sample_interp_backward(*args)
    second = sample_interp_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _bucket_stream(num_rays, max_t, feat, seed):
    """A stream of a flagship bucket's shape without a march: endpoint 0
    names slots 0-3, and each later endpoint replaces one of its
    predecessor's four slots with the new slot ``e + 3``, as the march's
    dedup does; endpoints past a ray's ``num_valid`` carry zero weights and
    position 0; one weight in ten of the others is zero."""
    rng = np.random.default_rng(seed)
    num_end = max_t + 1
    cur = np.tile(np.arange(4, dtype=np.int32), (num_rays, 1))
    pos = np.empty((num_rays, num_end, 4), np.int32)
    pos[:, 0] = cur
    for e in range(1, num_end):
        cur[np.arange(num_rays), rng.integers(0, 4, num_rays)] = e + 3
        pos[:, e] = cur
    bary = rng.uniform(0.05, 1.0, (num_rays, num_end, 4)).astype(np.float32)
    bary[rng.random(bary.shape) < 0.1] = 0.0
    num_valid = rng.integers(0, max_t + 1, num_rays)
    pad = np.arange(num_end)[None, :] > num_valid[:, None]
    bary[pad], pos[pad] = 0.0, 0
    g = rng.standard_normal((num_rays, num_end, feat)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (g, pos, bary))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 64])
def test_blend_backward_kernel_matches_twin_at_a_bucket_shape(cuda_device, feat):
    """A flagship bucket: 512 rays, T=232 (E=233 endpoints, U=236 stream
    slots), two slot tiles per ray; within the chip smoke's tolerance."""
    g, pos, bary = (x.to(cuda_device) for x in _bucket_stream(512, 232, feat, feat))
    before = cuda.launch_counts["stream_blend_backward"]
    out = stream_blend_backward(g, pos, bary, 236)
    torch.cuda.synchronize()
    assert cuda.launch_counts["stream_blend_backward"] == before + 1
    assert out.shape == (512, 236, feat)
    torch.testing.assert_close(out, stream_blend_backward_twin(g, pos, bary, 236),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_blend_backward_kernel_is_deterministic(cuda_device):
    """No atomics: two launches on the same inputs give the same bits."""
    args = tuple(x.to(cuda_device) for x in _bucket_stream(512, 232, 64, 5))
    first = stream_blend_backward(*args, 236)
    second = stream_blend_backward(*args, 236)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_blend_backward_kernel_adds_repeats_and_skips_zero_weights(cuda_device):
    """Hand-made endpoints: one names a slot twice, zero weights point
    outside the stream, and the g rows of padding endpoints (all four
    weights zero) are NaN. Each repeat adds, nothing NaN is read, and every
    slot nothing names comes out zero."""
    num_end, num_stream, feat = 6, 9, 64
    pos = np.zeros((2, num_end, 4), np.int32)
    bary = np.zeros((2, num_end, 4), np.float32)
    pos[0, :3] = [[0, 1, 2, 3], [4, 4, 2, 3], [4, 5, 2, -7]]
    bary[0, :3] = [[0.5, 0.25, 0.125, 0.125], [0.25, 0.5, 0.125, 0.125],
                   [0.75, 0.25, 1.0, 0.0]]
    pos[0, 3:] = 999  # padding with garbage positions
    pos[1, :2] = [[8, 7, 6, 5], [8, 8, 8, 8]]
    bary[1, :2] = [[1.0, 0.5, 0.25, 0.0], [0.25, 0.25, 0.25, 0.25]]
    g = np.random.default_rng(4).standard_normal((2, num_end, feat)).astype(np.float32)
    padding = (bary == 0).all(axis=-1)
    g[padding] = np.nan
    expected = np.zeros((2, num_stream, feat))
    for r, e, j in zip(*np.nonzero(bary)):
        expected[r, pos[r, e, j]] += float(bary[r, e, j]) * g[r, e].astype(np.float64)
    out = stream_blend_backward(*(torch.from_numpy(x).to(cuda_device) for x in (g, pos, bary)),
                                num_stream)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert not expected[0, 6:].any() and not expected[1, :5].any()
    np.testing.assert_allclose(out.cpu().numpy(), expected, atol=1e-5, rtol=0)
