"""Stream blend (K2, one stream or a batch of them) and sample
interpolation (K3): the PyTorch twins against a float64 numpy oracle and the
JAX package, the kernels (on a GPU) against the twins.

JAX is imported inside fixtures only, so the CUDA cases also run where JAX
is absent: ``python -m pytest --noconftest -m cuda tests/test_torch_interp.py``.
"""

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import build_mesh
from tetranerf_torch.ops import cuda
from tetranerf_torch.ops.fused import endpoint_features, endpoint_features_batch, ray_bounds
from tetranerf_torch.ops.interp import (
    sample_interp,
    sample_interp_twin,
    stream_blend_gather,
    stream_blend_gather_batch,
    stream_blend_gather_batch_twin,
    stream_blend_gather_twin,
)
from tetranerf_torch.ops.march import march
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays

FIELD_DIM = 16
MAX_STEPS = 64
# The JAX Pallas kernels contract in bfloat16 (tests/test_pallas_interp.py:30).
BF16_ATOL = 2e-2


@pytest.fixture(scope="module")
def scene():
    points, _ = make_sphere_scene(800, seed=0)
    mesh = build_mesh(points, device="cpu")
    rng = np.random.default_rng(2)
    field = rng.uniform(-1, 1, (mesh.num_vertices, FIELD_DIM)).astype(np.float32)
    origins, directions = sample_sphere_rays(np.random.default_rng(1), 64)
    res = march(mesh, torch.from_numpy(origins), torch.from_numpy(directions),
                max_steps=MAX_STEPS)
    return dict(points=points, mesh=mesh, field=field, origins=origins,
                directions=directions, res=res)


def _blend_oracle(field, vids, pos, bary):
    """float64 numpy: ``out[r, e] = sum_j bary[r,e,j] field[vids[r, pos[r,e,j]]]``."""
    out = np.zeros(pos.shape[:2] + (field.shape[1],))
    for r in range(pos.shape[0]):
        for e in range(pos.shape[1]):
            for j in range(4):
                row = field[vids[r, pos[r, e, j]]].astype(np.float64)
                out[r, e] += float(bary[r, e, j]) * row
    return out


def test_blend_twin_matches_float64_oracle(scene):
    s = scene["res"].stream
    rows = slice(0, 8)  # the python-loop oracle is slow; 8 rays x 65 endpoints
    vids, pos, bary = s.vids[rows], s.pos[rows], s.bary[rows]
    field = scene["field"]
    out = stream_blend_gather_twin(torch.from_numpy(field), vids, pos, bary)
    ref = _blend_oracle(field, vids.numpy(), pos.numpy(), bary.numpy())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    assert np.abs(ref).max() > 0.1  # not a comparison of zeros


def test_blend_twin_matches_jax_stream_blend(scene):
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_interp import stream_blend

    s = scene["res"].stream
    field = scene["field"]
    out = stream_blend_gather(torch.from_numpy(field), s.vids, s.pos, s.bary)
    ref = stream_blend(
        jnp.asarray(field)[jnp.asarray(s.vids.numpy())],
        jnp.asarray(s.pos.numpy()), jnp.asarray(s.bary.numpy()),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BF16_ATOL, rtol=0)


def _three_streams(scene):
    """Streams of three different (R, T): rays of the scene marched at
    bounds 64, 40 and 16."""
    o, d = (torch.from_numpy(x) for x in (scene["origins"], scene["directions"]))
    return [march(scene["mesh"], o[lo:hi], d[lo:hi], max_steps=t).stream
            for lo, hi, t in ((0, 64, 64), (10, 50, 40), (41, 64, 16))]


def test_blend_batch_twin_matches_jax_stream_blend_per_job(scene):
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_interp import stream_blend

    streams = _three_streams(scene)
    field = scene["field"]
    outs = stream_blend_gather_batch_twin(
        torch.from_numpy(field), [(s.vids, s.pos, s.bary) for s in streams])
    assert len({out.shape for out in outs}) == 3
    for s, out in zip(streams, outs):
        ref = stream_blend(
            jnp.asarray(field)[jnp.maximum(jnp.asarray(s.vids.numpy()), 0)],
            jnp.asarray(s.pos.numpy()), jnp.asarray(s.bary.numpy()),
        )
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BF16_ATOL, rtol=0)


def test_one_stream_cases_are_the_single_blend(scene):
    """``stream_blend_gather``, ``endpoint_features`` (with and without
    autograd) and the batch of one stream give the twin's bits."""
    s = scene["res"].stream
    field = torch.from_numpy(scene["field"])
    twin = stream_blend_gather_twin(field, s.vids, s.pos, s.bary)
    assert torch.equal(stream_blend_gather(field, s.vids, s.pos, s.bary), twin)
    (batch,) = stream_blend_gather_batch(field, [(s.vids, s.pos, s.bary)])
    assert torch.equal(batch, twin)
    assert torch.equal(endpoint_features(field, s), twin)
    (feats,) = endpoint_features_batch(field.clone().requires_grad_(), [s])
    assert feats.grad_fn is not None and torch.equal(feats.detach(), twin)


@pytest.fixture(scope="module")
def jax_interp_inputs(scene):
    """A JAX march with endpoint features, and sample distances covering
    every interval plus a margin before and after each ray's range."""
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
    distances = nears[:, None] + u[None, :] * (fars - nears)[:, None]
    return jres, distances.astype(np.float32), ray_mask


def _twin_on(jres, distances, ray_mask):
    return sample_interp(
        *(torch.from_numpy(np.array(x)) for x in (
            jres.t0, jres.t1, jres.num_valid, ray_mask, distances, jres.feats
        ))
    )


def test_interp_twin_matches_jax_gather(jax_interp_inputs):
    from tetranerf_tpu.ops.fused import sample_features

    jres, distances, ray_mask = jax_interp_inputs
    out, mask = _twin_on(jres, distances, ray_mask)
    ref, ref_mask = sample_features(jres, distances, ray_mask, use_matmul=False)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    # Both lerp in f32 from the same endpoint features.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert 0.5 < mask.float().mean() < 1.0  # masked samples are exercised


def test_interp_twin_matches_jax_pallas(jax_interp_inputs):
    from tetranerf_tpu.ops.fused import sample_features

    jres, distances, ray_mask = jax_interp_inputs
    out, mask = _twin_on(jres, distances, ray_mask)
    ref, ref_mask = sample_features(jres, distances, ray_mask, use_matmul="pallas")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BF16_ATOL, rtol=0)


def test_wrappers_run_the_twins_on_cpu(scene):
    before = dict(cuda.launch_counts)
    res = scene["res"]
    s = res.stream
    field = torch.from_numpy(scene["field"])
    feats = stream_blend_gather(field, s.vids, s.pos, s.bary)
    assert torch.equal(feats, stream_blend_gather_twin(field, s.vids, s.pos, s.bary))
    nears, fars, _, _, ray_mask = ray_bounds(res)
    d = (nears[:, None] + torch.linspace(0, 1, 9)[None] * (fars - nears)[:, None])
    args = (res.t0, res.t1, res.num_valid, ray_mask, d.contiguous(), feats)
    for x, y in zip(sample_interp(*args), sample_interp_twin(*args)):
        assert torch.equal(x, y)
    assert cuda.launch_counts == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend and interp kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 64])
def test_blend_kernel_matches_twin(scene, cuda_device, feat):
    s = scene["res"].stream
    rng = np.random.default_rng(feat)
    field = torch.from_numpy(
        rng.uniform(-1, 1, (scene["mesh"].num_vertices, feat)).astype(np.float32)
    ).to(cuda_device)
    args = (field, *(x.to(cuda_device).contiguous() for x in (s.vids, s.pos, s.bary)))
    before = cuda.launch_counts["stream_blend_gather"]
    out = stream_blend_gather(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts["stream_blend_gather"] == before + 1
    torch.testing.assert_close(out, stream_blend_gather_twin(*args), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_interp_kernel_matches_twin(scene, cuda_device):
    res = scene["res"]
    s = res.stream
    field = torch.from_numpy(scene["field"])
    feats = stream_blend_gather_twin(field, s.vids, s.pos, s.bary)
    nears, fars, _, _, ray_mask = ray_bounds(res)
    u = torch.linspace(-0.05, 1.05, 41)
    d = nears[:, None] + u[None] * (fars - nears)[:, None]
    args = tuple(x.to(cuda_device).contiguous() for x in
                 (res.t0, res.t1, res.num_valid, ray_mask, d, feats))
    before = cuda.launch_counts["sample_interp"]
    out, mask = sample_interp(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts["sample_interp"] == before + 1
    ref, ref_mask = sample_interp_twin(*args)
    assert torch.equal(mask, ref_mask)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def _bucket_feats(num_rays, max_t, num_samples, order, seed):
    """K3's inputs at a flagship bucket's shape: the intervals and
    distances of ``tests/test_torch_backward.py`` and endpoint features
    ``f32[R, T+1, 64]``."""
    from test_torch_backward import _bucket_intervals

    *args, _ = _bucket_intervals(num_rays, max_t, num_samples, order, seed)
    feats = np.random.default_rng(seed + 1).standard_normal((num_rays, max_t + 1, 64))
    return (*args, torch.from_numpy(feats.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("num_samples", [33, 257])
def test_interp_kernel_matches_twin_at_a_bucket_shape(cuda_device, num_samples, order):
    """A flagship bucket: 512 rays, T=232, the budgets' floor (S=33, one
    sample tile per ray) and the full budget (S=257, three tiles); within
    the chip smoke's tolerance, the mask exactly."""
    args = tuple(x.to(cuda_device) for x in
                 _bucket_feats(512, 232, num_samples, order, num_samples))
    before = cuda.launch_counts["sample_interp"]
    out, mask = sample_interp(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts["sample_interp"] == before + 1
    assert out.shape == (512, num_samples, 64)
    ref, ref_mask = sample_interp_twin(*args)
    assert torch.equal(mask, ref_mask)
    assert 0.3 < mask.float().mean() < 1.0
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    again, again_mask = sample_interp(*args)
    assert torch.equal(out, again) and torch.equal(mask, again_mask)


def _bucket_blend_streams(feat, num_vertices, seed):
    """K2's streams at the three flagship bucket shapes of the cold step
    (512 rays at T=384, 272 and 232; ``tests/test_torch_backward.py``'s
    stream generator) with stream ids in ``[-1, V)``, and a field."""
    from test_torch_backward import _bucket_stream

    rng = np.random.default_rng(seed)
    streams = []
    for max_t in (384, 272, 232):
        _, pos, bary = _bucket_stream(512, max_t, 2, max_t)
        vids = rng.integers(-1, num_vertices, (512, max_t + 4)).astype(np.int32)
        streams.append((torch.from_numpy(vids), pos, bary))
    field = rng.uniform(-1, 1, (num_vertices, feat)).astype(np.float32)
    return torch.from_numpy(field), streams


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [64, 16, 6])
def test_blend_batch_kernel_matches_twin_at_the_bucket_shapes(cuda_device, feat):
    """The three bucket shapes in one launch, within the chip smoke's
    tolerance; F=6 takes the float2 path. Two launches are bit-equal (no
    atomics)."""
    field, streams = _bucket_blend_streams(feat, 5000, feat)
    field = field.to(cuda_device)
    streams = [tuple(x.to(cuda_device) for x in s) for s in streams]
    before = cuda.launch_counts["stream_blend_gather"]
    outs = stream_blend_gather_batch(field, streams)
    torch.cuda.synchronize()
    assert cuda.launch_counts["stream_blend_gather"] == before + 1
    for (vids, pos, _), out, ref in zip(streams, outs,
                                        stream_blend_gather_batch_twin(field, streams)):
        assert out.shape == pos.shape[:2] + (feat,)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    again = stream_blend_gather_batch(field, streams)
    assert all(torch.equal(x, y) for x, y in zip(outs, again))


@pytest.mark.cuda
def test_blend_batch_kernel_splits_a_long_job_list(scene, cuda_device):
    """More streams than one launch takes (64): two launches, each stream
    blended as the twin blends it."""
    s = scene["res"].stream
    field = torch.from_numpy(scene["field"]).to(cuda_device)
    streams = [tuple(x[i % 60:i % 60 + 4].to(cuda_device) for x in (s.vids, s.pos, s.bary))
               for i in range(70)]
    before = cuda.launch_counts["stream_blend_gather"]
    outs = stream_blend_gather_batch(field, streams)
    torch.cuda.synchronize()
    assert cuda.launch_counts["stream_blend_gather"] == before + 2
    for out, ref in zip(outs, stream_blend_gather_batch_twin(field, streams)):
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
