"""The backward kernels' twins (K2b stream-blend transpose, K3b sample-interp
transpose, K7 row scatter-add) against a float64 numpy oracle and the JAX
package's VJPs, the autograd Functions under ``gradcheck``, and the kernels
(on a GPU) against the twins.

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
    scatter_add_rows_twin,
)
from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays

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


@pytest.mark.cuda
def test_scatter_kernel_matches_twin(cuda_device):
    rng = np.random.default_rng(10)
    idx = torch.from_numpy(rng.integers(-2, 1100, 20000).astype(np.int32)).to(cuda_device)
    vals = torch.from_numpy(rng.standard_normal((20000, 64)).astype(np.float32))
    vals[::3] = 0.0  # zero rows issue no atomics
    vals = vals.to(cuda_device)
    before = cuda.launch_counts["scatter_add_rows"]
    out = scatter_add_rows(idx, vals, 1000)
    torch.cuda.synchronize()
    assert cuda.launch_counts["scatter_add_rows"] == before + 1
    # Float atomics add in a run-dependent order: equal to rounding only.
    torch.testing.assert_close(out, scatter_add_rows_twin(idx, vals, 1000),
                               atol=1e-4, rtol=0)


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
