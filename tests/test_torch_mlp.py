"""The fused MLP twins (``tetranerf_torch/ops/mlp.py``) against the JAX
package's fused Pallas kernels (``tetranerf_tpu/ops/pallas_mlp.py``) in
interpret mode, as ``tests/test_pallas_mlp.py`` runs them; the model's fused
path against the JAX model's; and, on a GPU, the kernels K4/K4b/K5/K5b
against the twins.

JAX is imported inside tests only, so the CUDA cases also run where JAX is
absent: ``python -m pytest --noconftest -m cuda tests/test_torch_mlp.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tetranerf_torch.models import TetraNerf, check_supported, tetranerf_preset
from tetranerf_torch.ops import cuda
from tetranerf_torch.ops.mlp import (
    MAX_SMEM_BYTES,
    FusedDensityMLP,
    FusedFieldMLPs,
    fused_density_mlp,
    fused_density_mlp_backward,
    fused_density_mlp_backward_twin,
    fused_density_mlp_twin,
    fused_field_mlps,
    fused_field_mlps_backward,
    fused_field_mlps_backward_twin,
    fused_field_mlps_twin,
    launch_plan,
)
from tetranerf_torch.training.checkpoints import params_from_jax

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Twin vs the JAX kernel. At float32 both sum exact f32 products in another
# order: outputs within 1e-5, each gradient within 1e-4 of its largest
# entry. At bfloat16 both round the same operands and cotangents at the
# same places (measured here: within 6.4e-7 of each gradient's largest
# entry), but an f32 sum that differs in its last bit can round one bf16
# activation or cotangent one bf16 ulp (2^-8 relative) the other way, and
# that moves the rows downstream of it: outputs within 1e-3 and gradients
# within 5e-3 of their largest entry (tests/test_pallas_mlp.py allows 2e-2
# on outputs and 5% on gradient norms).
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-3)}
# (d_in, hidden, n_base, n_head, rays, samples)
VARIANTS = {
    "default": (16, 32, 3, 1, 8, 16),
    "deep-head": (16, 32, 3, 2, 8, 16),
    "shallow-base": (16, 32, 1, 1, 8, 16),
    "odd-shape": (16, 32, 3, 1, 7, 5),
}


def _jax_weights(rng, d_in, hidden, n_base, n_head):
    """Flat weights in the JAX layout (``[in, out]`` kernels), drawn like a
    torch Linear: ``U(-1/sqrt(in), 1/sqrt(in))``."""
    def layer(i, o, bias=True):
        bound = 1.0 / np.sqrt(i)
        w = [rng.uniform(-bound, bound, (i, o)).astype(np.float32)]
        return w + ([rng.uniform(-bound, bound, o).astype(np.float32)] if bias else [])

    ws = []
    for i in range(n_base):
        ws += layer(d_in if i == 0 else hidden, hidden)
    ws += layer(hidden, 1)
    if n_head:
        ws += layer(hidden, hidden, bias=False)
        for _ in range(n_head - 1):
            ws += layer(hidden, hidden)
        ws += layer(hidden, 3)
    return ws


def _port(w):
    """A JAX-layout weight as the port's ``[out, in]`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w))


def _inputs(variant, seed=0):
    d_in, hidden, n_base, n_head, rays, samples = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    return dict(
        n_base=n_base, n_head=n_head,
        x=rng.normal(size=(rays, samples, d_in)).astype(np.float32),
        hd=rng.normal(scale=0.5, size=(rays, hidden)).astype(np.float32),
        weights=_jax_weights(rng, d_in, hidden, n_base, n_head),
        g_rgb=rng.normal(size=(rays, samples, 3)).astype(np.float32),
        g_dens=rng.normal(size=(rays, samples, 1)).astype(np.float32),
    )


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


def _check_grads(ours, refs, tol, num_inputs):
    """Gradients of ``num_inputs`` inputs, then of the weights (the port's
    ``[out, in]`` matrices against JAX's ``[in, out]``)."""
    assert len(ours) == len(refs)
    for i, (a, r) in enumerate(zip(ours, refs)):
        a = a.detach().numpy()
        if i >= num_inputs and a.ndim == 2:
            a = a.T
        assert a.shape == r.shape, i
        assert _rel_err(a, r) <= tol, (i, _rel_err(a, r))


# ------------------------------------------------- the twins vs JAX kernels


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_field_mlps_twin_matches_jax_kernel(variant, compute_dtype):
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_mlp import fused_field_mlps as jax_fused

    inp = _inputs(variant)
    n_base, n_head = inp["n_base"], inp["n_head"]
    static = (n_base, n_head, compute_dtype, True)
    (rgb_ref, dens_ref), vjp = jax.vjp(
        lambda x, hd, *w: jax_fused(static, x, hd, *w),
        jnp.asarray(inp["x"]), jnp.asarray(inp["hd"]),
        *map(jnp.asarray, inp["weights"]),
    )
    grads_ref = [np.asarray(g) for g in
                 vjp((jnp.asarray(inp["g_rgb"]), jnp.asarray(inp["g_dens"])))]

    x = torch.from_numpy(inp["x"]).requires_grad_()
    hd = torch.from_numpy(inp["hd"]).requires_grad_()
    weights = [_port(w).requires_grad_() for w in inp["weights"]]
    rgb, dens = FusedFieldMLPs.apply(x, hd, n_base, n_head,
                                     DTYPES[compute_dtype], *weights)
    grads = torch.autograd.grad(
        (rgb, dens), [x, hd, *weights],
        (torch.from_numpy(inp["g_rgb"]), torch.from_numpy(inp["g_dens"])),
    )
    out_tol, grad_tol = TOL[compute_dtype]
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_ref),
                               atol=out_tol, rtol=0)
    np.testing.assert_allclose(dens.detach().numpy(), np.asarray(dens_ref),
                               atol=out_tol, rtol=out_tol)
    _check_grads(grads, grads_ref, grad_tol, 2)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_density_mlp_twin_matches_jax_kernel(compute_dtype):
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_mlp import fused_density_mlp as jax_dens

    inp = _inputs("default", seed=1)
    n_base = inp["n_base"]
    weights_np = inp["weights"][: 2 * n_base + 2]
    static = (n_base, compute_dtype, True)
    dens_ref, vjp = jax.vjp(lambda x, *w: jax_dens(static, x, *w),
                            jnp.asarray(inp["x"]), *map(jnp.asarray, weights_np))
    grads_ref = [np.asarray(g) for g in vjp(jnp.asarray(inp["g_dens"]))]

    x = torch.from_numpy(inp["x"]).requires_grad_()
    weights = [_port(w).requires_grad_() for w in weights_np]
    dens = FusedDensityMLP.apply(x, n_base, DTYPES[compute_dtype], *weights)
    grads = torch.autograd.grad(dens, [x, *weights], torch.from_numpy(inp["g_dens"]))
    out_tol, grad_tol = TOL[compute_dtype]
    np.testing.assert_allclose(dens.detach().numpy(), np.asarray(dens_ref),
                               atol=out_tol, rtol=out_tol)
    _check_grads(grads, grads_ref, grad_tol, 1)


def test_density_twin_is_the_field_twins_density():
    """The head-free chain's outputs and gradients equal the full chain's
    density and its gradients (at float32, exactly the same arithmetic)."""
    inp = _inputs("default", seed=2)
    n_base = inp["n_base"]
    x = torch.from_numpy(inp["x"])
    hd = torch.from_numpy(inp["hd"])
    weights = [_port(w) for w in inp["weights"]]
    g_dens = torch.from_numpy(inp["g_dens"])
    _, dens_full = fused_field_mlps_twin(x, hd, weights, n_base, 1, torch.float32)
    dens = fused_density_mlp_twin(x, weights[: 2 * n_base + 2], n_base, torch.float32)
    assert torch.equal(dens, dens_full)
    dx_full, _, g_full = fused_field_mlps_backward_twin(
        x, hd, weights, torch.zeros(x.shape[:2] + (3,)), g_dens, n_base, 1,
        torch.float32)
    dx, g = fused_density_mlp_backward_twin(x, weights[: 2 * n_base + 2], g_dens,
                                            n_base, torch.float32)
    torch.testing.assert_close(dx, dx_full, atol=1e-6, rtol=0)
    for a, b in zip(g, g_full):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_wrappers_run_the_twins_on_cpu():
    inp = _inputs("odd-shape", seed=3)
    n_base = inp["n_base"]
    before = dict(cuda.launch_counts)
    x, hd = torch.from_numpy(inp["x"]), torch.from_numpy(inp["hd"])
    weights = [_port(w) for w in inp["weights"]]
    g_rgb, g_dens = torch.from_numpy(inp["g_rgb"]), torch.from_numpy(inp["g_dens"])
    dt = torch.bfloat16
    for a, b in zip(fused_field_mlps(x, hd, weights, n_base, 1, dt),
                    fused_field_mlps_twin(x, hd, weights, n_base, 1, dt)):
        assert torch.equal(a, b)
    dx, dhd, g = fused_field_mlps_backward(x, hd, weights, g_rgb, g_dens, n_base, 1, dt)
    dx_t, dhd_t, g_t = fused_field_mlps_backward_twin(x, hd, weights, g_rgb, g_dens,
                                                      n_base, 1, dt)
    assert torch.equal(dx, dx_t) and torch.equal(dhd, dhd_t)
    assert all(torch.equal(a, b) for a, b in zip(g, g_t))
    wd = weights[: 2 * n_base + 2]
    assert torch.equal(fused_density_mlp(x, wd, n_base, dt),
                       fused_density_mlp_twin(x, wd, n_base, dt))
    dx, g = fused_density_mlp_backward(x, wd, g_dens, n_base, dt)
    dx_t, g_t = fused_density_mlp_backward_twin(x, wd, g_dens, n_base, dt)
    assert torch.equal(dx, dx_t) and all(torch.equal(a, b) for a, b in zip(g, g_t))
    assert cuda.launch_counts == before


# --------------------------------------------- the model's fused MLP stack


def _jax_shell(config):
    """The JAX TetraNerf with the mesh-dependent parts left out: only the
    MLP stack runs (as in tests/test_pallas_mlp.py)."""
    from tetranerf_tpu.models import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.ops.encoding import nerf_encoding_dim

    class Shell(JaxTetraNerf):
        def __init__(self, cfg):
            self.config = cfg
            self.num_train_images = 4
            self._mlp_in_dim = nerf_encoding_dim(cfg.field_dim,
                                                 cfg.input_fourier_frequencies)
            self._dir_enc_dim = nerf_encoding_dim(3, 4)
            self._head_in_dim = (cfg.hidden_size + self._dir_enc_dim
                                 + cfg.appearance_embed_dim)

    return Shell(config)


def _model_params(rng, cfg, head_in):
    jw = _jax_weights(rng, cfg.field_dim, cfg.hidden_size, cfg.num_density_layers, 0)
    bound = 1.0 / np.sqrt(head_in)
    params = {
        "tetrahedra_field": np.zeros((1, cfg.field_dim), np.float32),
        "mlp_base": [{"kernel": jw[2 * i], "bias": jw[2 * i + 1]}
                     for i in range(cfg.num_density_layers)],
        "field_output_density": {"kernel": jw[-2], "bias": jw[-1]},
        "mlp_head": [],
    }
    for i in range(cfg.num_color_layers):
        fan = head_in if i == 0 else cfg.hidden_size
        b = 1.0 / np.sqrt(fan)
        params["mlp_head"].append({
            "kernel": rng.uniform(-b, b, (fan, cfg.hidden_size)).astype(np.float32),
            "bias": rng.uniform(-b, b, cfg.hidden_size).astype(np.float32)})
    params["field_output_color"] = {
        "kernel": rng.uniform(-bound, bound, (cfg.hidden_size, 3)).astype(np.float32),
        "bias": rng.uniform(-bound, bound, 3).astype(np.float32)}
    if cfg.appearance_embed_dim:
        params["appearance_embedding"] = rng.normal(
            size=(4, cfg.appearance_embed_dim)).astype(np.float32)
    return params


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("appearance", [0, 8], ids=["plain", "appearance"])
def test_model_fused_field_mlps_match_jax(compute_dtype, appearance):
    """``TetraNerf.field_mlps`` with ``fused_mlps`` (head_dir from the
    direction and appearance columns, per-ray rows in train) against the
    JAX model's ``_field_mlps_remat`` with ``fused_mlps``: outputs and the
    gradient of every parameter and of the features."""
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.models.config import TetrahedraNerfConfig as JaxConfig

    kw = dict(field_dim=16, hidden_size=32, appearance_embed_dim=appearance,
              compute_dtype=compute_dtype, fused_mlps=True)
    jmodel = _jax_shell(JaxConfig(num_tetrahedra_vertices=1, num_tetrahedra_cells=1, **kw))
    rng = np.random.default_rng(5)
    params = _model_params(rng, jmodel.config, jmodel._head_in_dim)
    x = rng.normal(size=(6, 9, 16)).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cams = np.array([0, 2, 1, 3, 0, 2], np.int32)

    def jloss(p, xv):
        rgb, dens = jmodel._field_mlps_remat(p, xv, d, cams, True)
        return jnp.sum(jnp.sin(rgb)) + 0.01 * jnp.sum(jnp.tanh(dens)), (rgb, dens)

    (_, (rgb_ref, dens_ref)), (g_ref, gx_ref) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    model = TetraNerf(tetranerf_preset(ray_buckets=1, **kw), 1, num_train_images=4,
                      device="cpu")
    params_from_jax(model, params)
    xt = torch.from_numpy(x).requires_grad_()
    rgb, dens = model.field_mlps(xt, torch.from_numpy(d), torch.from_numpy(cams))
    loss = torch.sum(torch.sin(rgb)) + 0.01 * torch.sum(torch.tanh(dens))
    loss.backward()
    out_tol, grad_tol = TOL[compute_dtype]
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_ref), atol=out_tol, rtol=0)
    np.testing.assert_allclose(dens.detach().numpy(), np.asarray(dens_ref),
                               atol=out_tol, rtol=out_tol)
    assert _rel_err(xt.grad.numpy(), gx_ref) <= grad_tol
    ours = {"mlp_base": [(l.weight, l.bias) for l in model.mlp_base.layers],
            "mlp_head": [(l.weight, l.bias) for l in model.mlp_head.layers],
            "field_output_color": [(model.field_output_color.weight,
                                    model.field_output_color.bias)],
            "field_output_density": [(model.field_output_density.weight,
                                      model.field_output_density.bias)]}
    for name, layers in ours.items():
        refs = g_ref[name] if isinstance(g_ref[name], list) else [g_ref[name]]
        for (w, b), r in zip(layers, refs):
            assert _rel_err(w.grad.numpy().T, r["kernel"]) <= grad_tol, name
            assert _rel_err(b.grad.numpy(), r["bias"]) <= grad_tol, name
    if appearance:
        assert _rel_err(model.appearance_embedding.grad.numpy(),
                        g_ref["appearance_embedding"]) <= grad_tol


def test_fused_mlps_with_fourier_input_runs_the_plain_path():
    """Like the JAX model, ``fused_mlps`` takes the fused path only without
    a Fourier input encoding: with one, the outputs are the plain path's."""
    kw = dict(ray_buckets=1, field_dim=16, hidden_size=32, input_fourier_frequencies=2)
    cfg = tetranerf_preset(fused_mlps=True, **kw)
    check_supported(cfg)
    fused = TetraNerf(cfg, 1, generator=torch.Generator().manual_seed(0), device="cpu")
    plain = TetraNerf(tetranerf_preset(**kw), 1,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(4, 5, 16)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(4, 3)).astype(np.float32)), dim=1)
    with torch.no_grad():
        for a, b in zip(fused.field_mlps(x, d), plain.field_mlps(x, d)):
            assert torch.equal(a, b)
        assert torch.equal(fused.density_mlp(x), plain.density_mlp(x))
        # And the fused path would differ: its biases are added unrounded.
        no_fourier = dataclasses.replace(cfg, input_fourier_frequencies=0)
        m = TetraNerf(no_fourier, 1, generator=torch.Generator().manual_seed(0),
                      device="cpu")
        m_plain = TetraNerf(dataclasses.replace(no_fourier, fused_mlps=False), 1,
                            generator=torch.Generator().manual_seed(0), device="cpu")
        x16 = x[..., :16]
        assert not torch.equal(m.field_mlps(x16, d)[0], m_plain.field_mlps(x16, d)[0])


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused MLP kernels run only on the card")
    return torch.device("cuda")


# Kernel vs twin on the card, both in bfloat16: sums in another order flip
# single bf16 roundings (as TOL["bfloat16"]) and can put a pre-activation
# within an ulp of 0 on the other side of a ReLU, which moves an entry of
# a cotangent by one whole term of its sum. Each output is held to 1e-2 in
# relative Frobenius norm and its max abs error to 0.1 of its largest entry
# (the tolerances of chip_smoke.py).
CUDA_NORM_RTOL, CUDA_MAX_RTOL = 1e-2, 0.1
# (d_in, hidden, n_base, n_head, rays, samples)
CUDA_CASES = {
    "narrow": (16, 32, 3, 1, 64, 33),
    "preset": (64, 128, 3, 1, 32, 257),
    "ragged": (16, 32, 3, 1, 7, 5),
    "deep-head": (16, 32, 2, 3, 16, 40),
    # The preset's widths with two head layers: the backward's x stages
    # share its cotangent staging (no room for a prefetch).
    "preset-head-2": (64, 128, 3, 2, 24, 65),
    # 1,591 rows: not a multiple of a 128-row tile pair, and 43 samples a
    # ray, so tiles and warps span ray boundaries.
    "preset-ragged": (64, 128, 3, 1, 37, 43),
}
# The preset's widths at two bucket shapes of the flagship's cold step
# (512 rays x 33 and x 193 fine samples).
BUCKET_SAMPLES = (33, 193)


def _cuda_inputs(case, dev, seed=0):
    d_in, hidden, n_base, n_head, rays, samples = (
        CUDA_CASES[case] if isinstance(case, str) else case)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (
        n_base, n_head,
        t(rng.normal(size=(rays, samples, d_in)).astype(np.float32)),
        t(rng.normal(scale=0.5, size=(rays, hidden)).astype(np.float32)),
        [t(w.T if w.ndim == 2 else w)
         for w in _jax_weights(rng, d_in, hidden, n_base, n_head)],
        t(rng.normal(size=(rays, samples, 3)).astype(np.float32)),
        t(rng.normal(size=(rays, samples, 1)).astype(np.float32)),
    )


def _close(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = b.abs().max().clamp_min(1e-30)
    return (float((a - b).norm() / b.norm().clamp_min(1e-30)) <= CUDA_NORM_RTOL
            and float((a - b).abs().max() / scale) <= CUDA_MAX_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_field_kernels_match_twin(cuda_device, case):
    n_base, n_head, x, hd, weights, g_rgb, g_dens = _cuda_inputs(case, cuda_device)
    dt = torch.bfloat16
    before = dict(cuda.launch_counts)
    rgb, dens = fused_field_mlps(x, hd, weights, n_base, n_head, dt)
    dx, dhd, grads = fused_field_mlps_backward(x, hd, weights, g_rgb, g_dens,
                                               n_base, n_head, dt)
    torch.cuda.synchronize()
    assert cuda.launch_counts["fused_field_mlps"] == before["fused_field_mlps"] + 1
    assert (cuda.launch_counts["fused_field_mlps_backward"]
            == before["fused_field_mlps_backward"] + 1)
    rgb_t, dens_t = fused_field_mlps_twin(x, hd, weights, n_base, n_head, dt)
    assert _close(rgb, rgb_t) and _close(dens, dens_t)
    dx_t, dhd_t, grads_t = fused_field_mlps_backward_twin(
        x, hd, weights, g_rgb, g_dens, n_base, n_head, dt)
    assert _close(dx, dx_t) and _close(dhd, dhd_t)
    for i, (a, b) in enumerate(zip(grads, grads_t)):
        assert a.shape == b.shape and _close(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow", "preset", "ragged"])
def test_density_kernels_match_twin(cuda_device, case):
    n_base, _, x, _, weights, _, g_dens = _cuda_inputs(case, cuda_device, seed=1)
    wd = weights[: 2 * n_base + 2]
    dt = torch.bfloat16
    dens = fused_density_mlp(x, wd, n_base, dt)
    dx, grads = fused_density_mlp_backward(x, wd, g_dens, n_base, dt)
    torch.cuda.synchronize()
    assert _close(dens, fused_density_mlp_twin(x, wd, n_base, dt))
    dx_t, grads_t = fused_density_mlp_backward_twin(x, wd, g_dens, n_base, dt)
    assert _close(dx, dx_t)
    for a, b in zip(grads, grads_t):
        assert _close(a, b)


@pytest.mark.cuda
def test_autograd_functions_launch_the_kernels(cuda_device):
    n_base, n_head, x, hd, weights, g_rgb, g_dens = _cuda_inputs("narrow", cuda_device)
    x.requires_grad_()
    for w in weights:
        w.requires_grad_()
    before = dict(cuda.launch_counts)
    rgb, dens = FusedFieldMLPs.apply(x, hd, n_base, n_head, torch.bfloat16, *weights)
    torch.autograd.backward((rgb, dens), (g_rgb, g_dens))
    d = FusedDensityMLP.apply(x, n_base, torch.bfloat16, *weights[: 2 * n_base + 2])
    d.backward(g_dens)
    torch.cuda.synchronize()
    for name in ("fused_field_mlps", "fused_field_mlps_backward",
                 "fused_density_mlp", "fused_density_mlp_backward"):
        assert cuda.launch_counts[name] == before[name] + 1, name
    assert torch.isfinite(x.grad).all()


@pytest.mark.cuda
def test_model_fused_appearance_on_card_matches_cpu(cuda_device):
    cfg = tetranerf_preset(ray_buckets=1, field_dim=16, hidden_size=32,
                           appearance_embed_dim=8, fused_mlps=True)
    model = TetraNerf(cfg, 1, num_train_images=4,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(6, 9, 16)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(6, 3)).astype(np.float32)), dim=1)
    cams = torch.tensor([0, 2, 1, 3, 0, 2])
    outs = {}
    for dev in ("cpu", cuda_device):
        model = model.to(dev)
        model.zero_grad(set_to_none=True)
        rgb, dens = model.field_mlps(x.to(dev), d.to(dev), cams.to(dev))
        (rgb.square().sum() + dens.sum()).backward()
        outs[str(dev)] = (rgb, dens, model.appearance_embedding.grad,
                          model.mlp_head.layers[0].weight.grad)
    for a, b in zip(outs[str(cuda_device)], outs["cpu"]):
        assert _close(a, b)


@pytest.mark.cuda
def test_kernels_refuse_what_they_lack(cuda_device):
    n_base, n_head, x, hd, weights, _, _ = _cuda_inputs("narrow", cuda_device)
    with pytest.raises(NotImplementedError):
        fused_field_mlps(x, hd, weights, n_base, n_head, torch.float32)
    with pytest.raises(ValueError):  # d_in = 8, not a multiple of 16
        fused_field_mlps(x[..., :8].contiguous(), hd,
                         [weights[0][:, :8].contiguous()] + weights[1:],
                         n_base, n_head, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("samples", BUCKET_SAMPLES)
def test_kernels_match_twin_at_a_bucket_shape(cuda_device, samples):
    n_base, n_head, x, hd, weights, g_rgb, g_dens = _cuda_inputs(
        (64, 128, 3, 1, 512, samples), cuda_device, seed=2)
    dt = torch.bfloat16
    rgb, dens = fused_field_mlps(x, hd, weights, n_base, n_head, dt)
    dx, dhd, grads = fused_field_mlps_backward(x, hd, weights, g_rgb, g_dens,
                                               n_base, n_head, dt)
    rgb_t, dens_t = fused_field_mlps_twin(x, hd, weights, n_base, n_head, dt)
    assert _close(rgb, rgb_t) and _close(dens, dens_t)
    dx_t, dhd_t, grads_t = fused_field_mlps_backward_twin(
        x, hd, weights, g_rgb, g_dens, n_base, n_head, dt)
    assert _close(dx, dx_t) and _close(dhd, dhd_t)
    for i, (a, b) in enumerate(zip(grads, grads_t)):
        assert _close(a, b), i
    wd = weights[: 2 * n_base + 2]
    assert _close(fused_density_mlp(x, wd, n_base, dt),
                  fused_density_mlp_twin(x, wd, n_base, dt))
    dx, grads = fused_density_mlp_backward(x, wd, g_dens, n_base, dt)
    dx_t, grads_t = fused_density_mlp_backward_twin(x, wd, g_dens, n_base, dt)
    assert _close(dx, dx_t) and all(_close(a, b) for a, b in zip(grads, grads_t))


@pytest.mark.cuda
@pytest.mark.parametrize("head", [True, False], ids=["field", "density"])
def test_backward_weight_gradients_are_bit_equal_over_two_launches(cuda_device, head):
    """K4b and K5b sum the weight gradients per block, then over blocks in
    block order: the same bits in every launch (no float atomics)."""
    n_base, n_head, x, hd, weights, g_rgb, g_dens = _cuda_inputs("preset", cuda_device)
    dt = torch.bfloat16
    if head:
        def run():
            return fused_field_mlps_backward(x, hd, weights, g_rgb, g_dens,
                                             n_base, n_head, dt)[2]
    else:
        wd = weights[: 2 * n_base + 2]

        def run():
            return fused_density_mlp_backward(x, wd, g_dens, n_base, dt)[1]
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_kernels_refuse_an_oversized_stack(cuda_device):
    """Three base and three head layers at the preset's widths do not fit
    the backward's shared memory: ValueError before any launch."""
    n_base, n_head, x, hd, weights, g_rgb, g_dens = _cuda_inputs(
        (64, 128, 3, 3, 4, 16), cuda_device)
    before = dict(cuda.launch_counts)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_field_mlps_backward(x, hd, weights, g_rgb, g_dens, n_base, n_head,
                                  torch.bfloat16)
    assert cuda.launch_counts == before


# ------------------------------------------------------- the launch plan


PLAN_STACKS = {name: case[:4] for name, case in CUDA_CASES.items()}
PLAN_STACKS.update({"preset-density": (64, 128, 3, 0), "narrow-density": (16, 32, 3, 0),
                    "preset-head-3-forward": (64, 128, 3, 3)})


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("stack", list(PLAN_STACKS))
def test_launch_plan_takes_the_kernel_stacks(stack, backward):
    d_in, hidden, n_base, n_head = PLAN_STACKS[stack]
    if stack == "preset-head-3-forward" and backward:
        with pytest.raises(ValueError, match="bytes of shared memory"):
            launch_plan(d_in, hidden, n_base, n_head, backward)
        return
    plan = launch_plan(d_in, hidden, n_base, n_head, backward)
    assert plan.rows_per_tile == 64 and 0 < plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.warpgroups == 2 if backward else 1 <= plan.warpgroups <= 3
    rng = np.random.default_rng(0)
    weights = [_port(w) for w in _jax_weights(rng, d_in, hidden, n_base, n_head)]
    size = sum(w.numel() for w in weights)
    # The workspace row holds every gradient, rounded up to 8 floats.
    assert plan.ws_floats == (-(-size // 8) * 8 if backward else 0)


def test_launch_plan_stages_and_warpgroups_follow_shared_memory():
    """Where shared memory is short the plan gives up the backward's x
    prefetch, then the forward's third warpgroup, then refuses."""
    assert launch_plan(64, 128, 3, 1, True).stages == 1
    assert launch_plan(64, 128, 3, 2, True).stages == 0
    assert launch_plan(64, 128, 3, 2, False).warpgroups == 3
    assert launch_plan(64, 128, 3, 3, False).warpgroups == 2
    with pytest.raises(ValueError, match="bytes of shared memory"):
        launch_plan(64, 128, 3, 5, False)
    with pytest.raises(ValueError, match="not among the compiled"):
        launch_plan(32, 64, 3, 1, False)
    with pytest.raises(ValueError):
        launch_plan(16, 32, 0, 1, True)
