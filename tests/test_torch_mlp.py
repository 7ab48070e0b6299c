"""The fused MLP twins (``tetranerf_torch/ops/mlp.py``) against the JAX
package's fused Pallas kernels (``tetranerf_tpu/ops/pallas_mlp.py``) in
interpret mode, as ``tests/test_pallas_mlp.py`` runs them; the model's fused
path against the JAX model's; and, on a GPU, the kernels K4/K4b/K5/K5b
against the twins.

JAX is imported inside tests only, so the CUDA cases also run where JAX is
absent: ``python -m pytest --noconftest -m cuda tests/test_torch_mlp.py``.
The card's cases cover the three routes of :func:`launch_plan`: ``wgmma``
(bf16 at widths (16, 32) and (64, 128)), ``generic`` (float32, other widths
up to 256 and depths up to 8) and ``layered`` (wider or deeper stacks).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tetranerf_torch.models import TetraNerf, check_supported, tetranerf_preset
from tetranerf_torch.ops import cuda, mlp
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
    _generic_plan,
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
    # Widths JAX's kernels take and the wgmma route does not: the card runs
    # them on the generic route.
    "wide-odd": (24, 40, 3, 1, 5, 7),
    "narrow-deep-head": (8, 24, 2, 2, 4, 9),
    # Wider than 256 and deeper than 8 layers: the layered route on the card.
    "wide": (24, 272, 2, 1, 3, 4),
    "deep": (16, 32, 6, 4, 3, 4),
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
    _density_twin_vs_jax("default", compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["wide-odd", "narrow-deep-head"])
def test_density_mlp_twin_matches_jax_kernel_at_other_widths(variant, compute_dtype):
    _density_twin_vs_jax(variant, compute_dtype)


def _density_twin_vs_jax(variant, compute_dtype):
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.ops.pallas_mlp import fused_density_mlp as jax_dens

    inp = _inputs(variant, seed=1)
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
    _model_fused_vs_jax(dict(field_dim=16, hidden_size=32, appearance_embed_dim=appearance,
                             compute_dtype=compute_dtype, fused_mlps=True))


@pytest.mark.parametrize("stack", [
    dict(hidden_size=272, appearance_embed_dim=8),
    dict(hidden_size=32, num_density_layers=6, num_color_layers=4),
], ids=["wide", "deep"])
def test_model_fused_wide_and_deep_stacks_match_jax(stack):
    """As above for stacks the card runs on the layered route: hidden 272,
    and 6 + 4 layers; the weights cross from JAX through ``params_from_jax``."""
    _model_fused_vs_jax(dict(field_dim=16, fused_mlps=True, **stack))


def _model_fused_vs_jax(kw):
    import jax
    import jax.numpy as jnp
    from tetranerf_tpu.models.config import TetrahedraNerfConfig as JaxConfig

    compute_dtype = kw.get("compute_dtype", "bfloat16")
    appearance = kw.get("appearance_embed_dim", 0)
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
    # The twins' f32 products in full f32 (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Kernel vs twin on the card, both in bfloat16: sums in another order flip
# single bf16 roundings (as TOL["bfloat16"]) and can put a pre-activation
# within an ulp of 0 on the other side of a ReLU, which moves an entry of
# a cotangent by one whole term of its sum. Each output is held to 1e-2 in
# relative Frobenius norm and its max abs error to 0.1 of its largest entry
# (the tolerances of chip_smoke.py).
CUDA_NORM_RTOL, CUDA_MAX_RTOL = 1e-2, 0.1
# In float32 (TF32 off) each output and gradient is held to 1e-4 of its
# largest entry against the f32 twin, and the f32 twin's forward outputs
# to 1e-5 in relative norm of the exact function (the twin on float64
# tensors), which a TF32 product (~5e-4 relative) would miss by an order.
# Not its gradients: where a pre-activation lies within f32 rounding of 0
# the ReLU masks of f32 and f64 differ, and that moves a row's cotangent
# by a whole term.
F32_MAX_RTOL, F32_EXACT_RTOL = 1e-4, 1e-5
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
    # The generic route: float32 at the wgmma widths and others, the widest
    # and the deepest stacks; bfloat16 at widths the wgmma route lacks.
    "narrow-f32": (16, 32, 3, 1, 64, 33),
    "preset-f32": (64, 128, 3, 1, 32, 257),
    "ragged-f32": (16, 32, 3, 1, 7, 5),
    "odd-f32": (24, 40, 3, 1, 37, 43),
    "wide-f32": (256, 256, 2, 2, 8, 65),
    "deep-f32": (8, 24, 4, 4, 16, 40),
    "odd-bf16": (24, 40, 3, 1, 37, 43),
    "deep-head-bf16": (8, 24, 2, 2, 16, 40),
    "field32-hidden64-bf16": (32, 64, 3, 1, 64, 33),
    "tiny-bf16": (5, 7, 1, 1, 9, 11),
    "wide-bf16": (256, 256, 1, 1, 8, 65),
    # The generic route's edges: 1,591 rows (no multiple of a block's rows)
    # with rays across tiles and warps; then widths either side of where
    # the forward's weights stop fitting shared memory beside the tiles
    # (bf16 144 / 160, f32 96 / 112) and where the backward's weight
    # gradients stop fitting beside eight warps' tiles, so that it caches
    # the matrices' inputs and cotangents for phases after its pass (bf16
    # 64 / 80, f32 32 / 48).
    "preset-ragged-f32": (64, 128, 3, 1, 37, 43),
    "field32-ragged-bf16": (32, 64, 3, 1, 37, 43),
    "resident-144-bf16": (144, 144, 3, 1, 37, 43),
    "streamed-160-bf16": (160, 160, 3, 1, 37, 43),
    "resident-96-f32": (96, 96, 3, 1, 37, 43),
    "streamed-112-f32": (112, 112, 3, 1, 37, 43),
    "bwd-one-pass-64-bf16": (64, 64, 3, 1, 37, 43),
    "bwd-cached-80-bf16": (80, 80, 3, 1, 37, 43),
    "bwd-one-pass-32-f32": (32, 32, 3, 1, 37, 43),
    "bwd-cached-48-f32": (48, 48, 3, 1, 37, 43),
}
# The layered route: widths above 256 or more than 8 layers, both dtypes;
# 1,591 rows with rays across the product blocks' 128-row tiles; widths
# that are no multiple of the tiles'; a 1024-wide and a 16-deep stack.
# Then the edges of the 128 x 128 tiles: widths between 257 and 384 that
# are no multiple of 128 with a d_in of 300 (1,591 rows, rays across
# tiles); dhead_dir's ray sums made by a product (two head layers) over
# rays of 7 samples, many to a tile; rays of one sample; and rays of 300
# samples, each over three or four tiles.
LAYERED_CASES = {
    "layered-wide-bf16": (64, 512, 3, 1, 37, 43),
    "layered-wide-f32": (64, 512, 3, 1, 37, 43),
    "layered-deep-bf16": (64, 128, 6, 4, 37, 43),
    "layered-deep-f32": (16, 32, 5, 4, 16, 40),
    "layered-odd-bf16": (300, 270, 2, 2, 9, 31),
    "layered-odd-f32": (257, 33, 1, 1, 9, 31),
    "layered-1024-bf16": (1024, 1024, 1, 1, 4, 65),
    "layered-16-deep-bf16": (24, 40, 8, 8, 8, 33),
    "layered-edge-bf16": (300, 320, 3, 1, 37, 43),
    "layered-edge-f32": (300, 330, 2, 1, 37, 43),
    "layered-short-rays-bf16": (64, 264, 2, 2, 61, 7),
    "layered-one-sample-bf16": (16, 272, 1, 1, 300, 1),
    "layered-long-rays-bf16": (64, 288, 2, 1, 3, 300),
}
CUDA_CASES.update(LAYERED_CASES)
CUDA_DTYPES = {name: torch.float32 if name.endswith("-f32") else torch.bfloat16
               for name in CUDA_CASES}
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


def _close_f32(kernel, twin, exact=None):
    """A float32 kernel's output or gradient against the f32 twin's
    (``twin``), and a forward output of the f32 twin against its float64
    run (``exact``)."""
    k, t = (v.detach().double().cpu() for v in (kernel, twin))
    if float((k - t).abs().max() / t.abs().max().clamp_min(1e-30)) > F32_MAX_RTOL:
        return False
    if exact is None:
        return True
    x = exact.detach().double().cpu()
    return float((t - x).norm() / x.norm().clamp_min(1e-30)) <= F32_EXACT_RTOL


def _route_counter(name, x, hidden, n_base, n_head, dt):
    plan = launch_plan(x.shape[-1], hidden, n_base, n_head, "backward" in name, dt)
    return name if plan.route == "wgmma" else f"{name}_{plan.route}"


def _check_field(x, hd, weights, n_base, n_head, dt):
    """K4 and K4b through their routes against the twins: one launch each
    on the route the plan names, outputs and every gradient as the dtype's
    tolerance says."""
    hidden = weights[0].shape[0]
    g = torch.Generator(device=x.device).manual_seed(3)
    g_rgb = torch.randn(x.shape[:2] + (3,), generator=g, device=x.device)
    g_dens = torch.randn(x.shape[:2] + (1,), generator=g, device=x.device)
    names = [_route_counter(n, x, hidden, n_base, n_head, dt)
             for n in ("fused_field_mlps", "fused_field_mlps_backward")]
    before = dict(cuda.launch_counts)
    outs = fused_field_mlps(x, hd, weights, n_base, n_head, dt)
    dx, dhd, grads = fused_field_mlps_backward(x, hd, weights, g_rgb, g_dens,
                                               n_base, n_head, dt)
    torch.cuda.synchronize()
    assert {n: cuda.launch_counts[n] - before[n] for n in cuda.launch_counts
            if cuda.launch_counts[n] != before[n]} == {n: 1 for n in names}
    twin_outs = fused_field_mlps_twin(x, hd, weights, n_base, n_head, dt)
    dx_t, dhd_t, grads_t = fused_field_mlps_backward_twin(
        x, hd, weights, g_rgb, g_dens, n_base, n_head, dt)
    if dt == torch.bfloat16:
        assert all(_close(a, b) for a, b in zip(outs, twin_outs))
        for i, (a, b) in enumerate(zip([dx, dhd, *grads], [dx_t, dhd_t, *grads_t])):
            assert a.shape == b.shape and _close(a, b), i
        return
    d = [t.double() for t in (x, hd, *weights)]
    exact_outs = fused_field_mlps_twin(d[0], d[1], d[2:], n_base, n_head, dt)
    assert all(_close_f32(a, b, c) for a, b, c in zip(outs, twin_outs, exact_outs))
    for i, (a, b) in enumerate(zip([dx, dhd, *grads], [dx_t, dhd_t, *grads_t])):
        assert a.shape == b.shape and _close_f32(a, b), i


def _check_density(x, wd, n_base, dt):
    """K5 and K5b through their routes against the twins, as _check_field."""
    hidden = wd[0].shape[0]
    g = torch.Generator(device=x.device).manual_seed(4)
    g_dens = torch.randn(x.shape[:2] + (1,), generator=g, device=x.device)
    names = [_route_counter(n, x, hidden, n_base, 0, dt)
             for n in ("fused_density_mlp", "fused_density_mlp_backward")]
    before = dict(cuda.launch_counts)
    dens = fused_density_mlp(x, wd, n_base, dt)
    dx, grads = fused_density_mlp_backward(x, wd, g_dens, n_base, dt)
    torch.cuda.synchronize()
    assert {n: cuda.launch_counts[n] - before[n] for n in cuda.launch_counts
            if cuda.launch_counts[n] != before[n]} == {n: 1 for n in names}
    dens_t = fused_density_mlp_twin(x, wd, n_base, dt)
    dx_t, grads_t = fused_density_mlp_backward_twin(x, wd, g_dens, n_base, dt)
    if dt == torch.bfloat16:
        assert _close(dens, dens_t) and _close(dx, dx_t)
        assert all(_close(a, b) for a, b in zip(grads, grads_t))
        return
    d = [t.double() for t in (x, *wd)]
    assert _close_f32(dens, dens_t, fused_density_mlp_twin(d[0], d[1:], n_base, dt))
    assert all(_close_f32(a, b) for a, b in zip([dx, *grads], [dx_t, *grads_t]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_field_kernels_match_twin(cuda_device, case):
    n_base, n_head, x, hd, weights, _, _ = _cuda_inputs(case, cuda_device)
    _check_field(x, hd, weights, n_base, n_head, CUDA_DTYPES[case])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow", "preset", "ragged", "preset-f32", "odd-f32",
                                  "deep-f32", "odd-bf16", "tiny-bf16", "wide-bf16",
                                  "preset-ragged-f32", "field32-ragged-bf16",
                                  "streamed-112-f32", "bwd-cached-80-bf16",
                                  *LAYERED_CASES])
def test_density_kernels_match_twin(cuda_device, case):
    n_base, _, x, _, weights, _, _ = _cuda_inputs(case, cuda_device, seed=1)
    _check_density(x, weights[: 2 * n_base + 2], n_base, CUDA_DTYPES[case])


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
    _model_on_card_vs_cpu(cuda_device, "bfloat16")


@pytest.mark.cuda
def test_model_fused_f32_appearance_on_card_matches_cpu(cuda_device):
    _model_on_card_vs_cpu(cuda_device, "float32")


def _model_on_card_vs_cpu(cuda_device, compute_dtype):
    cfg = tetranerf_preset(ray_buckets=1, field_dim=16, hidden_size=32,
                           appearance_embed_dim=8, fused_mlps=True,
                           compute_dtype=compute_dtype)
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
def test_generic_and_layered_routes_take_what_wgmma_lacks_and_float16_raises(cuda_device):
    """What the wgmma route lacks, float32 and d_in = 8, runs on the generic
    route, and d_in = 257 on the layered route, within tolerance of the
    twins; float16, which no route takes, raises ValueError before any
    launch."""
    n_base, n_head, x, hd, weights, _, _ = _cuda_inputs("narrow", cuda_device)
    _check_field(x, hd, weights, n_base, n_head, torch.float32)
    _check_field(x[..., :8].contiguous(), hd,
                 [weights[0][:, :8].contiguous()] + weights[1:], n_base, n_head,
                 torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    wide = torch.randn(x.shape[:2] + (257,), generator=g, device=cuda_device)
    w0 = torch.randn((32, 257), generator=g, device=cuda_device) / 16.0
    assert launch_plan(257, 32, n_base, n_head, False).route == "layered"
    _check_field(wide, hd, [w0] + weights[1:], n_base, n_head, torch.bfloat16)
    before = dict(cuda.launch_counts)
    with pytest.raises(ValueError, match="float32 nor bfloat16"):
        fused_field_mlps(x, hd, weights, n_base, n_head, torch.float16)
    assert cuda.launch_counts == before


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
    _assert_bit_equal_twice("preset", head, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [True, False], ids=["field", "density"])
@pytest.mark.parametrize("case", ["preset-f32", "odd-bf16"])
def test_generic_weight_gradients_are_bit_equal_over_two_launches(cuda_device, case,
                                                                   head):
    """The generic route's K4b and K5b: each block sums its tiles' weight
    gradients in shared memory in tile order (in its one pass, or a phase's
    chunks from the cache), writes its row once, then the rows are summed in
    block order."""
    _assert_bit_equal_twice(case, head, CUDA_DTYPES[case])


def _assert_bit_equal_twice(case, head, dt):
    n_base, n_head, x, hd, weights, g_rgb, g_dens = _cuda_inputs(case, "cuda")
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
def test_oversized_stack_runs_its_backward_on_the_generic_route(cuda_device):
    """Three base and three head layers at the preset's widths: the forward
    fits the wgmma route's shared memory, the backward does not and runs on
    the generic route; both within tolerance of the twins."""
    n_base, n_head, x, hd, weights, _, _ = _cuda_inputs((64, 128, 3, 3, 4, 16), cuda_device)
    assert launch_plan(64, 128, 3, 3, False).route == "wgmma"
    assert launch_plan(64, 128, 3, 3, True).route == "generic"
    _check_field(x, hd, weights, n_base, n_head, torch.bfloat16)


@pytest.mark.cuda
def test_f32_backward_chain_is_the_twins_bit_for_bit(cuda_device, monkeypatch):
    """The float32 backward runs its forward chain as f32 FMAs in a plain
    GEMM's order, so that its ReLU masks are those of the f32 twin whose
    gradients it is held to. At the preset's widths it caches that chain's
    activations a_1 .. a_{L-1}: each is the twin's on the card, bit for
    bit."""
    n_base, n_head, x, hd, weights, g_rgb, g_dens = _cuda_inputs("preset-f32", cuda_device)
    dt = torch.float32
    plan = launch_plan(64, 128, n_base, n_head, True, dt)
    assert plan.phases > 1
    caches, make = [], mlp._generic_cache

    def keep(*args):
        caches.append(make(*args))
        return caches[-1]

    monkeypatch.setattr(mlp, "_generic_cache", keep)
    fused_field_mlps_backward(x, hd, weights, g_rgb, g_dens, n_base, n_head, dt)
    torch.cuda.synchronize()
    rows = x.shape[0] * x.shape[1]
    padded = -(-rows // plan.rows_per_tile) * plan.rows_per_tile
    _, _, base_acts, head_acts, _ = mlp._chain(
        x.reshape(rows, -1), mlp._per_row(hd, x.shape[1]), weights, n_base, n_head, dt)
    acts = base_acts[1:] + head_acts
    tile = plan.rows_per_tile
    for k in range(1, n_base + n_head):  # plane k - 1: a_k, each tile's block [128][tile]
        plane = caches[0][(k - 1) * padded * 128: k * padded * 128]
        cached = plane.view(-1, 128, tile).transpose(1, 2).reshape(padded, 128)
        assert torch.equal(cached[:rows], acts[k - 1]), k


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_host_plan_is_the_kernels_plan(cuda_device, backward):
    """The host's generic plan is the one the kernels compute for
    themselves (``make_gplan``), at every stack of PLAN_STACKS and both
    dtypes."""
    import ctypes

    query = cuda.entry("tetranerf_fused_mlp_generic_plan")
    for (d_in, hidden, n_base, n_head), _, _ in PLAN_STACKS.values():
        for dtype in (torch.float32, torch.bfloat16):
            host = _generic_plan(d_in, hidden, n_base, n_head, backward, dtype)
            out = (ctypes.c_int * 6)()
            assert query(d_in, hidden, n_base, n_head, int(dtype == torch.bfloat16),
                         int(backward), out)
            assert list(out) == [host.rows_per_tile, host.warps, int(host.resident),
                                 host.phases, host.aux_tile_floats, host.smem_bytes], \
                (d_in, hidden, n_base, n_head, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [True, False], ids=["field", "density"])
@pytest.mark.parametrize("case", ["layered-wide-bf16", "layered-deep-f32", "layered-deep-bf16",
                                  "layered-wide-f32"])
def test_layered_weight_gradients_are_bit_equal_over_two_launches(cuda_device, case, head):
    """The layered route's K4b and K5b: each weight gradient is summed per
    row split in row order, the splits in split order and the chunks in
    chunk order; each bias gradient and dhead_dir per tile, then over the
    tiles in tile order: the same bits in every launch (no float
    atomics)."""
    _assert_bit_equal_twice(case, head, CUDA_DTYPES[case])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["layered-wide-bf16", "layered-deep-f32"])
def test_layered_route_runs_rows_in_chunks(cuda_device, monkeypatch, case):
    """With room for 5 rays a chunk, K4/K4b/K5/K5b of 37 (16) rays run in 8
    (4) chunks, the gradients summed over them in chunk order, and stay
    within tolerance of the twins."""
    n_base, n_head, x, hd, weights, _, _ = _cuda_inputs(case, cuda_device)
    plan = launch_plan(x.shape[-1], weights[0].shape[0], n_base, n_head, True,
                       CUDA_DTYPES[case])
    monkeypatch.setattr(mlp, "LAYERED_SCRATCH_BYTES", 5 * x.shape[1] * plan.aux_tile_floats * 4)
    assert mlp.layered_chunk_rays(plan, x.shape[0], x.shape[1]) == (5 if x.shape[0] == 37 else 4)
    _check_field(x, hd, weights, n_base, n_head, CUDA_DTYPES[case])
    _check_density(x, weights[: 2 * n_base + 2], n_base, CUDA_DTYPES[case])


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_host_layered_plan_is_the_kernels_plan(cuda_device, backward):
    """The host's layered plan (scratch floats a row, scratch floats beside
    the rows, a product block's shared memory and stages) is the one the
    kernels check the scratch against and launch with."""
    import ctypes

    query = cuda.entry("tetranerf_fused_mlp_layered_plan")
    for d_in, hidden, n_base, n_head, _, _ in LAYERED_CASES.values():
        for dtype in (torch.float32, torch.bfloat16):
            host = launch_plan(d_in, hidden, n_base, n_head, backward, dtype)
            out = (ctypes.c_longlong * 4)()
            assert query(d_in, hidden, n_base, n_head, int(dtype == torch.bfloat16),
                         int(backward), out)
            assert list(out) == [host.aux_tile_floats, host.ws_floats, host.smem_bytes,
                                 host.stages]


# ------------------------------------------------------- the launch plan


# name: ((d_in, hidden, n_base, n_head), compute_dtype, (forward route,
# backward route))
PLAN_STACKS = {name: (case[:4], CUDA_DTYPES[name],
                      ("wgmma", "wgmma") if CUDA_DTYPES[name] == torch.bfloat16
                      and case[:2] in ((16, 32), (64, 128)) else ("generic", "generic"))
               for name, case in CUDA_CASES.items() if name not in LAYERED_CASES}
PLAN_STACKS.update({
    "preset-density": ((64, 128, 3, 0), torch.bfloat16, ("wgmma", "wgmma")),
    "narrow-density": ((16, 32, 3, 0), torch.bfloat16, ("wgmma", "wgmma")),
    "preset-head-3-forward": ((64, 128, 3, 3), torch.bfloat16, ("wgmma", "generic")),
    "preset-density-f32": ((64, 128, 3, 0), torch.float32, ("generic", "generic")),
    "hidden-256-density": ((64, 256, 3, 0), torch.bfloat16, ("generic", "generic")),
    "preset-head-5": ((64, 128, 3, 5), torch.bfloat16, ("generic", "generic")),
})


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("stack", list(PLAN_STACKS))
def test_launch_plan_takes_the_kernel_stacks(stack, backward):
    (d_in, hidden, n_base, n_head), dtype, routes = PLAN_STACKS[stack]
    plan = launch_plan(d_in, hidden, n_base, n_head, backward, dtype)
    assert plan.route == routes[backward]
    assert 0 < plan.smem_bytes <= MAX_SMEM_BYTES
    if plan.route == "wgmma":
        assert plan.rows_per_tile == 64
        assert plan.warpgroups == 2 if backward else 1 <= plan.warpgroups <= 3
    else:
        # Warps of 16 rows, the MMA's M. Resident weights are in shared
        # memory as operands. The backward's one pass sums every weight
        # gradient (f32) in shared memory, at eight warps; past it, its cache
        # holds each matrix's input but x and each cotangent, as operands,
        # for every 16 rows.
        layers = n_base + n_head
        esz = 2 if dtype == torch.bfloat16 else 4
        macs = hidden * d_in + (layers - 1) * hidden * hidden  # the matrices' entries
        assert plan.rows_per_tile == 16 * plan.warps
        assert 1 <= plan.warps <= (8 if backward else 16)
        assert plan.warpgroups == 0 and plan.stages == 0
        assert not plan.resident or plan.smem_bytes > macs * esz
        if not backward:
            assert plan.phases == 0 and plan.aux_tile_floats == 0
        elif plan.phases == 1:
            assert plan.warps == 8 and plan.aux_tile_floats == 0
            assert plan.smem_bytes > macs * 4
        else:
            words = 16 * ((2 * layers - 1) * hidden + (1 if n_head else 0)) * esz / 4
            assert plan.aux_tile_floats >= words
    rng = np.random.default_rng(0)
    weights = [_port(w) for w in _jax_weights(rng, d_in, hidden, n_base, n_head)]
    size = sum(w.numel() for w in weights)
    # The workspace row holds every gradient, rounded up to 8 floats.
    assert plan.ws_floats == (-(-size // 8) * 8 if backward else 0)


def test_generic_plan_keeps_the_weights_resident_where_they_fit():
    """bf16 at field 32, hidden 64 and at the preset's 64 / 128 keep the
    forward's weights resident in shared memory; float32 at 64 / 128 (231 KB
    of weights) streams them. The bf16 32 / 64 backward keeps them too and
    sums every weight gradient in its one pass at eight warps; float32 at
    64 / 128 (231 KB of weight gradients) streams the weights and caches
    the matrices' inputs and cotangents for phases after its pass."""
    for d_in, hidden, dtype, resident in ((32, 64, torch.bfloat16, True),
                                          (64, 128, torch.bfloat16, True),
                                          (64, 128, torch.float32, False)):
        for n_head in (1, 0):
            plan = _generic_plan(d_in, hidden, 3, n_head, False, dtype)
            assert plan.resident is resident, (d_in, hidden, dtype, n_head)
    for n_head in (1, 0):
        bwd = _generic_plan(32, 64, 3, n_head, True, torch.bfloat16)
        assert bwd.resident and bwd.phases == 1 and bwd.warps == 8
        bwd = _generic_plan(64, 128, 3, n_head, True, torch.float32)
        assert not bwd.resident and bwd.phases > 1 and bwd.aux_tile_floats > 0
    assert launch_plan(32, 64, 3, 1, False, torch.bfloat16).resident


def test_launch_plan_stages_and_warpgroups_follow_shared_memory():
    """Where shared memory is short the wgmma plan gives up the backward's x
    prefetch, then the forward's third warpgroup; past that, and at other
    widths, the stack goes to the generic route."""
    assert launch_plan(64, 128, 3, 1, True).stages == 1
    assert launch_plan(64, 128, 3, 2, True).stages == 0
    assert launch_plan(64, 128, 3, 2, False).warpgroups == 3
    assert launch_plan(64, 128, 3, 3, False).warpgroups == 2
    assert launch_plan(64, 128, 3, 5, False).route == "generic"
    assert launch_plan(32, 64, 3, 1, False).route == "generic"
    assert launch_plan(64, 128, 3, 1, False, torch.float32).route == "generic"
    with pytest.raises(ValueError):
        launch_plan(16, 32, 0, 1, True)


def test_launch_plan_takes_every_stack_in_range():
    """Every width in [1, 256] (a sample of them: the edges of each 16-wide
    padding step), every depth up to 8 and both dtypes get a plan that fits
    a block's shared memory."""
    widths = (1, 15, 16, 17, 24, 40, 100, 240, 255, 256)
    for dtype in (torch.float32, torch.bfloat16):
        for d_in in widths:
            for hidden in widths:
                for n_base in range(1, 9):
                    for n_head in range(0, 9 - n_base):
                        for backward in (False, True):
                            plan = launch_plan(d_in, hidden, n_base, n_head, backward,
                                               dtype)
                            assert plan.smem_bytes <= MAX_SMEM_BYTES
                            assert plan.route in ("wgmma", "generic")


@pytest.mark.parametrize("stack, dtype, match", [
    ((0, 128, 3, 1), torch.float32, r"\[1, 256\]"),
    ((64, 128, 0, 1), torch.bfloat16, "1 <= n_base"),
    ((64, 128, 3, 1), torch.float16, "float32 nor bfloat16"),
], ids=["d_in-0", "no-base", "float16"])
def test_launch_plan_refuses_outside_the_range(stack, dtype, match):
    for backward in (False, True):
        with pytest.raises(ValueError, match=match):
            launch_plan(*stack, backward, dtype)


@pytest.mark.parametrize("stack, dtype", [
    ((64, 257, 3, 1), torch.float32),
    ((257, 128, 3, 1), torch.bfloat16),
    ((64, 128, 5, 4), torch.float32),
    ((1024, 1024, 3, 1), torch.bfloat16),
    ((64, 128, 8, 8), torch.bfloat16),
    ((24, 40, 16, 0), torch.float32),
], ids=["hidden-257", "d_in-257", "depth-9", "1024-wide", "16-deep", "16-deep-density"])
def test_launch_plan_takes_wide_and_deep_stacks_on_the_layered_route(stack, dtype):
    """Past the generic route's widths and depths, the layered route: 8
    warps of 16 rows a product block (bf16: two wgmma warpgroups), a ring
    of three stages in its dynamic shared memory, a row of a chunk holding
    a_1 .. a_L as operands (bf16: beside x's bf16 copy; in the backward two
    cotangents as operands and the heads' four f32), the backward's
    workspace 2^24 floats or one row of the largest weight gradient and its
    bias, and in bf16 the weights' bf16 copies (W_k; the backward's W_k^T
    too) beside it."""
    d_in, hidden, n_base, n_head = stack
    bf16 = dtype == torch.bfloat16
    esz = 2 if bf16 else 4
    ldh, ldx = -(-hidden // 8) * 8, -(-d_in // 8) * 8
    layers = n_base + n_head
    for backward in (False, True):
        plan = launch_plan(d_in, hidden, n_base, n_head, backward, dtype)
        assert plan.route == "layered"
        assert plan.rows_per_tile == 128 and plan.warps == 8
        assert plan.warpgroups == (2 if bf16 else 0) and plan.stages == 3
        assert plan.phases == 0 and not plan.resident
        # Three stages of a 128 x 64 and a 128 x 64 bf16 operand (and the
        # column sums' partials of 8 warps by 128 columns), or of a 128 x 32
        # and a 64 x 32 f32 operand (rows padded by 16 bytes).
        assert plan.smem_bytes == (3 * 256 * 64 * 2 + 8 * 128 * 4 if bf16 else 3 * 192 * 36 * 4)
        assert plan.smem_bytes <= MAX_SMEM_BYTES
        cot = 2 * ldh + 4 * 4 // esz if backward else 0  # in elements of esz bytes
        row = (layers * ldh + (ldx if bf16 else 0) + cot) * esz // 4
        assert plan.aux_tile_floats == row
        ws = max(1 << 24, hidden * max(d_in, hidden, 4) + hidden) if backward else 0
        ins = [ldx] + [ldh] * (layers - 1)
        copies = hidden * sum(ins) * 2 // 4 if bf16 else 0
        if bf16 and backward:
            copies += (d_in + hidden * (layers - 1)) * ldh * 2 // 4
        assert plan.ws_floats == ws + copies
        # One chunk holds at least one ray and at most LAYERED_SCRATCH_BYTES.
        for rays, samples in ((4096, 257), (3, 1), (1, 10**7)):
            chunk = mlp.layered_chunk_rays(plan, rays, samples)
            assert 1 <= chunk <= rays
            assert chunk == 1 or chunk * samples * row * 4 <= mlp.LAYERED_SCRATCH_BYTES


def test_launch_plan_takes_every_stack_up_to_1024_wide_and_16_deep():
    """Widths 1-1024 (a sample: each side of 256 and of the tiles' 64 and
    128) and depths 1-16 in both dtypes get a plan; the layered route takes
    exactly the stacks past the generic route's widths or depths."""
    widths = (1, 16, 255, 256, 257, 300, 511, 512, 513, 1023, 1024)
    for dtype in (torch.float32, torch.bfloat16):
        for d_in in widths:
            for hidden in widths:
                for n_base in range(1, 17):
                    for n_head in range(0, 17 - n_base):
                        past = max(d_in, hidden) > 256 or n_base + n_head > 8
                        for backward in (False, True):
                            plan = launch_plan(d_in, hidden, n_base, n_head, backward, dtype)
                            assert (plan.route == "layered") == past
