"""Fused MLP stacks: the field MLPs (kernels K4 and K4b) and the density MLP
(K5 and K5b), all in ``csrc/mlp.cu``, each beside its plain PyTorch twin,
and the autograd Functions that join each forward to its backward.

Counterpart of :mod:`tetranerf_tpu.ops.pallas_mlp`, under its precision
contract, which is not :mod:`..models.nn`'s: products take operands rounded
to ``compute_dtype`` and sum in f32; biases (and ``head_dir``) are added in
f32 unrounded; activations stay f32 between layers and are rounded only as
the next product's operand; the nonlinearities run in f32. The backward
rounds every cotangent to ``compute_dtype`` at each product and keeps
``dhead_dir`` and the bias gradients as f32 sums of the unrounded
cotangents. The twins write that out step by step, so they are not autograd
of the forward (which would keep the cotangents in f32).

``weights`` is a flat list in the JAX order, with the port's ``[out, in]``
matrices: base ``(W, b)`` pairs, density ``(w_d [1, H], b_d)``, then for the
field MLPs ``W_bh [H, H]`` (the first head layer's base-feature columns; its
bias and direction columns live in ``head_dir``), the remaining head
``(W, b)`` pairs and colour ``(W_c [3, H], b_c)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as F

from . import cuda


def as_operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` as a product's operand, back in f32: a
    product of two such operands is exact in f32, so ``a @ b`` of them sums
    exact products in f32."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _dot_t(a, w, dtype):
    """``a @ w^T`` with operands rounded to ``dtype``, summed in f32."""
    return as_operand(a, dtype) @ as_operand(w, dtype).T


def _dot(a, w, dtype):
    """``a @ w`` with operands rounded to ``dtype``, summed in f32."""
    return as_operand(a, dtype) @ as_operand(w, dtype)


def _split(weights: Sequence[torch.Tensor], n_base: int, n_head: int):
    ws = list(weights)
    base = [(ws.pop(0), ws.pop(0)) for _ in range(n_base)]
    dens = (ws.pop(0), ws.pop(0))
    if n_head == 0:
        return base, dens, None, [], None
    wbh = ws.pop(0)
    head = [(ws.pop(0), ws.pop(0)) for _ in range(n_head - 1)]
    return base, dens, wbh, head, (ws.pop(0), ws.pop(0))


def _chain(x2, hd2, weights, n_base, n_head, dtype):
    """The layer chain on flat rows ``x2 [N, D]`` (``hd2 [N, H]`` per row):
    ``(rgb [N, 3] or None, density [N, 1], base_acts, head_acts, pre_d)``
    (``_forward_chain`` of the JAX package)."""
    base, (wd, bd), wbh, head, colour = _split(weights, n_base, n_head)
    base_acts = [x2]
    for w, b in base:
        base_acts.append(torch.relu(_dot_t(base_acts[-1], w, dtype) + b))
    pre_d = _dot_t(base_acts[-1], wd, dtype) + bd
    density = F.softplus(pre_d)
    if n_head == 0:
        return None, density, base_acts, [], pre_d
    head_acts = [torch.relu(_dot_t(base_acts[-1], wbh, dtype) + hd2)]
    for w, b in head:
        head_acts.append(torch.relu(_dot_t(head_acts[-1], w, dtype) + b))
    wc, bc = colour
    rgb = torch.sigmoid(_dot_t(head_acts[-1], wc, dtype) + bc)
    return rgb, density, base_acts, head_acts, pre_d


def _per_row(head_dir, num_samples):
    return head_dir.repeat_interleave(num_samples, dim=0)


def fused_field_mlps_twin(x, head_dir, weights, n_base: int, n_head: int,
                          compute_dtype: torch.dtype):
    """``x f32[R, S, D]``, ``head_dir f32[R, H]`` -> ``(rgb f32[R, S, 3],
    density f32[R, S, 1])``."""
    num_rays, num_samples, d_in = x.shape
    rgb, density, *_ = _chain(
        x.reshape(-1, d_in), _per_row(head_dir, num_samples), weights, n_base,
        n_head, compute_dtype,
    )
    return (rgb.reshape(num_rays, num_samples, 3),
            density.reshape(num_rays, num_samples, 1))


def _base_backward(g, base_acts, base, dtype):
    """From the cotangent ``g`` of the base output down to ``dx``: returns
    ``(dx, [(dW, db)] in layer order)``."""
    grads = []
    for i in range(len(base) - 1, -1, -1):
        g_pre = g * (base_acts[i + 1] > 0.0)
        grads.append((_dot(g_pre.T, base_acts[i], dtype), g_pre.sum(0)))
        g = _dot(g_pre, base[i][0], dtype)
    return g, grads[::-1]


def fused_field_mlps_backward_twin(x, head_dir, weights, g_rgb, g_dens,
                                   n_base: int, n_head: int,
                                   compute_dtype: torch.dtype):
    """The VJP of :func:`fused_field_mlps_twin` (``_bwd_kernel`` of the JAX
    package): ``(dx [R, S, D], dhead_dir [R, H], [d weight, ...])`` with
    the weight gradients in the order of ``weights``."""
    dt = compute_dtype
    num_rays, num_samples, d_in = x.shape
    rgb, _, base_acts, head_acts, pre_d = _chain(
        x.reshape(-1, d_in), _per_row(head_dir, num_samples), weights, n_base,
        n_head, dt,
    )
    base, (wd, _), wbh, head, (wc, _) = _split(weights, n_base, n_head)
    g_rgb = g_rgb.reshape(-1, 3)
    g_dens = g_dens.reshape(-1, 1)
    # Colour head: rgb = sigmoid(pre_c).
    g_pre = g_rgb * rgb * (1.0 - rgb)
    d_colour = [_dot(g_pre.T, head_acts[-1], dt), g_pre.sum(0)]
    g = _dot(g_pre, wc, dt)
    # Head layers beyond the first, reversed.
    d_head = []
    for i in range(n_head - 2, -1, -1):
        g_pre = g * (head_acts[i + 1] > 0.0)
        d_head.append([_dot(g_pre.T, head_acts[i], dt), g_pre.sum(0)])
        g = _dot(g_pre, head[i][0], dt)
    # First head layer: head_dir enters additively.
    g_pre = g * (head_acts[0] > 0.0)
    d_wbh = _dot(g_pre.T, base_acts[-1], dt)
    dhd = g_pre.reshape(num_rays, num_samples, g_pre.shape[-1]).sum(1)
    g_base = _dot(g_pre, wbh, dt)
    # Density head.
    g_pre_d = g_dens * torch.sigmoid(pre_d)
    d_dens = [_dot(g_pre_d.T, base_acts[-1], dt), g_pre_d.sum(0)]
    g_base = g_base + _dot(g_pre_d, wd, dt)
    dx, d_base = _base_backward(g_base, base_acts, base, dt)
    grads = [t for pair in d_base for t in pair] + d_dens + [d_wbh]
    grads += [t for pair in d_head[::-1] for t in pair] + d_colour
    return dx.reshape(x.shape), dhd, grads


def fused_density_mlp_twin(x, weights, n_base: int, compute_dtype: torch.dtype):
    """Base MLP and softplus density only (the coarse round):
    ``x f32[R, S, D]`` -> ``density f32[R, S, 1]``."""
    num_rays, num_samples, d_in = x.shape
    _, density, *_ = _chain(x.reshape(-1, d_in), None, weights, n_base, 0,
                            compute_dtype)
    return density.reshape(num_rays, num_samples, 1)


def fused_density_mlp_backward_twin(x, weights, g_dens, n_base: int,
                                    compute_dtype: torch.dtype):
    """The VJP of :func:`fused_density_mlp_twin` (``_dens_bwd_kernel``):
    ``(dx [R, S, D], [d weight, ...])``."""
    dt = compute_dtype
    d_in = x.shape[-1]
    _, _, base_acts, _, pre_d = _chain(x.reshape(-1, d_in), None, weights,
                                       n_base, 0, dt)
    base, (wd, _), *_ = _split(weights, n_base, 0)
    g_pre_d = g_dens.reshape(-1, 1) * torch.sigmoid(pre_d)
    d_dens = [_dot(g_pre_d.T, base_acts[-1], dt), g_pre_d.sum(0)]
    dx, d_base = _base_backward(_dot(g_pre_d, wd, dt), base_acts, base, dt)
    return dx.reshape(x.shape), [t for pair in d_base for t in pair] + d_dens


# ---------------------------------------------------------------- kernels


# The kernels' widths (d_in, hidden): each pair is a template instance of
# csrc/mlp.cu, whose wgmma shapes and register arrays are fixed at compile
# time.
KERNEL_WIDTHS = ((16, 32), (64, 128))
MAX_SMEM_BYTES = 232448  # shared memory one block may use on the H100
MAX_LAYERS = 8  # hidden matrices, n_base + n_head
ROWS_PER_TILE = 64  # rows per warpgroup: wgmma's M
_MAX_FWD_WARPGROUPS = 3
_BWD_WARPGROUPS = 2


def _align(n: int, a: int = 128) -> int:
    return -(-n // a) * a


@dataclass(frozen=True)
class LaunchPlan:
    """How K4/K5 (``backward=False``) or K4b/K5b lay a stack out on the
    card, as ``csrc/mlp.cu``'s ``make_plan`` does: the kernel checks the
    numbers it is given against its own and refuses a mismatch."""

    rows_per_tile: int  # rows of one warpgroup's tile
    warpgroups: int  # per block (one block per SM)
    stages: int  # x stages of a warpgroup with room of their own; 0: the
    # stage shares the backward's cotangent staging (no prefetch)
    smem_bytes: int  # dynamic shared memory per block
    ws_floats: int  # one block's weight-gradient workspace row (backward)
    aux_tile_floats: int  # the backward's cached masks and head cotangents
    # of one 64-row tile


def launch_plan(d_in: int, hidden: int, n_base: int, n_head: int,
                backward: bool) -> LaunchPlan:
    """The launch plan of a fused-MLP kernel for this stack; raises
    ``ValueError`` for a stack the kernels do not take or that does not fit
    in a block's shared memory."""
    if (d_in, hidden) not in KERNEL_WIDTHS:
        raise ValueError(
            f"fused MLP kernels: widths (d_in, hidden) = {(d_in, hidden)} not "
            f"among the compiled {KERNEL_WIDTHS}")
    layers = n_base + n_head
    if n_base < 1 or n_head < 0 or layers > MAX_LAYERS:
        raise ValueError(f"fused MLP kernels: n_base={n_base}, n_head={n_head}: "
                         f"1 <= n_base and n_base + n_head <= {MAX_LAYERS}")
    n_w = hidden * d_in + hidden * hidden * (layers - 1) + hidden
    n_w += 3 * hidden if n_head else 0
    n_b = hidden * (layers - (1 if n_head else 0)) + (4 if n_head else 1)
    # bf16 weights as core matrices, then the f32 biases, w_d and W_c.
    fixed = sum(_align(hidden * (d_in if k == 0 else hidden) * 2) for k in range(layers))
    fixed += _align((n_b + 4 * hidden) * 4)
    x_stage = _align(ROWS_PER_TILE * d_in * 4)
    ws_floats = _align(n_w + n_b, 8)
    # Per row: pre_d's and pre_c's cotangents; per thread: a bit per
    # element of each layer's ReLU mask.
    aux = ROWS_PER_TILE * 4 + layers * -(-(hidden // 2) // 32) * 128
    if not backward:
        for groups in range(_MAX_FWD_WARPGROUPS, 0, -1):
            smem = fixed + groups * x_stage
            if smem <= MAX_SMEM_BYTES:
                return LaunchPlan(ROWS_PER_TILE, groups, 1, smem, 0, 0)
        need = fixed + x_stage
    else:
        staging = _align(2 * ROWS_PER_TILE * hidden * 2 + 512)
        staging += _align(2 * ROWS_PER_TILE * max(d_in, hidden) * 2)
        staging += _BWD_WARPGROUPS * _align(aux * 4)
        smem = fixed + staging + _BWD_WARPGROUPS * x_stage
        if smem <= MAX_SMEM_BYTES:
            return LaunchPlan(ROWS_PER_TILE, _BWD_WARPGROUPS, 1, smem, ws_floats, aux)
        need = fixed + staging
        if need <= MAX_SMEM_BYTES and ROWS_PER_TILE * d_in * 4 <= ROWS_PER_TILE * hidden * 2:
            return LaunchPlan(ROWS_PER_TILE, _BWD_WARPGROUPS, 0, need, ws_floats, aux)
    raise ValueError(
        f"fused MLP kernels: a stack of d_in={d_in}, hidden={hidden}, "
        f"n_base={n_base}, n_head={n_head} needs {need} bytes of shared memory "
        f"per block for the {'backward' if backward else 'forward'}, more than "
        f"the {MAX_SMEM_BYTES} a block can use")


def _check(name, x, head_dir, weights, n_base, n_head, compute_dtype):
    """Refuse what K4/K4b/K5/K5b do not take."""
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name}: the CUDA kernel computes in bfloat16 only, not "
            f"{compute_dtype}"
        )
    tensors = {"x": x, **{f"weights[{i}]": w for i, w in enumerate(weights)}}
    if head_dir is not None:
        tensors["head_dir"] = head_dir
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices: {devices}")
    cuda.check_cuda_inputs(name, x=x, **({} if head_dir is None else {"head_dir": head_dir}))
    num_rays, _, d_in = x.shape
    hidden = weights[0].shape[0]
    expected = [(hidden, d_in), (hidden,)]
    expected += [(hidden, hidden), (hidden,)] * (n_base - 1) + [(1, hidden), (1,)]
    if n_head:
        expected += [(hidden, hidden)] + [(hidden, hidden), (hidden,)] * (n_head - 1)
        expected += [(3, hidden), (3,)]
    if (
        x.dtype != torch.float32
        or [tuple(w.shape) for w in weights] != expected
        or any(w.dtype != torch.float32 for w in weights)
        or (head_dir is not None and (head_dir.dtype != torch.float32
                                      or head_dir.shape != (num_rays, hidden)))
    ):
        raise ValueError(f"{name}: unsupported shapes, widths or dtypes")
    return launch_plan(d_in, hidden, n_base, n_head, "backward" in name)


def _pack(weights):
    """Matrices flat in order, then biases in order: the kernels' layout."""
    mats = torch.cat([w.reshape(-1) for w in weights if w.dim() == 2])
    biases = torch.cat([w for w in weights if w.dim() == 1])
    return mats.contiguous(), biases.contiguous()


def _unpack(flat, weights) -> List[torch.Tensor]:
    n_w = sum(w.numel() for w in weights if w.dim() == 2)
    out, i, j = [], 0, n_w
    for w in weights:
        if w.dim() == 2:
            out.append(flat[i : i + w.numel()].view(w.shape))
            i += w.numel()
        else:
            out.append(flat[j : j + w.numel()])
            j += w.numel()
    return out


def _num_blocks(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _forward_cuda(counter, plan, x, head_dir, weights, n_base, n_head):
    num_rays, num_samples, d_in = x.shape
    dev = x.device
    wpack, bpack = _pack(weights)
    dens = torch.empty((num_rays, num_samples, 1), device=dev)
    rgb = torch.empty((num_rays, num_samples, 3), device=dev) if n_head else None
    if dens.numel():
        cuda.launch(
            counter, "tetranerf_fused_mlp_forward", dev,
            cuda.ptr(x), None if head_dir is None else cuda.ptr(head_dir),
            cuda.ptr(wpack), cuda.ptr(bpack),
            None if rgb is None else cuda.ptr(rgb), cuda.ptr(dens),
            num_rays, num_samples, d_in, weights[0].shape[0], n_base, n_head,
            _num_blocks(dev), plan.warpgroups, plan.smem_bytes,
        )
    return rgb, dens


def _backward_cuda(counter, plan, x, head_dir, weights, g_rgb, g_dens, n_base,
                   n_head):
    num_rays, num_samples, d_in = x.shape
    hidden = weights[0].shape[0]
    dev = x.device
    if g_dens.shape != (num_rays, num_samples, 1) or (
        n_head and g_rgb.shape != (num_rays, num_samples, 3)
    ):
        raise ValueError(f"{counter}: unexpected cotangent shapes")
    cuda.check_cuda_inputs(counter, g_dens=g_dens,
                           **({"g_rgb": g_rgb} if n_head else {}))
    wpack, bpack = _pack(weights)
    if not num_rays * num_samples:
        # A data-parallel rank's empty bucket: nothing to launch, zero gradients.
        zeros = torch.zeros(wpack.numel() + bpack.numel(), device=dev)
        dhd = torch.zeros((num_rays, hidden), device=dev) if n_head else None
        return torch.empty_like(x), dhd, _unpack(zeros, weights)
    num_blocks = _num_blocks(dev)
    # Each block writes its rows' weight gradients once into a row of its own.
    ws = torch.empty((num_blocks, plan.ws_floats), device=dev)
    grads = torch.empty(wpack.numel() + bpack.numel(), device=dev)
    tiles = 2 * -(-(num_rays * num_samples) // (2 * ROWS_PER_TILE))
    # The tiles' cached masks and head cotangents, then per block each
    # warp's column sums ([8][5H + 4]).
    aux = torch.empty(tiles * plan.aux_tile_floats + num_blocks * 8 * (5 * hidden + 4),
                      device=dev)
    dx = torch.empty_like(x)
    dhd = torch.zeros((num_rays, hidden), device=dev) if n_head else None
    cuda.launch(
        counter, "tetranerf_fused_mlp_backward", dev,
        cuda.ptr(x), None if head_dir is None else cuda.ptr(head_dir),
        cuda.ptr(wpack), cuda.ptr(bpack),
        cuda.ptr(g_rgb) if n_head else None, cuda.ptr(g_dens),
        cuda.ptr(dx), None if dhd is None else cuda.ptr(dhd),
        cuda.ptr(ws), cuda.ptr(grads), cuda.ptr(aux),
        num_rays, num_samples, d_in, hidden, n_base, n_head, num_blocks,
        plan.ws_floats, plan.stages, plan.smem_bytes,
    )
    return dx, dhd, _unpack(grads, weights)


def _on(name, x):
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def fused_field_mlps(x, head_dir, weights, n_base, n_head, compute_dtype):
    """K4 on CUDA tensors, :func:`fused_field_mlps_twin` on CPU tensors."""
    if _on("fused_field_mlps", x):
        plan = _check("fused_field_mlps", x, head_dir, weights, n_base, n_head,
                      compute_dtype)
        return _forward_cuda("fused_field_mlps", plan, x, head_dir, weights,
                             n_base, n_head)
    return fused_field_mlps_twin(x, head_dir, weights, n_base, n_head,
                                 compute_dtype)


def fused_field_mlps_backward(x, head_dir, weights, g_rgb, g_dens, n_base,
                              n_head, compute_dtype):
    """K4b on CUDA tensors, :func:`fused_field_mlps_backward_twin` on CPU
    tensors."""
    if _on("fused_field_mlps_backward", x):
        plan = _check("fused_field_mlps_backward", x, head_dir, weights, n_base,
                      n_head, compute_dtype)
        return _backward_cuda("fused_field_mlps_backward", plan, x, head_dir,
                              weights, g_rgb, g_dens, n_base, n_head)
    return fused_field_mlps_backward_twin(x, head_dir, weights, g_rgb, g_dens,
                                          n_base, n_head, compute_dtype)


def fused_density_mlp(x, weights, n_base, compute_dtype):
    """K5 on CUDA tensors, :func:`fused_density_mlp_twin` on CPU tensors."""
    if _on("fused_density_mlp", x):
        plan = _check("fused_density_mlp", x, None, weights, n_base, 0,
                      compute_dtype)
        return _forward_cuda("fused_density_mlp", plan, x, None, weights, n_base,
                             0)[1]
    return fused_density_mlp_twin(x, weights, n_base, compute_dtype)


def fused_density_mlp_backward(x, weights, g_dens, n_base, compute_dtype):
    """K5b on CUDA tensors, :func:`fused_density_mlp_backward_twin` on CPU
    tensors."""
    if _on("fused_density_mlp_backward", x):
        plan = _check("fused_density_mlp_backward", x, None, weights, n_base, 0,
                      compute_dtype)
        dx, _, grads = _backward_cuda("fused_density_mlp_backward", plan, x, None,
                                      weights, None, g_dens, n_base, 0)
        return dx, grads
    return fused_density_mlp_backward_twin(x, weights, g_dens, n_base,
                                           compute_dtype)


class FusedFieldMLPs(torch.autograd.Function):
    """``(rgb, density) = FusedFieldMLPs.apply(x, head_dir, n_base, n_head,
    compute_dtype, *weights)``: K4 forward, K4b backward. Saves ``x``,
    ``head_dir`` and the weights, no activations (the JAX ``custom_vjp``'s
    residuals)."""

    @staticmethod
    def forward(ctx, x, head_dir, n_base, n_head, compute_dtype, *weights):
        x, head_dir = x.contiguous(), head_dir.contiguous()
        ctx.save_for_backward(x, head_dir, *weights)
        ctx.static = (n_base, n_head, compute_dtype)
        return fused_field_mlps(x, head_dir, weights, n_base, n_head,
                                compute_dtype)

    @staticmethod
    def backward(ctx, g_rgb, g_dens):
        x, head_dir, *weights = ctx.saved_tensors
        dx, dhd, grads = fused_field_mlps_backward(
            x, head_dir, weights, g_rgb.contiguous(), g_dens.contiguous(),
            *ctx.static,
        )
        return (dx, dhd, None, None, None, *grads)


class FusedDensityMLP(torch.autograd.Function):
    """``density = FusedDensityMLP.apply(x, n_base, compute_dtype,
    *weights)``: K5 forward, K5b backward; saves ``x`` and the weights."""

    @staticmethod
    def forward(ctx, x, n_base, compute_dtype, *weights):
        x = x.contiguous()
        ctx.save_for_backward(x, *weights)
        ctx.static = (n_base, compute_dtype)
        return fused_density_mlp(x, weights, n_base, compute_dtype)

    @staticmethod
    def backward(ctx, g_dens):
        x, *weights = ctx.saved_tensors
        dx, grads = fused_density_mlp_backward(
            x, weights, g_dens.contiguous(), *ctx.static
        )
        return (dx, None, None, *grads)
