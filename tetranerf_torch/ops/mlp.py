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

On the card each kernel has three routes, chosen by :func:`launch_plan`
from the stack's shape and dtype, never by a failure: ``"wgmma"``, the
bf16 tensor-core instances at widths (16, 32) and (64, 128) where their
shared memory holds the stack; ``"generic"``, ``mma.sync`` on the tensor
cores at any width up to :data:`MAX_WIDTH` and any depth up to
:data:`MAX_LAYERS`: bf16 operands, or for float32 (JAX's
``Precision.HIGHEST``) 3xTF32, each operand split into two TF32 parts,
except the float32 backward's forward chain, f32 FMAs in a plain GEMM's
order so that its ReLU masks are the f32 twin's (K4's 3xTF32 forward may
differ from that chain by rounding, and so flip a mask where a
pre-activation lies within rounding of 0; the backward follows the twin);
and ``"layered"`` for every wider or deeper stack, as JAX's kernels take
any: one product kernel a layer with the activations in global memory,
rows in chunks that bound the scratch (:data:`LAYERED_SCRATCH_BYTES`);
bf16 on ``wgmma`` (128 x 128 tiles, operands by ``cp.async`` into a ring
of stages; the weights, x and the backward's cotangents as bf16 copies in
the scratch, the bias and ``dhead_dir`` gradients summed from the
unrounded cotangents where they are made), float32 with the chain
(forward and the backward's) as f32 FMAs in a plain GEMM's order and the
backward's other products as 3xTF32 on ``mma.sync``, both from a ring of
stages. :data:`.cuda.launch_counts` counts each route under its own name
(``fused_field_mlps``, ``fused_field_mlps_generic``,
``fused_field_mlps_layered``, ...).

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
    """``t`` rounded to ``dtype`` as a product's operand, back in its own
    dtype: a product of two bf16 operands is exact in f32, so ``a @ b`` of
    them sums exact products in f32. At float32 ``t`` is used as it is, so
    the twins given float64 tensors compute the f32 contract's function
    without rounding (a reference for the float32 kernels)."""
    return t if dtype in (torch.float32, t.dtype) else t.to(dtype).to(t.dtype)


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


# The wgmma route's widths (d_in, hidden): each pair is a template instance
# of csrc/mlp.cu, whose wgmma shapes and register arrays are fixed at
# compile time.
KERNEL_WIDTHS = ((16, 32), (64, 128))
MAX_SMEM_BYTES = 232448  # shared memory one block may use on the H100
MAX_LAYERS = 8  # hidden matrices, n_base + n_head
MAX_WIDTH = 256  # d_in and hidden of the generic route
ROWS_PER_TILE = 64  # rows per warpgroup: wgmma's M
_MAX_FWD_WARPGROUPS = 3
_BWD_WARPGROUPS = 2
_GENERIC_COLS = 64  # output columns of a generic pass, and of a streamed weight slab
_GENERIC_WARPS = 16  # warps of a generic forward block, at most
_GENERIC_BWD_WARPS = 8  # of a backward block
_GENERIC_CHUNKS = 64  # the generic backward's weight-gradient chunks, at most
_LAYERED_ROWS = 128  # output rows of a layered product block: 8 warps of 16
_LAYERED_STAGES = 3  # the layered product blocks' ring of operand stages
# The layered route's scratch for a call's activations and cotangents: rows
# run in chunks of whole rays that fit it (at least one ray a chunk).
LAYERED_SCRATCH_BYTES = 1 << 30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _align(n: int, a: int = 128) -> int:
    return -(-n // a) * a


@dataclass(frozen=True)
class LaunchPlan:
    """How K4/K5 (``backward=False``) or K4b/K5b lay a stack out on the
    card, as ``csrc/mlp.cu``'s ``make_plan`` (``route="wgmma"``),
    ``make_gplan`` (``"generic"``) or ``lay::Stack`` (``"layered"``) does:
    the kernel checks the numbers it is given against its own and refuses a
    mismatch."""

    route: str  # "wgmma", "generic" or "layered"
    rows_per_tile: int  # wgmma: rows of one warpgroup's tile; generic: a
    # block's; layered: a product block's output rows
    warpgroups: int  # wgmma: per block (one block per SM); layered: a bf16
    # product block's wgmma warpgroups (0 in float32); else 0
    stages: int  # wgmma: x stages of a warpgroup with room of their own (0:
    # the stage shares the backward's cotangent staging, no prefetch);
    # layered: a product block's ring of operand stages; else 0
    smem_bytes: int  # dynamic shared memory per block (layered: a product
    # block's)
    ws_floats: int  # one block's weight-gradient workspace row (backward);
    # layered: the scratch beside the chunk's rows (the backward's
    # workspace, then in bfloat16 the weights' bf16 copies)
    aux_tile_floats: int  # the backward's cache: wgmma: masks and head
    # cotangents of a 64-row tile; generic: words a 16 rows (activations,
    # cotangents, ReLU bits, head cotangents), 0 with one phase; layered:
    # scratch floats a row of a chunk (activations, and backward cotangents)
    warps: int = 0  # generic, layered: warps a block, 16 rows each
    resident: bool = False  # generic: the weights stay in shared memory for the launch
    phases: int = 0  # generic backward: 1 (one kernel sums every weight
    # gradient), or the pass over the layers then the phases of
    # weight-gradient chunks that read the cache


def _dtype(compute_dtype) -> torch.dtype:
    dtype = _DTYPES.get(compute_dtype, compute_dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused MLP kernels: compute_dtype {compute_dtype} is neither "
                         "float32 nor bfloat16")
    return dtype


def _workspace_floats(d_in, hidden, layers, n_head):
    """One block's weight-gradient workspace row: every matrix and bias of
    the stack, rounded up to 8 floats."""
    n_w = hidden * d_in + hidden * hidden * (layers - 1) + hidden
    n_w += 3 * hidden if n_head else 0
    n_b = hidden * (layers - (1 if n_head else 0)) + (4 if n_head else 1)
    return n_b, _align(n_w + n_b, 8)


def _wgmma_plan(d_in, hidden, n_base, n_head, backward):
    """The wgmma route's plan, or None where its shared memory cannot hold
    the stack."""
    layers = n_base + n_head
    n_b, ws_floats = _workspace_floats(d_in, hidden, layers, n_head)
    # bf16 weights as core matrices, then the f32 biases, w_d and W_c.
    fixed = sum(_align(hidden * (d_in if k == 0 else hidden) * 2) for k in range(layers))
    fixed += _align((n_b + 4 * hidden) * 4)
    x_stage = _align(ROWS_PER_TILE * d_in * 4)
    # Per row: pre_d's and pre_c's cotangents; per thread: a bit per
    # element of each layer's ReLU mask.
    aux = ROWS_PER_TILE * 4 + layers * -(-(hidden // 2) // 32) * 128
    if not backward:
        for groups in range(_MAX_FWD_WARPGROUPS, 0, -1):
            smem = fixed + groups * x_stage
            if smem <= MAX_SMEM_BYTES:
                return LaunchPlan("wgmma", ROWS_PER_TILE, groups, 1, smem, 0, 0)
        return None
    staging = _align(2 * ROWS_PER_TILE * hidden * 2 + 512)
    staging += _align(2 * ROWS_PER_TILE * max(d_in, hidden) * 2)
    staging += _BWD_WARPGROUPS * _align(aux * 4)
    smem = fixed + staging + _BWD_WARPGROUPS * x_stage
    if smem <= MAX_SMEM_BYTES:
        return LaunchPlan("wgmma", ROWS_PER_TILE, _BWD_WARPGROUPS, 1, smem, ws_floats, aux)
    if (fixed + staging <= MAX_SMEM_BYTES
            and ROWS_PER_TILE * d_in * 4 <= ROWS_PER_TILE * hidden * 2):
        return LaunchPlan("wgmma", ROWS_PER_TILE, _BWD_WARPGROUPS, 0, fixed + staging,
                          ws_floats, aux)
    return None


def _dw_stride(n_in):
    """``dw_stride``: a dW chunk's row stride in floats, 8 past a multiple of
    32 (float2 adds free of bank conflicts)."""
    return _align(n_in, 32) + 8


def _generic_chunks(base, rows, kp, in_dim, hidden, pad, esz, save, wd):
    """``pack_chunks``: the dW chunks, the top matrix first (with ``wd`` the
    density head's w_d before it), as many to a phase as shared memory holds
    beside ``base`` bytes and (with ``save``) each of the phase's matrices'
    input image: ``(phases, the largest phase's bytes)``, None where not
    even one chunk fits."""
    used = top = base
    phase, phases, chunks = set(), 1, 0
    mats = [(len(kp), hidden, 1, 0)] if wd else []
    mats += [(k, in_dim[k], hidden, rows * (kp[k] + pad) * esz if save else 0)
             for k in range(len(kp) - 1, -1, -1)]
    for k, n_in, n_rows, image in mats:
        m = 0
        while m < n_rows:
            need = 0 if k in phase else image
            groups = max(MAX_SMEM_BYTES - used - need, 0) // (16 * _dw_stride(n_in) * 4)
            if not groups:
                if not phase:
                    return None
                phases, used, phase = phases + 1, base, set()
                continue
            if chunks == _GENERIC_CHUNKS:
                return None
            m1 = min(n_rows, m + 16 * groups)
            used += need + -(-(m1 - m) // 16) * 16 * _dw_stride(n_in) * 4
            top = max(top, used)
            phase.add(k)
            chunks, m = chunks + 1, m1
    return phases, top


def _generic_plan(d_in, hidden, n_base, n_head, backward, dtype):
    """The generic route's plan (``make_gplan``): widths padded to 16,
    operands of 2 (bf16) or 4 (f32) bytes with a 16-byte pad a row; warps of
    16 rows; the weights resident in shared memory where they fit, else
    streamed in slabs of 64 columns. The backward sums every weight
    gradient in one pass where they fit beside eight warps' tiles; else the
    forward chain (at the forward's warps) and its pass over the layers
    write a cache (``aux_tile_floats`` words a 16 rows) that phases after
    it read back for the weight gradients."""
    layers = n_base + n_head
    esz = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // esz
    hp, dp = _align(hidden, 16), _align(d_in, 16)
    wp = max(hp, dp)
    kp = [dp] + [hp] * (layers - 1)
    in_dim = [d_in] + [hidden] * (layers - 1)
    heads = 16 * (hp + pad) * esz  # the heads' matrix
    pack = sum(hp * (k + pad) * esz for k in kp) + heads
    slab = max(min(_GENERIC_COLS, hp) * (k + pad) * esz for k in kp)
    img = 16 * (wp + pad) * esz  # a warp's rows of one activation image
    if not backward:
        resident = pack + 4 * 2 * img <= MAX_SMEM_BYTES
        w = pack if resident else slab + heads
        warps = min(_GENERIC_WARPS, (MAX_SMEM_BYTES - w) // (2 * img))
        return LaunchPlan("generic", 16 * warps, 0, 0, w + 2 * warps * img, 0, 0, warps,
                          resident)
    # The backward's slabs of W's columns: [hp][64 + pad], and in float32
    # [64][hp + pad] from the transposed weights.
    slab = max(slab, hp * (_GENERIC_COLS + pad) * esz)
    if esz == 4:
        slab = max(slab, _GENERIC_COLS * (hp + pad) * esz)
    n_b, ws_floats = _workspace_floats(d_in, hidden, layers, n_head)

    def fixed(warps, resident):
        # Weights, two activation images, ReLU bits, the heads' cotangents
        # (f32 and as operands), per-warp column sums (and of the heads'
        # cotangents), bias and head gradients.
        rows = 16 * warps
        out = (pack if resident else slab + heads) + 2 * rows * (wp + pad) * esz
        out += layers * rows * hp // 8 + rows * 16 + rows * (16 + pad) * esz
        return out + 2 * warps * hp * 4 + warps * 16 + _align(n_b, 4) * 4 + 4 * hp * 4

    for resident in (True, False):
        base = fixed(_GENERIC_BWD_WARPS, resident)
        packed = _generic_chunks(base, 16 * _GENERIC_BWD_WARPS, kp, in_dim, hidden, pad, esz,
                                 True, False)
        if packed is not None and packed[0] == 1:
            return LaunchPlan("generic", 16 * _GENERIC_BWD_WARPS, 0, 0, packed[1], ws_floats, 0,
                              _GENERIC_BWD_WARPS, resident, 1)
    for warps in (8, 4, 2, 1):
        for resident in (True, False):
            base = fixed(warps, resident)
            rows = 16 * warps
            # Two images of the tile's rows, transposed: a cotangent and an input.
            packed = _generic_chunks((hp + wp) * (rows + pad) * esz, rows, kp, in_dim, hidden,
                                     pad, esz, False, n_head > 0)
            if base <= MAX_SMEM_BYTES and packed is not None:
                # Per 16 rows: the matrices' inputs and cotangents, the density
                # head's cotangents and a_L as operands, the ReLU bits, the
                # heads' cotangents.
                cache = 4 * esz * (2 * layers * hp + 1) + layers * hp // 2 + 64
                return LaunchPlan("generic", rows, 0, 0, max(base, packed[1]), ws_floats, cache,
                                  warps, resident, 1 + packed[0])
    return None


def _layered_plan(d_in, hidden, n_base, n_head, backward, dtype):
    """The layered route's plan (``tetranerf_fused_mlp_layered_plan``). A
    row of a chunk holds a_1 .. a_L in rows of ``hidden`` padded to 8: in
    bfloat16 as bf16 operands beside x's bf16 copy (d_in padded to 8) and,
    in the backward, two bf16 cotangents and the heads' four f32
    cotangents; in float32 as f32, with two f32 cotangents and the heads'
    four. Beside the rows (``ws_floats``): the backward's workspace, 2^24
    floats or one row of the largest weight gradient and its bias where
    that is more (a weight gradient's rows split in as many parts as it
    holds and as fill the card); then in bfloat16 the weights' bf16 copies
    (each W_k, and for the backward each W_k^T). A product block: bfloat16,
    two warpgroups on a 128 x 128 tile with a ring of three 64-deep stages
    of both operands; float32, eight warps on 128 x 64 with three 32-deep
    stages."""
    layers = n_base + n_head
    ldh, ldx = _align(hidden, 8), _align(d_in, 8)
    ins = [d_in] + [hidden] * (layers - 1)
    ws = max(1 << 24, hidden * max(d_in, hidden, 4) + hidden) if backward else 0
    if dtype == torch.bfloat16:
        row = (layers * ldh + ldx + (2 * ldh if backward else 0)) // 2 + (4 if backward else 0)
        ws += sum(hidden * (ldx if k == 0 else ldh) // 2 + (n * ldh // 2 if backward else 0)
                  for k, n in enumerate(ins))
        # The ring, then the column sums' partials of a cotangent's tile.
        smem = _LAYERED_STAGES * (_LAYERED_ROWS + 128) * 64 * 2 + 8 * 128 * 4
        groups = 2
    else:
        row = layers * ldh + (2 * ldh + 4 if backward else 0)
        smem = _LAYERED_STAGES * (_LAYERED_ROWS + 64) * (32 + 4) * 4
        groups = 0
    return LaunchPlan("layered", _LAYERED_ROWS, groups, _LAYERED_STAGES, smem, ws, row,
                      _LAYERED_ROWS // 16)


def launch_plan(d_in: int, hidden: int, n_base: int, n_head: int, backward: bool,
                compute_dtype=torch.bfloat16) -> LaunchPlan:
    """The launch plan of a fused-MLP kernel for this stack: the wgmma route
    for bfloat16 at its compiled widths where its shared memory holds the
    stack, else the generic route for widths in ``[1, MAX_WIDTH]`` and
    ``n_base + n_head <= MAX_LAYERS``, else the layered route, which takes
    any width and depth, as JAX's kernels do. Raises ``ValueError`` only
    where JAX's kernels cannot run either: a dtype other than float32 or
    bfloat16, a width below 1, ``n_base < 1`` or ``n_head < 0``."""
    dtype = _dtype(compute_dtype)
    if d_in < 1 or hidden < 1:
        raise ValueError(
            f"fused MLP kernels: widths (d_in, hidden) = {(d_in, hidden)}: each must be at "
            f"least 1 (the generic route takes [1, {MAX_WIDTH}], the layered route any wider)")
    if n_base < 1 or n_head < 0:
        raise ValueError(f"fused MLP kernels: n_base={n_base}, n_head={n_head}: "
                         "1 <= n_base and 0 <= n_head")
    if d_in > MAX_WIDTH or hidden > MAX_WIDTH or n_base + n_head > MAX_LAYERS:
        return _layered_plan(d_in, hidden, n_base, n_head, backward, dtype)
    if dtype == torch.bfloat16 and (d_in, hidden) in KERNEL_WIDTHS:
        plan = _wgmma_plan(d_in, hidden, n_base, n_head, backward)
        if plan is not None:
            return plan
    return _generic_plan(d_in, hidden, n_base, n_head, backward, dtype)


def _check(name, x, head_dir, weights, n_base, n_head, compute_dtype):
    """Refuse what K4/K4b/K5/K5b do not take; the launch plan otherwise."""
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
    return launch_plan(d_in, hidden, n_base, n_head, "backward" in name, compute_dtype)


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


def _forward_cuda(counter, plan, x, head_dir, weights, n_base, n_head, dtype):
    num_rays, num_samples, d_in = x.shape
    hidden = weights[0].shape[0]
    dev = x.device
    wpack, bpack = _pack(weights)
    dens = torch.empty((num_rays, num_samples, 1), device=dev)
    rgb = torch.empty((num_rays, num_samples, 3), device=dev) if n_head else None
    if dens.numel():
        args = (cuda.ptr(x), None if head_dir is None else cuda.ptr(head_dir))
        outs = (None if rgb is None else cuda.ptr(rgb), cuda.ptr(dens))
        shape = (num_rays, num_samples, d_in, hidden, n_base, n_head)
        if plan.route == "wgmma":
            cuda.launch(counter, "tetranerf_fused_mlp_forward", dev, *args,
                        cuda.ptr(wpack), cuda.ptr(bpack), *outs, *shape,
                        _num_blocks(dev), plan.warpgroups, plan.smem_bytes)
        elif plan.route == "layered":
            chunk, scratch = _layered_scratch(plan, num_rays, num_samples, dev)
            cuda.launch(f"{counter}_layered", "tetranerf_fused_mlp_forward_layered", dev,
                        *args, cuda.ptr(wpack), cuda.ptr(bpack), *outs, *shape,
                        int(dtype == torch.bfloat16), _num_blocks(dev), chunk,
                        cuda.ptr(scratch), scratch.numel())
        else:
            cuda.launch(f"{counter}_generic", "tetranerf_fused_mlp_forward_generic", dev,
                        *args, cuda.ptr(wpack), cuda.ptr(bpack), *outs, *shape,
                        int(dtype == torch.bfloat16), _num_blocks(dev), plan.rows_per_tile,
                        plan.smem_bytes)
    return rgb, dens


def layered_chunk_rays(plan, num_rays, num_samples):
    """Rays a chunk of the layered route: whole rays, at least one, as few
    chunks as :data:`LAYERED_SCRATCH_BYTES` allows, of equal size but the
    last."""
    per_ray = max(num_samples * plan.aux_tile_floats * 4, 1)
    most = max(1, min(num_rays, LAYERED_SCRATCH_BYTES // per_ray))
    chunks = -(-num_rays // most)
    return max(1, -(-num_rays // chunks))


def _layered_scratch(plan, num_rays, num_samples, dev):
    """``(rays a chunk, the scratch)``: the chunk's rows of
    ``plan.aux_tile_floats`` floats, then ``plan.ws_floats`` (the
    backward's workspace, the bf16 weight copies)."""
    chunk = layered_chunk_rays(plan, num_rays, num_samples)
    floats = chunk * num_samples * plan.aux_tile_floats + plan.ws_floats
    return chunk, torch.empty(floats, device=dev)


def _generic_cache(plan, rows, dev):
    """The generic backward's cache: ``plan.aux_tile_floats`` words for each
    16 rows of the launch's tiles, then room for the weights transposed
    (none with one phase)."""
    if not plan.aux_tile_floats:
        return torch.empty(0, device=dev)
    groups = -(-rows // plan.rows_per_tile) * plan.rows_per_tile // 16
    return torch.empty(groups * plan.aux_tile_floats + plan.ws_floats, device=dev)


def _backward_cuda(counter, plan, x, head_dir, weights, g_rgb, g_dens, n_base,
                   n_head, dtype):
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
    rows = num_rays * num_samples
    grads = torch.empty(wpack.numel() + bpack.numel(), device=dev)
    dx = torch.empty_like(x)
    dhd = torch.zeros((num_rays, hidden), device=dev) if n_head else None
    args = (cuda.ptr(x), None if head_dir is None else cuda.ptr(head_dir))
    shape = (num_rays, num_samples, d_in, hidden, n_base, n_head)
    if plan.route == "layered":
        chunk, scratch = _layered_scratch(plan, num_rays, num_samples, dev)
        cuda.launch(
            f"{counter}_layered", "tetranerf_fused_mlp_backward_layered", dev, *args,
            cuda.ptr(wpack), cuda.ptr(bpack), cuda.ptr(g_rgb) if n_head else None,
            cuda.ptr(g_dens), cuda.ptr(dx), None if dhd is None else cuda.ptr(dhd),
            cuda.ptr(grads), *shape, int(dtype == torch.bfloat16), num_blocks, chunk,
            cuda.ptr(scratch), scratch.numel(),
        )
        return dx, dhd, _unpack(grads, weights)
    # Each block writes its rows' weight gradients into a row of its own.
    ws = torch.empty((num_blocks, plan.ws_floats), device=dev)
    cot = (cuda.ptr(g_rgb) if n_head else None, cuda.ptr(g_dens), cuda.ptr(dx),
           None if dhd is None else cuda.ptr(dhd), cuda.ptr(ws), cuda.ptr(grads))
    if plan.route == "wgmma":
        tiles = 2 * -(-rows // (2 * ROWS_PER_TILE))
        # The tiles' cached masks and head cotangents, then per block each
        # warp's column sums ([8][5H + 4]).
        aux = torch.empty(tiles * plan.aux_tile_floats + num_blocks * 8 * (5 * hidden + 4),
                          device=dev)
        cuda.launch(
            counter, "tetranerf_fused_mlp_backward", dev, *args,
            cuda.ptr(wpack), cuda.ptr(bpack), *cot, cuda.ptr(aux), *shape, num_blocks,
            plan.ws_floats, plan.stages, plan.smem_bytes,
        )
    else:
        aux = _generic_cache(plan, rows, dev)
        cuda.launch(
            f"{counter}_generic", "tetranerf_fused_mlp_backward_generic", dev, *args,
            cuda.ptr(wpack), cuda.ptr(bpack), *cot, cuda.ptr(aux), *shape,
            int(dtype == torch.bfloat16), num_blocks, plan.ws_floats, plan.rows_per_tile,
            plan.phases, plan.aux_tile_floats, plan.smem_bytes,
        )
    return dx, dhd, _unpack(grads, weights)


def _on(name, x):
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def fused_field_mlps(x, head_dir, weights, n_base, n_head, compute_dtype):
    """K4 on CUDA tensors (the plan's route), :func:`fused_field_mlps_twin`
    on CPU tensors."""
    if _on("fused_field_mlps", x):
        plan = _check("fused_field_mlps", x, head_dir, weights, n_base, n_head,
                      compute_dtype)
        return _forward_cuda("fused_field_mlps", plan, x, head_dir, weights,
                             n_base, n_head, _dtype(compute_dtype))
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
                              weights, g_rgb, g_dens, n_base, n_head,
                              _dtype(compute_dtype))
    return fused_field_mlps_backward_twin(x, head_dir, weights, g_rgb, g_dens,
                                          n_base, n_head, compute_dtype)


def fused_density_mlp(x, weights, n_base, compute_dtype):
    """K5 on CUDA tensors, :func:`fused_density_mlp_twin` on CPU tensors."""
    if _on("fused_density_mlp", x):
        plan = _check("fused_density_mlp", x, None, weights, n_base, 0,
                      compute_dtype)
        return _forward_cuda("fused_density_mlp", plan, x, None, weights, n_base,
                             0, _dtype(compute_dtype))[1]
    return fused_density_mlp_twin(x, weights, n_base, compute_dtype)


def fused_density_mlp_backward(x, weights, g_dens, n_base, compute_dtype):
    """K5b on CUDA tensors, :func:`fused_density_mlp_backward_twin` on CPU
    tensors."""
    if _on("fused_density_mlp_backward", x):
        plan = _check("fused_density_mlp_backward", x, None, weights, n_base, 0,
                      compute_dtype)
        dx, _, grads = _backward_cuda("fused_density_mlp_backward", plan, x, None,
                                      weights, None, g_dens, n_base, 0,
                                      _dtype(compute_dtype))
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
