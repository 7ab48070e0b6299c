#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tetranerf_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card's ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build of the CUDA kernels from ``tetranerf_torch/csrc`` (one nvcc per
   source, side by side);
3. K1 march, K2 stream blend and K3 sample interp against their plain
   PyTorch twins on the card, at the render slice's shapes on the
   100K-point sphere scene (8192 rays, T=512 march slots, S=257 fine
   samples): max abs error against the stated tolerance, median CUDA-event
   times of both, the least time the card could take (bytes over HBM rate
   or operations over the f32 rate, from this run's data);
4. K1 on ``tests/assets/golden_march.npz`` (exact cells, t within 1e-5);
5. the render path: the ``tetra-nerf`` preset (``ray_buckets=1``, seeded
   random weights with point colours, a synthetic occupancy column), 4
   requests of 65,536 rays through ``Renderer.render_rays`` at chunk 8192,
   with the kernels' launch counts, and the outputs checked: finite, rgb in
   [0, 1], and equal within tolerance to the same render on the CPU, where
   every kernel runs as its twin;
6. the backward kernels K2b, K3b and K7 against their twins at the train
   slice's shapes (4096 rays, the cold march at T=512, S=257, F=64, the
   scene's 100K vertices), with K7 beside ``index_add_`` (``library_ms``);
7. the train path: ``Trainer.train_step`` on the same preset, 65 steps on
   five batches of 4096 rays in turn, with targets from
   ``sphere_ray_targets`` (the traversal probe,
   occupancy updates at steps 0, 16, 32, 48 and 64, the refresh at 64):
   every loss finite, the mean loss of the last 5 steps below the first 5,
   every kernel launched; the median step time and rays/s; a
   ``torch.profiler`` breakdown of two steady steps; then one step's loss
   and field gradient on 256 rays with injected random numbers, on the card
   and on the CPU twins;
8. the fused MLP kernels K4, K4b (field MLPs forward and backward), K5 and
   K5b (density MLP) against their twins on the card at the train slice's
   shapes (4096 rays; 257 samples for K4/K4b, 128 for K5/K5b) with the
   preset's seeded weights, beside the un-fused plain-torch stack on the
   same inputs (``unfused_ms``);
9. the fused render: phase 5 with ``fused_mlps=True`` (K4 and K5 must
   launch);
10. the fused train run: phase 7 with ``fused_mlps=True`` (K4, K4b and K5
    must launch).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NUM_POINTS = 100_000
CHUNK = 8192
REQUESTS = 4
REQUEST_RAYS = 65_536
TRAIN_RAYS = 4096
TRAIN_STEPS = 65
TRAIN_BATCHES = 5
REF_RAYS = 256
# Kernel vs twin. K1-K3 and K2b/K3b sum a handful of f32 products per
# output, in another order (and with FMA contraction) than the twin: 1e-5
# on outputs of order 1 (forward) or 10 (the transposes add up to ~20
# terms, so 1e-4). K7's float atomics add each vertex row in a run-
# dependent order.
TOLERANCES = {
    "march": 1e-5, "stream_blend_gather": 1e-5, "sample_interp": 1e-5,
    "stream_blend_backward": 1e-4, "sample_interp_backward": 1e-4,
    "scatter_add_rows": 1e-4,
}
# The fused MLP kernels vs their twins, both in bf16. Sums of exact
# products in another order (WMMA tiles vs cuBLAS f32) round a bf16
# activation or cotangent one ulp (2^-8) the other way now and then, and
# put a pre-activation within an ulp of 0 on the other side of a ReLU:
# that moves the rows downstream of it, and a ReLU flip moves an entry of
# dx by one whole term of its sum (several % of the largest entry at 1M
# rows). So each output is held to 1e-2 in relative Frobenius norm, and
# its max abs error to 0.1 of its largest entry.
MLP_NORM_RTOL = 1e-2
MLP_MAX_RTOL = 0.1
# bf16 MLP GEMMs round differently in cuBLAS and on the CPU.
RENDER_RGB_TOL = 2e-2
# The train step on the card vs the CPU twins, relative to the CPU value
# (the field gradient: to its largest entry). bf16 GEMMs in cuBLAS and on
# the CPU round differently, in the backward too, and K7 adds in atomic
# order.
REF_LOSS_RTOL = 1e-3
REF_GRAD_RTOL = 5e-2
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 dense FLOP/s on the tensor cores (the
# fused MLP kernels' products).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
_PEAKS = {F32_FLOPS: "f32 outside the tensor cores, 67 TFLOP/s",
          BF16_TENSOR_FLOPS: "bf16 dense on the tensor cores, 989 TFLOP/s"}


def _time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _max_err(a, b, finite_only=False):
    import torch

    a, b = a.double(), b.double()
    if finite_only:
        same_inf = torch.equal(torch.isfinite(a), torch.isfinite(b))
        if not same_inf:
            return float("inf")
        keep = torch.isfinite(b)
        a, b = a[keep], b[keep]
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max())


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _bound(num_bytes, num_ops, flops=F32_FLOPS):
    """Least time on the card: bytes over the HBM rate or operations over
    the ``flops`` rate, whichever is larger; ``bound_peak`` names the peak
    that sets it."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = num_ops / flops * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes", bound_peak="HBM, 3.35 TB/s")
    return dict(bound_ms=t_ops, bound_by="operations", bound_peak=_PEAKS[flops])


def _entry(name, source, replaces, err, ms, plain_ms, bound, library_ms=None,
           **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound, **extra)


def synthetic_occupancy(mesh_cpu):
    """Density 200 in cells whose centroid lies outside radius 0.9 (the
    scene's surface shell), 0 inside: a ray entering the shell passes the
    depth cap -log(1e-4) within about 0.05 of travel and stops."""
    import torch

    centroids = mesh_cpu.vertices[mesh_cpu.cells.long()].mean(dim=1)
    return torch.where(centroids.norm(dim=1) > 0.9, 200.0, 0.0)


def kernel_checks(mesh, field, origins, directions):
    """Phase 3: each forward kernel against its twin on the card."""
    import torch
    from tetranerf_torch.ops import fused, interp
    from tetranerf_torch.ops.march import (
        march, march_intervals, march_intervals_twin,
    )
    from tetranerf_torch.ops.traversal import hull_intersect

    results = []
    num_rays = origins.shape[0]
    t_in, t_out, facet, hit = hull_intersect(mesh.hull_eqs, origins, directions)
    args = (mesh.march_table, mesh.hull_cells, origins, directions, t_in,
            t_out, facet, hit, 512, 512, 16, True, float(-np.log(1e-4)))
    ker = march_intervals(*args)
    twin = march_intervals_twin(*args)
    for name in ("cells", "pos", "new_vid", "vids0", "hit", "done"):
        _check(torch.equal(getattr(ker, name), getattr(twin, name)),
               f"march: {name} differs from the twin")
    err = max(
        _max_err(ker.t0, twin.t0, True), _max_err(ker.t1, twin.t1, True),
        _max_err(ker.bary_exit, twin.bary_exit),
        _max_err(ker.t_entry[ker.hit], twin.t_entry[twin.hit]),
        _max_err(ker.bary_entry[ker.hit], twin.bary_entry[twin.hit]),
    )
    _check(err <= TOLERANCES["march"], f"march: max abs err {err}")
    # Without occupancy the rays cross the whole ball: long marches.
    args_long = args[:11] + (False, 0.0)
    ker_long = march_intervals(*args_long)
    twin_long = march_intervals_twin(*args_long)
    _check(torch.equal(ker_long.cells, twin_long.cells),
           "march (no occupancy): cells differ from the twin")
    err = max(err, _max_err(ker_long.t1, twin_long.t1, True))
    _check(err <= TOLERANCES["march"], f"march: max abs err {err}")
    nv = (ker_long.cells >= 0).sum(dim=1).float()
    print(f"march: cells exact; t/bary max abs err {err:.3g}; "
          f"intervals per ray {float((ker.cells >= 0).sum(1).float().mean()):.1f} "
          f"(occupancy), {float(nv.mean()):.1f} mean / {int(nv.max())} max "
          f"(none)")
    # Per emitted step: one 256-byte table row read, 48 bytes of interval
    # written (cells, t0, t1, new_vid, 4 barys, 4 positions), ~80 flops of
    # plane arithmetic; per ray 37 bytes in and 38 out.
    steps = int((ker.cells >= 0).sum()) + int(ker.hit.sum())
    results.append(_entry(
        "march", "tetranerf_torch/csrc/march.cu", "tetranerf_tpu/ops/fused.py:125",
        err, _time_ms(lambda: march_intervals(*args), 10),
        _time_ms(lambda: march_intervals_twin(*args), 3),
        _bound(steps * (256 + 48) + num_rays * 75, steps * 80),
    ))

    res = march(mesh, origins, directions, 512, use_occupancy=True,
                occ_threshold=1e-4)
    s = res.stream
    blend_args = (field, s.vids.contiguous(), s.pos.contiguous(),
                  s.bary.contiguous())
    out_k = interp.stream_blend_gather(*blend_args)
    out_t = interp.stream_blend_gather_twin(*blend_args)
    err = _max_err(out_k, out_t)
    _check(err <= TOLERANCES["stream_blend_gather"],
           f"stream_blend_gather: max abs err {err}")
    print(f"stream_blend_gather: out {tuple(out_k.shape)}, max abs err {err:.3g}")
    num_end, num_feat = out_k.shape[1:]
    weighted = int((s.bary != 0).any(dim=-1).sum())
    results.append(_entry(
        "stream_blend_gather", "tetranerf_torch/csrc/blend.cu",
        "tetranerf_tpu/ops/pallas_interp.py:214", err,
        _time_ms(lambda: interp.stream_blend_gather(*blend_args), 10),
        _time_ms(lambda: interp.stream_blend_gather_twin(*blend_args), 3),
        # The output, pos + bary, the stream ids, the field once.
        _bound(out_k.numel() * 4 + num_rays * num_end * 32 + s.vids.numel() * 4
               + field.numel() * 4, weighted * 4 * num_feat * 2),
    ))
    del out_t

    res = res._replace(feats=out_k)
    nears, fars, _, _, ray_mask = fused.ray_bounds(res)
    edges = torch.linspace(0.0, 1.0, 258, device=origins.device)
    edges = nears[:, None] + edges[None, :] * (fars - nears)[:, None]
    distances = ((edges[:, 1:] + edges[:, :-1]) / 2.0).contiguous()
    interp_args = (res.t0.contiguous(), res.t1, res.num_valid, ray_mask,
                   distances, out_k)
    f_k, m_k = interp.sample_interp(*interp_args)
    f_t, m_t = interp.sample_interp_twin(*interp_args)
    _check(torch.equal(m_k, m_t), "sample_interp: mask differs from the twin")
    err = _max_err(f_k, f_t)
    _check(err <= TOLERANCES["sample_interp"], f"sample_interp: max abs err {err}")
    print(f"sample_interp: out {tuple(f_k.shape)}, valid samples "
          f"{float(m_k.float().mean()):.3f}, max abs err {err:.3g}")
    rows = _endpoint_rows_read(*interp_args[:5])
    max_t = res.t1.shape[1]
    results.append(_entry(
        "sample_interp", "tetranerf_torch/csrc/interp.cu",
        "tetranerf_tpu/ops/pallas_interp.py:104", err,
        _time_ms(lambda: interp.sample_interp(*interp_args), 10),
        _time_ms(lambda: interp.sample_interp_twin(*interp_args), 3),
        # Output + mask, distances, t0/t1, the endpoint rows kept samples read.
        _bound(f_k.numel() * 4 + m_k.numel() * 5 + num_rays * max_t * 8
               + rows * num_feat * 4, int(m_k.sum()) * num_feat * 3),
    ))
    return results


def _endpoint_rows_read(t0, t1, num_valid, ray_mask, distances):
    """Distinct endpoint rows (ray, k) and (ray, k+1) of the kept samples."""
    import torch
    from tetranerf_torch.ops.interp import _match

    k_c, _, mask = _match(t0, t1, num_valid, ray_mask, distances)
    ray = torch.arange(k_c.shape[0], device=k_c.device)[:, None] * (t1.shape[1] + 1)
    keys = (ray + k_c)[mask]
    return int(torch.cat([keys, keys + 1]).unique().numel())


def backward_checks(mesh, origins, directions):
    """Phase 6: the backward kernels against their twins at the train
    slice's shapes: the cold march (no occupancy, T=512), S=257, F=64."""
    import torch
    from tetranerf_torch.ops import fused, interp, scatter
    from tetranerf_torch.ops.march import march

    dev = origins.device
    num_rays, num_feat, num_v = origins.shape[0], 64, mesh.num_vertices
    gen = torch.Generator(device=dev).manual_seed(6)
    res = march(mesh, origins, directions, 512)
    s = res.stream
    num_end, num_stream = s.pos.shape[1], s.vids.shape[1]
    results = []

    g_end = torch.randn((num_rays, num_end, num_feat), generator=gen, device=dev)
    bwd_args = (g_end, s.pos.contiguous(), s.bary.contiguous(), num_stream)
    gsf = interp.stream_blend_backward(*bwd_args)
    err = _max_err(gsf, interp.stream_blend_backward_twin(*bwd_args))
    _check(err <= TOLERANCES["stream_blend_backward"],
           f"stream_blend_backward: max abs err {err}")
    weighted = (s.bary != 0).any(dim=-1)
    n_w = int(weighted.sum())
    print(f"stream_blend_backward: out {tuple(gsf.shape)}, weighted endpoints "
          f"{n_w / num_rays:.1f} per ray, max abs err {err:.3g}")
    results.append(_entry(
        "stream_blend_backward", "tetranerf_torch/csrc/blend.cu",
        "tetranerf_tpu/ops/pallas_interp.py:257", err,
        _time_ms(lambda: interp.stream_blend_backward(*bwd_args), 10),
        _time_ms(lambda: interp.stream_blend_backward_twin(*bwd_args), 3),
        # Output, all bary rows, pos + g rows of the weighted endpoints.
        _bound(gsf.numel() * 4 + num_rays * num_end * 16
               + n_w * (16 + num_feat * 4), int((s.bary != 0).sum()) * num_feat * 2),
    ))

    idx = s.vids.reshape(-1).clamp_min(0).contiguous()
    vals = gsf.reshape(-1, num_feat)
    out = scatter.scatter_add_rows(idx, vals, num_v)
    err = _max_err(out, scatter.scatter_add_rows_twin(idx, vals, num_v))
    _check(err <= TOLERANCES["scatter_add_rows"], f"scatter_add_rows: max abs err {err}")
    nonzero = int((vals != 0).sum())
    print(f"scatter_add_rows: {idx.numel()} rows into {tuple(out.shape)}, "
          f"nonzero elements {nonzero / vals.numel():.3f}, max abs err {err:.3g}")
    idx_long = idx.long()
    results.append(_entry(
        "scatter_add_rows", "tetranerf_torch/csrc/scatter.cu",
        "tetranerf_tpu/ops/pallas_scatter.py:105", err,
        _time_ms(lambda: scatter.scatter_add_rows(idx, vals, num_v), 10),
        _time_ms(lambda: scatter.scatter_add_rows_twin(idx, vals, num_v), 3),
        _bound(idx.numel() * 4 + vals.numel() * 4 + out.numel() * 4, nonzero),
        library_ms=_time_ms(
            lambda: torch.zeros((num_v, num_feat), device=dev).index_add_(
                0, idx_long, vals), 10),
    ))
    del gsf, vals, out

    nears, fars, _, _, ray_mask = fused.ray_bounds(res)
    edges = torch.linspace(0.0, 1.0, 258, device=dev)
    edges = nears[:, None] + edges[None, :] * (fars - nears)[:, None]
    distances = ((edges[:, 1:] + edges[:, :-1]) / 2.0).contiguous()
    i_args = (res.t0.contiguous(), res.t1.contiguous(), res.num_valid, ray_mask,
              distances)
    g_samp = torch.randn((num_rays, 257, num_feat), generator=gen, device=dev)
    gf = interp.sample_interp_backward(*i_args, g_samp)
    err = _max_err(gf, interp.sample_interp_backward_twin(*i_args, g_samp))
    _check(err <= TOLERANCES["sample_interp_backward"],
           f"sample_interp_backward: max abs err {err}")
    kept = int(interp._match(*i_args)[2].sum())
    max_t = res.t1.shape[1]
    print(f"sample_interp_backward: out {tuple(gf.shape)}, kept samples "
          f"{kept / distances.numel():.3f}, max abs err {err:.3g}")
    results.append(_entry(
        "sample_interp_backward", "tetranerf_torch/csrc/interp.cu",
        "tetranerf_tpu/ops/pallas_interp.py:141", err,
        _time_ms(lambda: interp.sample_interp_backward(*i_args, g_samp), 10),
        _time_ms(lambda: interp.sample_interp_backward_twin(*i_args, g_samp), 3),
        # Output, g rows of the kept samples, distances, t0/t1.
        _bound(gf.numel() * 4 + kept * num_feat * 4 + distances.numel() * 4
               + num_rays * max_t * 8, kept * num_feat * 4),
    ))
    return results


def _rel_check(name, pairs):
    """Max abs error over (kernel, twin) pairs, each held to MLP_NORM_RTOL
    and MLP_MAX_RTOL."""
    err = 0.0
    for i, (k, t) in enumerate(pairs):
        e = _max_err(k, t)
        scale = float(t.abs().max())
        diff = (k.double() - t.double())
        norm_err = float(diff.norm() / t.double().norm().clamp_min(1e-30))
        far = int((diff.abs() > 1e-2 * scale).sum())
        print(f"  {name} output {i} {tuple(t.shape)}: max abs err {e:.3g} of largest "
              f"{scale:.3g}, relative norm err {norm_err:.3g}, {far} entries off "
              f"by more than 1% of the largest")
        _check(norm_err <= MLP_NORM_RTOL, f"{name}: output {i}: norm err {norm_err}")
        _check(e <= MLP_MAX_RTOL * max(scale, 1e-30),
               f"{name}: output {i}: max abs err {e} against largest entry {scale}")
        err = max(err, e)
    return err


def mlp_checks(model, dev):
    """Phase 8: K4, K4b, K5 and K5b against their twins on the card at the
    train slice's shapes, with the preset's seeded weights and features,
    directions and cotangents from a seeded generator. ``unfused_ms`` times
    the plain-torch MLP stack of ``fused_mlps=False`` on the same inputs:
    ``field_mlps`` (K4) and its autograd backward (K4b), ``density_at`` (K5)
    and its autograd backward (K5b)."""
    import torch
    from tetranerf_torch.models import TetraNerf
    from tetranerf_torch.ops import mlp

    cfg = model.config
    plain = TetraNerf(dataclasses.replace(cfg, fused_mlps=False),
                      model.tetrahedra_field.shape[0], device=dev)
    plain.load_state_dict(model.state_dict())
    params = [p for n, p in plain.named_parameters() if n != "tetrahedra_field"]
    gen = torch.Generator(device=dev).manual_seed(8)
    num_fine = cfg.num_samples + cfg.num_fine_samples + 1
    dt = model.compute_dtype
    n_base, n_head = len(model.mlp_base.layers), len(model.mlp_head.layers)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(TRAIN_RAYS, num_fine, cfg.field_dim)
    d = torch.nn.functional.normalize(randn(TRAIN_RAYS, 3), dim=1)
    g_rgb, g_dens = randn(TRAIN_RAYS, num_fine, 3), randn(TRAIN_RAYS, num_fine, 1)
    x_c = randn(TRAIN_RAYS, cfg.num_samples, cfg.field_dim)
    g_c = randn(TRAIN_RAYS, cfg.num_samples, 1)
    with torch.no_grad():
        head_dir, weights = model.fused_field_inputs(d)
        weights = [w.detach() for w in weights]
        w_dens = [w.detach() for w in model.density_weights()]
    results = []

    def entry(name, replaces, err, ms, plain_ms, unfused_ms, num_bytes, num_ops):
        print(f"{name}: max abs err {err:.3g}; {ms:.3f} ms, twin {plain_ms:.3f} ms, "
              f"un-fused stack {unfused_ms:.3f} ms")
        results.append(_entry(
            name, "tetranerf_torch/csrc/mlp.cu", replaces, err, ms, plain_ms,
            _bound(num_bytes, num_ops, BF16_TENSOR_FLOPS), unfused_ms=unfused_ms))

    def unfused_backward(fn, x_in, grads):
        """Time of the autograd backward alone of ``fn(x_in)`` (its
        forward recorded once, the graph kept)."""
        xg = x_in.clone().requires_grad_()
        outs = fn(xg)
        return _time_ms(lambda: torch.autograd.grad(
            outs, [xg, *params], grads, retain_graph=True, allow_unused=True), 5)

    # K4 / K4b: the field MLPs at 4096 x 257 rows.
    rows = x.shape[0] * x.shape[1]
    macs = sum(w.numel() for w in weights if w.dim() == 2)  # per row
    param_bytes = sum(w.numel() for w in weights) * 4
    fwd = (x, head_dir, weights, n_base, n_head, dt)
    err = _rel_check("fused_field_mlps", zip(mlp.fused_field_mlps(*fwd),
                                             mlp.fused_field_mlps_twin(*fwd)))
    with torch.no_grad():
        unfused = _time_ms(lambda: plain.field_mlps(x, d), 10)
    entry("fused_field_mlps", "tetranerf_tpu/ops/pallas_mlp.py:244", err,
          _time_ms(lambda: mlp.fused_field_mlps(*fwd), 10),
          _time_ms(lambda: mlp.fused_field_mlps_twin(*fwd), 3), unfused,
          x.numel() * 4 + head_dir.numel() * 4 + param_bytes + rows * 16,
          2 * macs * rows)
    bwd = (x, head_dir, weights, g_rgb, g_dens, n_base, n_head, dt)
    dx, dhd, grads = mlp.fused_field_mlps_backward(*bwd)
    dx_t, dhd_t, grads_t = mlp.fused_field_mlps_backward_twin(*bwd)
    err = _rel_check("fused_field_mlps_backward",
                     [(dx, dx_t), (dhd, dhd_t), *zip(grads, grads_t)])
    del dx, dhd, grads, dx_t, dhd_t, grads_t
    # Recompute, the cotangents through every layer, every weight gradient.
    entry("fused_field_mlps_backward", "tetranerf_tpu/ops/pallas_mlp.py:290", err,
          _time_ms(lambda: mlp.fused_field_mlps_backward(*bwd), 10),
          _time_ms(lambda: mlp.fused_field_mlps_backward_twin(*bwd), 3),
          unfused_backward(lambda xg: plain.field_mlps(xg, d), x,
                           (g_rgb, g_dens[..., 0])),
          2 * x.numel() * 4 + 2 * head_dir.numel() * 4 + 2 * param_bytes
          + rows * 16, 6 * macs * rows)

    # K5 / K5b: the density MLP at 4096 x 128 rows (the coarse round).
    rows = x_c.shape[0] * x_c.shape[1]
    macs = sum(w.numel() for w in w_dens if w.dim() == 2)
    param_bytes = sum(w.numel() for w in w_dens) * 4
    fwd = (x_c, w_dens, n_base, dt)
    err = _rel_check("fused_density_mlp", [(mlp.fused_density_mlp(*fwd),
                                           mlp.fused_density_mlp_twin(*fwd))])
    with torch.no_grad():
        unfused = _time_ms(lambda: plain.density_at(x_c), 10)
    entry("fused_density_mlp", "tetranerf_tpu/ops/pallas_mlp.py:415", err,
          _time_ms(lambda: mlp.fused_density_mlp(*fwd), 10),
          _time_ms(lambda: mlp.fused_density_mlp_twin(*fwd), 3), unfused,
          x_c.numel() * 4 + param_bytes + rows * 4, 2 * macs * rows)
    bwd = (x_c, w_dens, g_c, n_base, dt)
    dx, grads = mlp.fused_density_mlp_backward(*bwd)
    dx_t, grads_t = mlp.fused_density_mlp_backward_twin(*bwd)
    err = _rel_check("fused_density_mlp_backward", [(dx, dx_t), *zip(grads, grads_t)])
    del dx, grads, dx_t, grads_t
    entry("fused_density_mlp_backward", "tetranerf_tpu/ops/pallas_mlp.py:448", err,
          _time_ms(lambda: mlp.fused_density_mlp_backward(*bwd), 10),
          _time_ms(lambda: mlp.fused_density_mlp_backward_twin(*bwd), 3),
          unfused_backward(plain.density_at, x_c, g_c[..., 0]),
          2 * x_c.numel() * 4 + 2 * param_bytes + rows * 4, 6 * macs * rows)
    del plain
    return results


def golden_check(device):
    """Phase 4: the golden march trace through K1."""
    import torch
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.ops import cuda, march

    with np.load(ROOT / "tests" / "assets" / "golden_march.npz") as data:
        g = {k: data[k] for k in data.files}
    mesh = build_mesh(g["points"], device=device)
    before = cuda.launch_counts["march"]
    res = march(mesh, torch.from_numpy(g["origins"]).to(device),
                torch.from_numpy(g["directions"]).to(device), max_steps=96)
    _check(cuda.launch_counts["march"] == before + 1, "golden: K1 did not run")
    num = g["num_cells"]
    _check(np.array_equal(res.num_valid.cpu().numpy(), num), "golden: num_cells")
    cells, t0, t1 = (x.cpu().numpy() for x in (res.cells, res.t0, res.t1))
    err = 0.0
    for r, n in enumerate(num):
        _check(np.array_equal(cells[r, :n], g["cells"][r, :n]),
               f"golden: cells of ray {r}")
        err = max(err, float(np.abs(t0[r, :n] - g["t0"][r, :n]).max(initial=0)),
                  float(np.abs(t1[r, :n] - g["t1"][r, :n]).max(initial=0)))
    _check(err <= 1e-5, f"golden: t max abs err {err}")
    print(f"golden trace: {len(num)} rays, cells exact, t max abs err {err:.3g}")


RENDER_KERNELS = ("march", "stream_blend_gather", "sample_interp")
FUSED_RENDER_KERNELS = RENDER_KERNELS + ("fused_field_mlps", "fused_density_mlp")
TRAIN_KERNELS = RENDER_KERNELS + ("stream_blend_backward", "sample_interp_backward",
                                  "scatter_add_rows")
FUSED_TRAIN_KERNELS = TRAIN_KERNELS + ("fused_field_mlps", "fused_field_mlps_backward",
                                       "fused_density_mlp")


def render_phase(model, mesh, mesh_cpu, dev, must_launch=RENDER_KERNELS):
    """Phases 5 and 9: the render path, and 256 of its rays on the CPU
    twins. Every kernel of ``must_launch`` must launch. Returns the
    kernels' launch counts of the four requests."""
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.render import Renderer
    from tetranerf_torch.utils.synthetic import sample_sphere_rays
    import torch

    model_cpu = copy.deepcopy(model)
    renderer = Renderer(model, mesh, dev)
    origins, directions = sample_sphere_rays(
        np.random.default_rng(0), REQUESTS * REQUEST_RAYS
    )
    renderer.render_rays(origins[:CHUNK], directions[:CHUNK], chunk=CHUNK)  # warm-up
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t = time.perf_counter()
    outs = []
    for i in range(REQUESTS):
        sl = slice(i * REQUEST_RAYS, (i + 1) * REQUEST_RAYS)
        outs.append(renderer.render_rays(origins[sl], directions[sl], chunk=CHUNK))
    seconds = time.perf_counter() - t
    launches = dict(cuda.launch_counts)
    out = {k: np.concatenate([o_[k] for o_ in outs]) for k in outs[0]}
    label = "render (fused MLPs)" if model.config.fused_mlps else "render"
    print(f"{label}: {REQUESTS} x {REQUEST_RAYS} rays in {seconds:.3f} s = "
          f"{REQUESTS * REQUEST_RAYS / seconds:.0f} rays/s; "
          f"overflow {int(out['traversal_overflow'].sum())}, "
          f"hit {int(out['ray_mask'].sum())}, launches {launches}")
    for k in must_launch:
        _check(launches[k] > 0, f"{label}: {k} did not launch: {launches}")
    for k in ("rgb", "depth", "accumulation"):
        _check(np.isfinite(out[k]).all(), f"render: non-finite {k}")
    _check(out["rgb"].shape == (REQUESTS * REQUEST_RAYS, 3), "render: rgb shape")
    _check(out["rgb"].min() >= 0.0 and out["rgb"].max() <= 1.0, "render: rgb range")

    ref = Renderer(model_cpu, mesh_cpu, "cpu").render_rays(
        origins[:REF_RAYS], directions[:REF_RAYS], chunk=REF_RAYS
    )
    _check(np.array_equal(ref["ray_mask"], out["ray_mask"][:REF_RAYS]), "ref: ray_mask")
    _check(np.array_equal(ref["traversal_overflow"],
                          out["traversal_overflow"][:REF_RAYS]), "ref: overflow")
    rgb_err = float(np.abs(ref["rgb"] - out["rgb"][:REF_RAYS]).max())
    _check(rgb_err <= RENDER_RGB_TOL, f"ref: rgb max abs err {rgb_err}")
    print(f"{label} vs CPU twins ({REF_RAYS} rays): rgb max abs err {rgb_err:.3g}")
    return launches


def _train_batch(rng, num_rays):
    from tetranerf_torch.utils.synthetic import sample_sphere_rays, sphere_ray_targets

    o, d = sample_sphere_rays(rng, num_rays)
    return {"origins": o, "directions": d, "rgb": sphere_ray_targets(o, d)}


def _loss_and_field_grad(model, mesh, trainer, batch, uniforms, device):
    import torch

    model.zero_grad(set_to_none=True)
    out = model.get_outputs(
        torch.as_tensor(batch["origins"], device=device),
        torch.as_tensor(batch["directions"], device=device), mesh,
        max_steps=trainer.max_steps, occ_depth_cap=trainer.occ_depth_cap,
        train=True, uniforms=uniforms,
    )
    loss = model.loss(out, torch.as_tensor(batch["rgb"], device=device))
    loss.backward()
    return float(loss.detach()), model.tetrahedra_field.grad.cpu()


def _saved_bytes(trainer, batch, device):
    """Bytes of the tensors autograd keeps for the backward of one train
    forward (parameters excluded: they exist anyway)."""
    import torch

    params = {p.untyped_storage().data_ptr() for p in trainer.model.parameters()}
    kept = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in params:
            kept[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        trainer.model.get_outputs(
            torch.as_tensor(batch["origins"], device=device),
            torch.as_tensor(batch["directions"], device=device), trainer.mesh,
            max_steps=trainer.max_steps, occ_depth_cap=trainer.occ_depth_cap,
            train=True,
        )
    return sum(kept.values())


def _profile_steps(trainer, batches, median_ms):
    """Device time by kernel over ``batches`` train steps, and the share of
    the time in which the card ran no kernel: within the profiled window
    (the profiler's own host work slows the launches there) and against
    the unprofiled median step ``median_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches:
            trainer.train_step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device events: not measured")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    print(f"profile: {len(batches)} steps, wall {wall_us / 1e3:.2f} ms, kernels "
          f"busy {busy / 1e3:.2f} ms of the {(end - start) / 1e3:.2f} ms from first "
          f"to last kernel (idle share {1 - busy / (end - start):.3f}; "
          f"{1 - busy / wall_us:.3f} of the wall window); against the "
          f"unprofiled median step {median_ms:.2f} ms the idle share is "
          f"{1 - busy / 1e3 / len(batches) / median_ms:.3f}")
    groups = {}
    for name, us in by_name.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + us
    print("profile by group (ms/step): " + ", ".join(
        f"{g} {us / 1e3 / len(batches):.3f}"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / len(batches):8.3f} ms/step  {name[:110]}")


_PORT_KERNELS = ("march_kernel", "blend_kernel", "blend_bwd_kernel",
                 "interp_kernel", "interp_bwd_kernel", "scatter_add_kernel",
                 "mlp_fwd_kernel", "mlp_bwd_kernel", "sum_rows_kernel")


def _kernel_group(name):
    if "(anonymous namespace)::" in name and name.split("::")[1].split("(")[0] in _PORT_KERNELS:
        return "port kernels"
    lower = name.lower()
    if "gemm" in lower or "nvjet" in lower or "gemv" in lower:
        return "GEMM"
    if "reduce_kernel" in name:
        return "reductions"
    if "copy" in lower or "catarray" in lower:
        return "copies/casts/concat"
    if "elementwise" in lower:
        return "elementwise"
    return "other"


def train_phase(colors, mesh_plain, dev, fused=False):
    """Phases 7 and 10: the train path, with the fused MLP kernels when
    ``fused``. Returns the kernels' launch counts of the 65 steps and of
    step 1 alone (a steady step: no occupancy work)."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    cfg = tetranerf_preset(ray_buckets=1, fused_mlps=fused)
    label = "train (fused MLPs)" if fused else "train"
    model = TetraNerf(cfg, mesh_plain.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(TrainConfig(), model, mesh_plain, device=dev)
    # Five batches in turn: steps 0-4 and 60-64 see the same rays, so the
    # loss comparison is free of batch-to-batch noise.
    rng = np.random.default_rng(1)
    batches = [_train_batch(rng, TRAIN_RAYS) for _ in range(TRAIN_BATCHES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    losses, overflow, step_ms = [], [], []
    for step in range(TRAIN_STEPS):
        b = batches[step % TRAIN_BATCHES]
        before = dict(cuda.launch_counts)
        t = time.perf_counter()
        m = trainer.train_step(b)
        losses.append(float(m["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        overflow.append(int(m["overflow_rays"]))
        if step == 1:
            per_step = {k: n - before[k] for k, n in cuda.launch_counts.items()}
    launches = dict(cuda.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    med = float(np.median(step_ms[1:]))
    every = cfg.occupancy_update_every
    print(f"{label}: {TRAIN_STEPS} steps of {TRAIN_RAYS} rays, tuned bound "
          f"{trainer.max_steps}, median step {med:.2f} ms (steps 1-{TRAIN_STEPS - 1}) "
          f"= {TRAIN_RAYS / med * 1e3:.0f} rays/s trained; ms of the steps with "
          f"occupancy work (0: probe + update, every {every}: update, "
          f"{cfg.occupancy_refresh_every}: + refresh) "
          f"{ {i: round(step_ms[i], 2) for i in range(0, TRAIN_STEPS, every)} }; "
          f"peak memory {peak_gb:.2f} GB")
    print(f"{label}: loss first 5 mean {first:.5f}, last 5 mean {last:.5f}; "
          f"losses {[round(x, 5) for x in losses[::8]]} (every 8th); "
          f"overflow_rays {overflow[::8]} (every 8th), max {max(overflow)}; "
          f"occupancy mean {float(trainer.occupancy.mean()):.3f}; launches {launches}; "
          f"launches in step 1 {per_step}")
    saved = _saved_bytes(trainer, batches[0], dev)
    samples = TRAIN_RAYS * (cfg.num_samples + cfg.num_fine_samples + 1)
    print(f"{label}: autograd keeps {saved / 1e9:.3f} GB for the backward of one "
          f"step ({saved / samples:.0f} bytes per ray-sample)")
    _check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    _check(last < first, f"{label}: loss did not fall ({first} -> {last})")
    for k in FUSED_TRAIN_KERNELS if fused else TRAIN_KERNELS:
        _check(launches[k] > 0, f"{label}: {k} did not launch: {launches}")

    # One step's loss and field gradient from this state on 256 rays, with
    # injected random numbers, on the card and on the CPU twins.
    b = _train_batch(rng, REF_RAYS)
    u_rng = np.random.default_rng(7)
    uniforms = {
        "coarse": u_rng.random((REF_RAYS, cfg.num_samples + 1), np.float32),
        "fine": u_rng.random((REF_RAYS, cfg.num_fine_samples + 1), np.float32),
        "background": u_rng.random((REF_RAYS, 3), np.float32),
    }
    model_cpu = copy.deepcopy(trainer.model).to("cpu")
    loss_g, grad_g = _loss_and_field_grad(trainer.model, trainer.mesh, trainer, b,
                                          uniforms, dev)
    loss_c, grad_c = _loss_and_field_grad(model_cpu, trainer.mesh.to("cpu"), trainer,
                                          b, uniforms, "cpu")
    loss_err = abs(loss_g - loss_c) / loss_c
    grad_err = float((grad_g - grad_c).abs().max() / grad_c.abs().max())
    print(f"{label} vs CPU twins ({REF_RAYS} rays): loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(rel {loss_err:.3g}), field gradient max abs diff / max "
          f"{grad_err:.3g}")
    _check(loss_err <= REF_LOSS_RTOL, f"train ref: loss rel err {loss_err}")
    _check(grad_err <= REF_GRAD_RTOL, f"train ref: field grad rel err {grad_err}")
    trainer.model.zero_grad(set_to_none=True)

    _profile_steps(trainer, batches[:2], med)
    return launches, per_step


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.utils.synthetic import make_sphere_scene, sample_sphere_rays

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t = time.perf_counter()
    cuda.load()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    for line in cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    t = time.perf_counter()
    points, colors = make_sphere_scene(NUM_POINTS, seed=0)
    mesh_plain = build_mesh(points, device="cpu")
    mesh_cpu = mesh_plain.with_occupancy(synthetic_occupancy(mesh_plain))
    mesh = mesh_cpu.to(dev)
    print(f"scene: {NUM_POINTS} points, {mesh.num_cells} cells, "
          f"{len(mesh.hull_eqs)} hull facets, built in "
          f"{time.perf_counter() - t:.1f} s")

    cfg = tetranerf_preset(ray_buckets=1)
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)

    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(0), CHUNK)
        kernels = kernel_checks(
            mesh, model.tetrahedra_field.detach(),
            torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
        )
        golden_check(dev)

    render_phase(model, mesh, mesh_cpu, dev)

    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(2), TRAIN_RAYS)
        kernels += backward_checks(
            mesh_plain.to(dev), torch.from_numpy(o).to(dev),
            torch.from_numpy(d).to(dev),
        )
    del model
    torch.cuda.empty_cache()

    train_phase(colors, mesh_plain, dev)
    torch.cuda.empty_cache()

    # The fused-MLP configuration: the same seeded weights.
    model = TetraNerf(tetranerf_preset(ray_buckets=1, fused_mlps=True),
                      mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    kernels += mlp_checks(model, dev)
    torch.cuda.empty_cache()
    render_launches = render_phase(model, mesh, mesh_cpu, dev, FUSED_RENDER_KERNELS)
    del model
    torch.cuda.empty_cache()
    train_launches, step_launches = train_phase(colors, mesh_plain, dev, fused=True)

    chunks = REQUESTS * REQUEST_RAYS // CHUNK
    for k in kernels:
        name = k["name"]
        k["launches"] = train_launches[name]
        k["launches_per_step"] = step_launches[name]
        k["launches_render"] = render_launches[name]
        k["launches_per_chunk"] = render_launches[name] / chunks
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
