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
   times of both (and K2's kernel time by the profiler), the least time the
   card could take (bytes over HBM rate or operations over the f32 rate,
   from this run's data); K1 field by field (every output of ``march()``,
   which its one launch writes), also at the flagship step's shape (4096
   train rays, bound 384), with the profiler's kernel time, ``march()`` by
   CUDA events and its kernels per call, and the latency floor (the
   longest ray's rows times the dependent-load latency that a pointer
   chase over the march table measures, built beside the kernels); K3 also at
   three buckets of the flagship's cold step (512 train rays: the deepest
   bound at S=257, the median at its adaptive budget, the shallowest at
   S=33), sorted and shuffled, mask equal, two launches bit-equal;
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
   K2b and K3b also at phase 3's three bucket shapes (K3b sorted and
   shuffled), two launches bit-equal; then K2 at those three bucket shapes
   and over all 8 buckets of the cold flagship step in one launch (two
   launches bit-equal), and the 8-job K7 of that step (K2b of random
   endpoint cotangents per bucket into one [V, 64] table) beside
   ``index_add_`` of the jobs' concatenation and the per-bucket design (8
   one-job launches, their tables summed);
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
   same inputs (``unfused_ms``), and checked and timed beside their
   bounds at the flagship's three bucket shapes (512 rays x 257, 193 and
   33 samples); the build's ``-Xptxas -v`` report of ``mlp.cu`` and the
   preset's launch plans;
9. the fused render: phase 5 with ``fused_mlps=True`` (K4 and K5 must
   launch);
10. the fused train run: phase 7 with ``fused_mlps=True`` (K4, K4b and K5
    must launch), with the device busy time, idle share and the fused
    kernels' profiler ms per step beside their bounds;
11. the row gather K8 against its twin (bit for bit, job by job), against
    itself one table per launch and against ``torch.index_select``
    (``library_ms``) on one cold flagship step's bucket slices in one batch
    (the cold march of 4096 train rays at T=384 cut into 8 quantile
    buckets at the cold tune's bounds: cells, t0, t1, valid, stream ids,
    positions and weights, the per-ray vectors, origins and directions),
    with the host time per launch of both ways, and on a [100,000, 128]
    f32 table x 65,536 rows;
12. the flagship train run: ``tetranerf_preset()`` with no overrides (8
    quantile buckets, the transmittance retune every 128 steps), 260 steps
    on the five batches of phase 7: the ``# retune@`` lines of steps 128
    and 256, every loss finite and the last 5 below the first 5, every
    kernel of the path launched (K8 included), the median step of steps
    1-127 (cold) and 129-255 (after the first retune) beside phase 7's, a
    profile of two steady steps after the retune with each port kernel's
    ms per step beside its bound (from one step's own inputs; K1 from the
    steps its rays took), K8, K2, K7 and K1 launched once per steady step
    and K2b once per bucket, ``march()``'s kernels per step, and one
    256-ray step's loss and field gradient against the CPU twins, un-fused
    and fused;
13. the flagship render: ``Trainer.render_rays`` of phase 12's trainer (its
    tuned bounds and calibrated cap) on 4 x 65,536 rays at chunk 8192 (K8
    and K2 launched once per chunk), and 256 rays against the CPU twins;
14. the CLI path: the sphere dataset at the generator's defaults (40 + 8
    views at 256^2, phase 1's 100,000 points and cells) written to disk
    through the port's PNG writer, then ``tetranerf_torch.training.cli.main``
    with the ``tetra-nerf`` preset unmodified for 300 steps (logs every 50,
    eval batch / image / all images every 100 / 200 / 300, so through the
    retunes at 128 and 256): every logged loss finite, the held-out PSNR at
    step 300 above step 100's, the final metrics in range on the test split,
    ``final/`` restored into a fresh ``Trainer`` bit for bit (weights and
    occupancy column), a second ``main`` resuming from it for 16 steps, and
    K1, K2, K2b, K3, K3b, K7 and K8 launched (the path ``cli_train``); the
    seconds from ``main()`` to the first step, the log lines' rays/s, the
    eval renders' rays/s and the metrics;
15. the serving path on phase 14's ``final/`` (under 30 s): the render CLI
    (``tetranerf_torch.scripts.render.main``) over the 8 test views at
    256^2 (every PNG decodes, ``metrics.json`` finite, view 0 within the
    render tolerance of ``render_rays`` of a trainer restored the same way;
    its PSNR beside phase 14's, its rays/s; the path ``serve_render``); then
    ``ViewerServer`` on localhost: the page, a fast 400^2 frame, an 800^2
    pose as 8 progressive bands of 800 x 100 (cache misses: K1 launched),
    the same 8 bands again (cache hits: K1 not launched, K2 and K3 launched;
    the path ``serve_viewer_cached``), one band's dense re-shade against
    ``render_rays``, the bytes the 8 cached marches hold (all requests: the
    path ``serve_viewer``), and the missed frame's extra time split: the
    caches dropped, the frame asked for again with ``cache_camera`` timed
    on the host and every ``march()`` and K1 by CUDA events; then 16 train
    steps on one thread while the main thread asks for 4 fast frames (every
    one a PNG, the occupancy updated on the restored trainer's first step,
    ``march_version`` advanced, the next full band marched again);
16. the empty-space skip grid on ``make_camera_scene(100_000)`` (objects
    inside a sparse background shell that stretches the hull): K9, the
    point-location walk, against its twin on the 64^3 voxel centres (every
    cell exactly; CUDA-event ms, bound, latency floor from phase 3's
    pointer chase), ``make_skip_setup``'s seconds; 160 train steps of
    ``tetranerf_preset(skip_grid_resolution=64)`` on camera batches of 4096
    rays and the same run with ``skip_grid_resolution=0`` from the same
    seeds (the grid attaches at the refresh of step 64 and
    ``march_version`` moves once more there than without it; losses fall
    in both); ``build_skip_table`` on the card against the CPU, bit for
    bit, with its ms; K1 with the trained grid and with a grid of the
    objects' shells against its twin in every output, its ms with and
    without the grid on the last step's batch, the rays the trace drops
    and the crossings a ray; median ms/step before and after the attach in
    both runs with the idle share; eval render rays/s of both trainers
    (the path ``skip_train``: K9 launched once, at the attach);
17. merged-MLP buckets: phase 12's flagship with ``bucket_merge_mlps``
    against the per-bucket shading from the same seeds, 72 steps each:
    one 4096-ray step's loss and field gradient against the per-bucket
    step at phase 12's tolerances, the MLP chains (1 + 1 against 8 + 8)
    and GEMM launches a step, median ms/step and the idle share (the path
    ``merged_train``);
18. data shards: 16 steps of the flagship on 4096-ray global batches with
    no group (twice: K7's atomic order makes the fields of two runs
    differ in the last bits), then the same steps by ranks that this
    script starts again with ``--shard-rank`` and torchrun's environment:
    one rank over NCCL (its first loss bit-equal), two ranks on
    ``cuda:0`` over gloo with 2048 rows each; each run's bounds, cap and
    EMA equal to the no-group run's, losses within 1e-5 and the field
    within 1e-4, the ranks bit-equal to each other, ms/step beside the
    no-group run's and phase 12's (paths ``shards_nccl``,
    ``shards_gloo``). ``--shard-ranks N`` runs this phase alone with N
    ranks over NCCL, one a card, and ``--shard-ranks N --model-shards M``
    phase 20's runs that way;
19. the stream levers: K2, K2b and K7's instances for each low-precision
    row type (bf16, f16, float8_e4m3fn, float8_e5m2 and the seven software
    types, float8_e4m3fnuz, _e5m2fnuz, _e4m3b11fnuz, _e3m4, _e4m3,
    _e8m0fnu and float4_e2m1fn) against their plain versions on a cold
    step's 8 buckets, each timed beside its f32 instance with both bounds,
    K2b's rounding of boundary values and the field's cast on the card
    bit-equal to ``jnp.astype``'s codes; then the flagship in f32, with
    ``field_stream_dtype`` "bfloat16", "float16", "float8_e4m3fn" and
    "float8_e5m2" (the paths ``stream_lp_train``, ``stream_f16_train``,
    ``stream_e4m3fn_train``, ``stream_e5m2_train``), with
    ``grad_stream_budget_per_ray=200`` (``budget_train``) and in f32
    again, 40 steps each from the same seeds: the first loss against
    f32's (the budget's bit-equal), the rays dropped, ms/step; then 16
    steps with each software type (paths ``stream_e4m3fnuz_train`` ...
    ``stream_e2m1fn_train``): the first loss against f32's and every loss
    finite, and with float8_e8m0fnu every loss NaN, as JAX's model gives
    it (the field has entries <= 0, which that type cannot hold); each
    instance launched in its own type's run only, and the instances' ms
    per steady step beside their bounds;
20. model shards: the field over 2 shards of its feature axis, phase 18's
    16 steps by 1 x 2 and 2 x 2 ranks on ``cuda:0`` over gloo, each held
    to phase 18's no-group run at phase 18's tolerances (the field put
    together from its column blocks; every rank's replicated parameters
    and its data group's field block bit-equal); per rank the bytes of its
    field block with gradient and moments, the peak memory and ms/step;
    the column gathers of 2 more steps (count, bytes, ms) beside the bytes
    a gather after K3 would move; K2, K2b and K7 at the shard's width (32)
    on a cold step's 8 buckets against their plain versions, with ms and
    bounds (the path ``model_shards``);
21. the tracer: ``TetrahedraTracer`` on phase 1's sphere, ``trace_rays``
    of 8192 rays at 512 and ``trace_rays_triangles`` (K1 launched twice),
    ``find_tetrahedra`` of 65,536 points (K9 once), ``find_visited_cells``
    of 64 samples a ray and ``interpolate_values`` of a 64-wide field
    forward and backward, each against the CPU on its first rows and
    timed (the path ``tracer``);
22. the API surface (the path ``api``): phase 14's dataset's points
    written as a PLY and made into a ``.th`` by ``tetranerf-torch-triangulate
    --random-points-ratio 0.5`` (vertex and cell counts, seconds); the
    unmodified preset trained on it for 32 steps through ``cli.main`` and
    restored as ``scripts/render.py`` restores; ``TorchRenderAdapter`` on
    the 8 test views' CUDA tensors bit-equal to ``Trainer.render_rays``
    (rays/s of both; one view timed by ``utils.profiling.benchmark`` beside
    CUDA events); ``TetraNerfAdapterModel.get_outputs_for_camera_ray_bundle``
    at chunks 8192 and 4096, each bit-equal to ``render_rays`` at its
    chunk, the two within 1e-5 with ``ray_buckets=1`` (with the preset's
    quantile buckets a ray's budget follows its rank within its chunk: the
    difference is printed); ``state_dict`` loaded into a freshly built
    trainer rendering bit-equal; ``get_image_metrics_and_images``'s PSNR
    against the render CLI's on view 0; K1, K2, K3 and K8 launched;
23. the live viewer over model shards (the path ``viewer_shards``): 1 x 2
    gloo ranks on ``cuda:0`` as in phase 20, every rank with a viewer and
    rank 0 serving the socket; a fast 128^2 frame and rows 0-32 of a full
    256^2 frame queued before ``fit`` and served after step 1, within 1e-5
    (float outputs, both ranks) and 1 level of 255 (PNGs) of a no-group
    trainer's frames after the same step; a frame queued during step 1's
    eval answered, one after ``fit`` refused (503); ms/step of 8 steps
    with the viewer attached and without, each frame's latency;
24. the fused MLPs' generic route (``ops/mlp.py`` ``launch_plan``: float32,
    and bf16 at widths the wgmma instances lack): K4, K4b, K5 and K5b of
    the preset's stack in float32 and of a field 32, hidden 64 stack in
    bf16 against their twins (float32: 1e-4 of each output's largest
    entry, the f32 twin's forward within 1e-5 of the float64 twin; bf16:
    phase 8's tolerances) at the
    train slice's shapes and a 512 x 33 bucket, each timed beside its
    bound (f32 at 67, bf16 at 989 TFLOP/s), its twin and the un-fused stack
    at its dtype; 24 steps of ``tetranerf_preset(fused_mlps=True,
    compute_dtype="float32")`` (losses finite and falling, a 256-ray step
    against the CPU twins) and 16 of the bf16 stack (paths
    ``generic_f32_train``, ``generic_bf16_train``), every fused launch on
    the generic route;
25. the fused MLPs' layered route (widths above 256, more than 8 layers):
    K4, K4b, K5 and K5b of a field 64, hidden 512 stack (3 + 1 layers) in
    bf16 and float32 and of a 6 + 4-layer stack at the preset's widths in
    bf16 against their twins (phase 24's tolerances; the float32 backward
    against the f32 twin only) at the train slice's shapes and a 512 x 33
    bucket, each timed beside its bound (operations and bytes apart), the
    bytes of its own activation traffic, its twin and the un-fused stack,
    each backward's launches split by kernel, mode and matrix (profiler ms,
    bytes moved); 16 steps of each stack in the preset's bf16 (losses
    finite; the wide one's falling and a 256-ray step against the CPU twins;
    paths ``layered_wide_train``, ``layered_deep_train``), every fused
    launch on the layered route.

``python3 chip_smoke.py --layered-split`` builds the kernels and runs only
the layered kernels at phase 25's shapes (and the preset's wgmma and
generic ones at the same shapes), each timed by CUDA events, the bf16
backwards split by launch, then phase 25's two train runs; it prints no
result line, so that two trees of the port can be timed in turns on one
card.

Phase 1 also builds the native host geometry library (``g++``) and times
its adjacency and spacing against the numpy sort and the KD-tree on the
100K sphere (tables equal, spacing within 1e-6).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
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
FLAGSHIP_STEPS = 260
CLI_STEPS = 300
CLI_RESUME_STEPS = 16
REF_RAYS = 256
GATHER_TABLE = (100_000, 128)
# Phase 15's viewer frames: the page's fast side, its full side in bands.
SERVE_FAST_SIDE = 400
SERVE_FULL_SIDE = 800
SERVE_BANDS = 8
SERVE_LIVE_STEPS = 16
GATHER_ROWS = 65_536
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
# The flagship's three bucket shapes (phase 3): 512 rays x 257, 193 and
# 33 fine samples, as (rays, coarse samples, fine samples).
MLP_BUCKET_SHAPES = ((512, 128, 128), (512, 96, 96), (512, 16, 16))
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
# fused MLP kernels' products), and f32 products as 3xTF32 (three TF32
# products each at the 495 TFLOP/s TF32 rate: the generic route's float32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
TF32X3_FLOPS = 495e12 / 3
_PEAKS = {F32_FLOPS: "f32 outside the tensor cores, 67 TFLOP/s",
          BF16_TENSOR_FLOPS: "bf16 dense on the tensor cores, 989 TFLOP/s",
          TF32X3_FLOPS: "f32 as 3xTF32 on the tensor cores, 165 TFLOP/s effective"}


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


def _device_kernels(fn):
    """The device events of the kernels ``fn`` launches, from
    ``torch.profiler`` (after one call outside it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_ms(fn):
    """Device time of the kernels ``fn`` launches (the sum of their
    durations, without the gaps between them), or None where the profiler
    records no device events."""
    kernels = _device_kernels(fn)
    if not kernels:
        return None
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3


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


def _march_bound(res):
    """K1 from its outputs (a ``FusedMarch``): per table row a ray visited
    (each emitted step's, and each hit ray's entry row) its 100 used bytes
    read and ~80 flops of plane arithmetic; per ray 41 bytes in and every
    output byte written once, padding included: 49 bytes a slot (cells, t0,
    t1, valid, a stream id, a position and a weight row) and 58 more (the
    stream's slot 0, t_entry, num_valid, hit, overflow)."""
    num_rays, max_t = res.cells.shape
    rows = int(res.num_valid.sum()) + int(res.hit.sum())
    return _bound(rows * 100 + num_rays * (41 + 49 * max_t + 58), rows * 80)


# Dependent loads over the march table, for K1's latency floor: each hop
# reads a row at an address hashed from the previous hop's bits.
_CHASE_CU = r"""
#include <cuda_runtime.h>
namespace {
__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16;
  return x;
}
__global__ void chase_kernel(const float* __restrict__ table, unsigned rows,
                             int hops, unsigned seed, unsigned* out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned r = (unsigned)(((unsigned long long)mix(seed ^ (tid * 2654435761U)) * rows) >> 32);
  for (int i = 0; i < hops; ++i) {
    const unsigned bits = __float_as_uint(__ldg(table + (long long)r * 64 + 16 + (i & 3)));
    r = (unsigned)(((unsigned long long)mix(r ^ bits ^ i) * rows) >> 32);
  }
  out[tid] = r;
}
}  // namespace
extern "C" int chase(const float* table, unsigned rows, int hops, unsigned seed,
                     int threads, unsigned* out, cudaStream_t stream) {
  const int block = threads < 64 ? threads : 64;
  chase_kernel<<<(threads + block - 1) / block, block, 0, stream>>>(table, rows, hops,
                                                                    seed, out);
  return (int)cudaGetLastError();
}
"""


def _start_chase_build():
    """nvcc of the pointer chase, started beside the kernels' build."""
    from tetranerf_torch.ops import cuda

    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda.BUILD_DIR / "chase.cu"
    src.write_text(_CHASE_CU)
    so = cuda.BUILD_DIR / "libchase.so"
    proc = subprocess.Popen(
        [cuda._nvcc(), *cuda._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-shared", str(src), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def _load_chase(build):
    import ctypes

    proc, so = build
    out = proc.communicate()[0]
    _check(proc.returncode == 0, f"pointer chase: nvcc failed\n{out}")
    lib = ctypes.CDLL(str(so))
    lib.chase.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.chase.restype = ctypes.c_int
    return lib


def dependent_load_ns(chase_lib, table, hops=2000):
    """ns per dependent load of a random row of ``table`` (hash included),
    by CUDA events over ``hops`` hops: ``{threads: ns}`` for one chain
    and for 4096 side by side (the flagship step's rays)."""
    import torch

    out = {}
    for threads in (1, TRAIN_RAYS):
        buf = torch.empty(threads, dtype=torch.int32, device=table.device)

        def run(seed):
            rc = chase_lib.chase(table.data_ptr(), table.shape[0], hops, seed, threads,
                                 buf.data_ptr(), torch.cuda.current_stream().cuda_stream)
            _check(rc == 0, f"pointer chase: CUDA error {rc}")

        seeds = iter(range(1, 100))
        out[threads] = _time_ms(lambda: run(next(seeds)), 5) * 1e6 / hops
    return out


def _blend_batch_bound(field, streams):
    """K2, one launch: per stream the output, pos + bary and the stream
    ids; the field once (f32 or a stream row type)."""
    num_feat = field.shape[1]
    num_bytes, num_ops = field.numel() * field.element_size(), 0
    for vids, pos, bary in streams:
        num_rays, num_end = pos.shape[:2]
        weighted = int((bary != 0).any(dim=-1).sum())
        num_bytes += (num_rays * num_end * num_feat * 4 + num_rays * num_end * 32
                      + vids.numel() * 4)
        num_ops += weighted * 4 * num_feat * 2
    return _bound(num_bytes, num_ops)


def _blend_bound(field, vids, pos, bary):
    """K2 on one stream."""
    return _blend_batch_bound(field, [(vids, pos, bary)])


def _interp_bound(t0, t1, num_valid, ray_mask, distances, feats):
    """K3: output + mask, distances, t0/t1, the endpoint rows kept samples
    read."""
    from tetranerf_torch.ops.interp import _match

    num_rays, max_t = t1.shape
    num_feat = feats.shape[2]
    kept = int(_match(t0, t1, num_valid, ray_mask, distances)[2].sum())
    rows = _endpoint_rows_read(t0, t1, num_valid, ray_mask, distances)
    return _bound(distances.numel() * (num_feat * 4 + 5) + num_rays * max_t * 8
                  + rows * num_feat * 4, kept * num_feat * 3)


def _interp_bwd_bound(t0, t1, num_valid, ray_mask, distances, g):
    """K3b: the output, the g rows of the kept samples, distances, t0/t1."""
    from tetranerf_torch.ops.interp import _match

    num_rays, max_t = t1.shape
    num_feat = g.shape[2]
    kept = int(_match(t0, t1, num_valid, ray_mask, distances)[2].sum())
    return _bound(num_rays * (max_t + 1) * num_feat * 4 + kept * num_feat * 4
                  + distances.numel() * 4 + num_rays * max_t * 8, kept * num_feat * 4)


def _blend_bwd_bound(g, pos, bary, num_stream, out_dtype=None):
    """K2b: the output (f32, or ``out_dtype``, a stream row type), all bary
    rows, pos + g rows of the weighted endpoints."""
    import torch

    from tetranerf_torch.ops.stream_dtypes import F32, row_type

    num_rays, num_end, num_feat = g.shape
    n_w = int((bary != 0).any(dim=-1).sum())
    storage = (row_type(out_dtype) or F32).storage
    out_size = torch.empty((), dtype=storage).element_size()
    return _bound(num_rays * num_stream * num_feat * out_size + num_rays * num_end * 16
                  + n_w * (16 + num_feat * 4), int((bary != 0).sum()) * num_feat * 2)


def _scatter_batch_bound(jobs, num_rows, row_type=None):
    """K7, one launch: each job's indices and values, the table once; one
    add per nonzero element. A march stream's job (with ``num_valid``, rows
    of ``row_type``, where None their dtype's) counts what K7 reads: its
    num_valid, its rays' used slots, and for a type without zero
    (float8_e8m0fnu) the ids of its padding slots too."""
    import torch
    from tetranerf_torch.ops.scatter import STREAM_HEAD
    from tetranerf_torch.ops.stream_dtypes import rows_type

    moved, ops = num_rows * jobs[0][1].shape[1] * 4, 0
    for job in jobs:
        idx, vals = job[:2]
        ids_read = idx.numel()
        if len(job) == 3:
            nv = job[2]
            width = idx.numel() // max(nv.numel(), 1)
            u = torch.arange(width, device=idx.device)
            keep = (u[None, :] < nv[:, None].long() + STREAM_HEAD).reshape(-1)
            vals = vals[keep]
            moved += nv.numel() * 4
            if rows_type(job[1], row_type).zero_mask is not None:
                ids_read = vals.shape[0]
        moved += ids_read * 4 + vals.numel() * vals.element_size()
        ops += int((vals != 0).sum())
    return _bound(moved, ops)


def _scatter_bound(idx, vals, num_rows):
    """K7 on one job."""
    return _scatter_batch_bound([(idx, vals)], num_rows)


def _gather_bound(jobs):
    """K8: each copied row read and written once, and its index."""
    return _bound(sum(idx.shape[0] * (2 * w * table.element_size() + 4)
                      for table, idx, w in jobs), 0)


def synthetic_occupancy(mesh_cpu):
    """Density 200 in cells whose centroid lies outside radius 0.9 (the
    scene's surface shell), 0 inside: a ray entering the shell passes the
    depth cap -log(1e-4) within about 0.05 of travel and stops."""
    import torch

    centroids = mesh_cpu.vertices[mesh_cpu.cells.long()].mean(dim=1)
    return torch.where(centroids.norm(dim=1) > 0.9, 200.0, 0.0)


_MARCH_EXACT = ("cells", "valid", "num_valid", "hit", "overflow")
_STREAM_EXACT = ("vids", "pos")


def _march_err(ker, twin, label):
    """K1 against its twin, field by field: ids, masks and counts exact,
    distances where finite (the same infinities), t_entry on hit rays,
    weights: the max abs error."""
    import torch

    for name in _MARCH_EXACT:
        _check(torch.equal(getattr(ker, name), getattr(twin, name)),
               f"{label}: {name} differs from the twin")
    for name in _STREAM_EXACT:
        _check(torch.equal(getattr(ker.stream, name), getattr(twin.stream, name)),
               f"{label}: stream {name} differs from the twin")
    hit = twin.hit
    return max(_max_err(ker.t0, twin.t0, True), _max_err(ker.t1, twin.t1, True),
               _max_err(ker.t_entry[hit], twin.t_entry[hit]),
               _max_err(ker.stream.bary, twin.stream.bary))


def _march_timing(mesh, origins, directions, args, chase_ns):
    """K1 alone (CUDA events around ``march_intervals``, one launch; and
    the profiler's kernel time), ``march()`` end to end by CUDA events with
    its kernels per call, the bound from the outputs and the latency floor
    (the longest ray's rows x the dependent-load latency of 4096 chains)."""
    from tetranerf_torch.ops.march import march, march_intervals

    max_steps, use_occ = args[8], args[11]
    res = march_intervals(*args)

    def whole():
        return march(mesh, origins, directions, max_steps, use_occupancy=use_occ,
                     occ_threshold=1e-4)

    launches = len(_device_kernels(whole)) or None
    longest = int(res.num_valid.max()) + 1  # + the entry row
    return dict(
        ms=_time_ms(lambda: march_intervals(*args), 10),
        device_ms=_device_ms(lambda: march_intervals(*args)),
        march_ms=_time_ms(whole, 10), march_kernels_per_call=launches,
        latency_floor_ms=longest * chase_ns / 1e6, longest_ray_rows=longest,
        intervals_mean=float(res.num_valid.float().mean()), **_march_bound(res))


def kernel_checks(mesh, field, origins, directions, bucket_rays, chase_ns):
    """Phase 3: each forward kernel against its twin on the card; K3 also
    at three flagship bucket shapes cut from the march of ``bucket_rays``
    (the train rays' origins and directions). K1 is also checked and timed
    at the flagship step's shape (those rays, bound 384, no termination as
    under the cold zero column); ``chase_ns`` is the dependent-load latency
    of 4096 chains over the march table."""
    import torch
    from tetranerf_torch.ops import fused, interp
    from tetranerf_torch.ops.march import march, march_intervals, march_intervals_twin
    from tetranerf_torch.ops.traversal import hull_intersect

    results = []
    t_in, t_out, facet, hit = hull_intersect(mesh.hull_eqs, origins, directions)
    args = (mesh.march_table, mesh.hull_cells, origins, directions, t_in,
            t_out, facet, hit, 512, 512, 16, True, float(-np.log(1e-4)))
    ker = march_intervals(*args)
    twin = march_intervals_twin(*args)
    err = _march_err(ker, twin, "march")
    _check(err <= TOLERANCES["march"], f"march: max abs err {err}")
    # Without occupancy the rays cross the whole ball: long marches.
    args_long = args[:11] + (False, 0.0)
    ker_long = march_intervals(*args_long)
    twin_long = march_intervals_twin(*args_long)
    err = max(err, _march_err(ker_long, twin_long, "march (no occupancy)"))
    _check(err <= TOLERANCES["march"], f"march: max abs err {err}")
    # The flagship step's march: the train rays at the cold bound 384.
    bo, bd = bucket_rays
    hull = hull_intersect(mesh.hull_eqs, bo, bd)
    args_step = (mesh.march_table, mesh.hull_cells, bo, bd, *hull, 384, 384, 16, False, 0.0)
    err = max(err, _march_err(march_intervals(*args_step), march_intervals_twin(*args_step),
                              "march (flagship shape)"))
    _check(err <= TOLERANCES["march"], f"march: max abs err {err}")
    nv = ker_long.num_valid.float()
    print(f"march: every field of the kernel's FusedMarch equal to the twin's (t, bary "
          f"max abs err {err:.3g}); intervals per ray {float(ker.num_valid.float().mean()):.1f} "
          f"(occupancy), {float(nv.mean()):.1f} mean / {int(nv.max())} max (none)")
    timing = _march_timing(mesh, origins, directions, args, chase_ns)
    step = _march_timing(mesh, bo, bd, args_step, chase_ns)
    for label, tm in ((f"render shape ({origins.shape[0]} rays, T=512, occupancy)", timing),
                      (f"flagship step shape ({bo.shape[0]} rays, T=384, cold)", step)):
        print(f"march at the {label}: K1 {tm['ms']:.4f} ms by CUDA events (profiler "
              f"{tm['device_ms']}), march() {tm['march_ms']:.4f} ms by CUDA events in "
              f"{tm['march_kernels_per_call']} kernels (the hull slab and K1); bound "
              f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}); latency floor "
              f"{tm['latency_floor_ms']:.4f} ms ({tm['longest_ray_rows']} rows x "
              f"{chase_ns:.1f} ns); {tm['intervals_mean']:.1f} intervals per ray")
    results.append(_entry(
        "march", "tetranerf_torch/csrc/march.cu", "tetranerf_tpu/ops/fused.py:125",
        err, timing.pop("ms"), _time_ms(lambda: march_intervals_twin(*args), 3),
        {k: timing.pop(k) for k in ("bound_ms", "bound_by", "bound_peak")},
        **timing, flagship_shape=step,
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
    del out_t
    entry = _entry(
        "stream_blend_gather", "tetranerf_torch/csrc/blend.cu",
        "tetranerf_tpu/ops/pallas_interp.py:214", err,
        _time_ms(lambda: interp.stream_blend_gather(*blend_args), 10),
        _time_ms(lambda: interp.stream_blend_gather_twin(*blend_args), 3),
        _blend_bound(*blend_args),
        device_ms=_device_ms(lambda: interp.stream_blend_gather(*blend_args)),
    )
    print(f"stream_blend_gather: out {tuple(out_k.shape)}, max abs err {err:.3g}; "
          f"{entry['ms']:.4f} ms by CUDA events, kernel {entry['device_ms']} ms by the "
          f"profiler (twin {entry['plain_ms']:.3f}), bound {entry['bound_ms']:.4f}")
    results.append(entry)

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
    entry = _entry(
        "sample_interp", "tetranerf_torch/csrc/interp.cu",
        "tetranerf_tpu/ops/pallas_interp.py:104", err,
        _time_ms(lambda: interp.sample_interp(*interp_args), 10),
        _time_ms(lambda: interp.sample_interp_twin(*interp_args), 3),
        _interp_bound(*interp_args),
    )
    del f_k, f_t
    gen = torch.Generator(device=origins.device).manual_seed(3)
    entry["bucket_shapes"] = _interp_bucket_checks(mesh, *bucket_rays, gen)
    entry["max_abs_err"] = max([err] + [b["max_abs_err"] for b in entry["bucket_shapes"]])
    results.append(entry)
    return results


def _endpoint_rows_read(t0, t1, num_valid, ray_mask, distances):
    """Distinct endpoint rows (ray, k) and (ray, k+1) of the kept samples."""
    import torch
    from tetranerf_torch.ops.interp import _match

    k_c, _, mask = _match(t0, t1, num_valid, ray_mask, distances)
    ray = torch.arange(k_c.shape[0], device=k_c.device)[:, None] * (t1.shape[1] + 1)
    keys = (ray + k_c)[mask]
    return int(torch.cat([keys, keys + 1]).unique().numel())


def backward_checks(mesh, origins, directions, blend_entry):
    """Phase 6: the backward kernels against their twins at the train
    slice's shapes: the cold march (no occupancy, T=512), S=257, F=64; then
    K2 (its phase 3 entry ``blend_entry`` gains the results) and K7 at a
    cold flagship step's buckets."""
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
        _blend_bwd_bound(*bwd_args),
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
        _scatter_bound(idx, vals, num_v),
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
    print(f"sample_interp_backward: out {tuple(gf.shape)}, kept samples "
          f"{kept / distances.numel():.3f}, max abs err {err:.3g}")
    entry = _entry(
        "sample_interp_backward", "tetranerf_torch/csrc/interp.cu",
        "tetranerf_tpu/ops/pallas_interp.py:141", err,
        _time_ms(lambda: interp.sample_interp_backward(*i_args, g_samp), 10),
        _time_ms(lambda: interp.sample_interp_backward_twin(*i_args, g_samp), 3),
        _interp_bwd_bound(*i_args, g_samp),
    )
    del gf, g_samp
    results.append(entry)
    by_name = {e["name"]: e for e in results}
    for name, shapes in zip(("stream_blend_backward", "sample_interp_backward"),
                            _backward_bucket_checks(mesh, origins, directions, gen)):
        entry = by_name[name]
        entry["bucket_shapes"] = shapes
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [b["max_abs_err"] for b in shapes])
    _flagship_batch_checks(mesh, origins, directions, gen, blend_entry,
                           by_name["scatter_add_rows"])
    return results


def _flagship_batch_checks(mesh, origins, directions, gen, blend_entry, scatter_entry):
    """K2 at the three bucket shapes of :func:`_bucket_slices` (one stream
    each) and over all 8 buckets of the cold flagship step in one launch;
    then that step's K7: K2b of random endpoint cotangents per bucket, the
    8 stream gradients scattered into one [V, 64] table in one launch,
    beside ``index_add_`` of the jobs' concatenation (``library_ms``) and
    the per-bucket design (8 one-job launches, their tables summed)."""
    import functools
    import torch
    from tetranerf_torch.ops import fused, interp, scatter

    dev = origins.device
    num_v = mesh.num_vertices
    field = torch.randn((num_v, 64), generator=gen, device=dev)
    shapes = []
    for label, sl, *_ in _bucket_slices(mesh, origins, directions):
        s = sl.stream
        shapes.append(_bucket_shape_check(
            "stream_blend_gather", label,
            dict(rays=sl.t1.shape[0], max_t=sl.t1.shape[1], endpoints=s.pos.shape[1],
                 slots=s.vids.shape[1]),
            [("stream", (field, s.vids, s.pos, s.bary))], _blend_bound))
    blend_entry["bucket_shapes"] = shapes

    res, order, plan = _cold_bucket_plan(mesh, origins, directions)
    slices = [sl for sl, _ in fused.slice_march_buckets(res, order, plan)]
    streams = [(sl.stream.vids, sl.stream.pos, sl.stream.bary) for sl in slices]
    outs = interp.stream_blend_gather_batch(field, streams)
    err = max(_max_err(out, ref) for out, ref in
              zip(outs, interp.stream_blend_gather_batch_twin(field, streams)))
    _check(err <= TOLERANCES["stream_blend_gather"],
           f"stream_blend_gather (8-bucket batch): max abs err {err}")
    _check(all(torch.equal(x, y) for x, y in
               zip(outs, interp.stream_blend_gather_batch(field, streams))),
           "stream_blend_gather (8-bucket batch): two launches differ")

    def blend_batch():
        return interp.stream_blend_gather_batch(field, streams)

    def blend_one_job():
        return [interp.stream_blend_gather(field, *st) for st in streams]

    batch = dict(
        jobs=len(streams), slice_bounds=[t for *_, t in plan], max_abs_err=err,
        ms=_time_ms(blend_batch, 20), device_ms=_device_ms(blend_batch),
        plain_ms=_time_ms(lambda: interp.stream_blend_gather_batch_twin(field, streams), 3),
        one_job_launches_ms=_time_ms(blend_one_job, 20),
        one_job_launches_device_ms=_device_ms(blend_one_job),
        **_blend_batch_bound(field, streams))
    blend_entry["flagship_batch"] = batch
    blend_entry["max_abs_err"] = max([blend_entry["max_abs_err"], err]
                                     + [b["max_abs_err"] for b in shapes])
    print(f"stream_blend_gather: the {len(streams)} buckets of a cold flagship step "
          f"(bounds {batch['slice_bounds']}) in one launch: max abs err {err:.3g}, two "
          f"launches bit-equal; {batch['ms']:.4f} ms by CUDA events, kernel "
          f"{batch['device_ms']} ms by the profiler (twin {batch['plain_ms']:.3f}; "
          f"{len(streams)} one-stream launches {batch['one_job_launches_ms']:.4f}, kernels "
          f"{batch['one_job_launches_device_ms']}), bound {batch['bound_ms']:.4f}")

    jobs = []
    for (vids, pos, bary), out in zip(streams, outs):
        g_end = torch.randn(out.shape, generator=gen, device=dev)
        gsf = interp.stream_blend_backward(g_end, pos, bary, vids.shape[1])
        jobs.append((vids.reshape(-1).clamp_min(0), gsf.reshape(-1, 64)))
    del outs
    got = scatter.scatter_add_rows_batch(jobs, num_v)
    err = _max_err(got, scatter.scatter_add_rows_batch_twin(jobs, num_v))
    _check(err <= TOLERANCES["scatter_add_rows"],
           f"scatter_add_rows (8-job batch): max abs err {err}")
    del got
    # The same jobs with a hot id, as padding slots give: 60% of the rows
    # moved to id 0 with zero values (a step's padding rows are zero).
    hot = []
    for idx, vals in jobs:
        pad = torch.rand(idx.shape, generator=gen, device=dev) < 0.6
        hot.append((torch.where(pad, 0, idx).contiguous(),
                    torch.where(pad[:, None], 0.0, vals).contiguous()))
    hot_err = _max_err(scatter.scatter_add_rows_batch(hot, num_v),
                       scatter.scatter_add_rows_batch_twin(hot, num_v))
    _check(hot_err <= TOLERANCES["scatter_add_rows"],
           f"scatter_add_rows (hot id): max abs err {hot_err}")
    hot_ms = _time_ms(lambda: scatter.scatter_add_rows_batch(hot, num_v), 20)
    hot_device_ms = _device_ms(lambda: scatter.scatter_add_rows_batch(hot, num_v))
    print(f"scatter_add_rows: the 8 jobs with 60% of their rows moved to id 0 as zero rows: max "
          f"abs err {hot_err:.3g}; {hot_ms:.4f} ms by CUDA events, kernels {hot_device_ms} ms "
          f"by the profiler, bound {_scatter_batch_bound(hot, num_v)['bound_ms']:.4f}")
    del hot
    # The same jobs as the train path passes them: each with its rays'
    # num_valid, so that no padding slot is read.
    stream_jobs = [job + (sl.num_valid,) for job, sl in zip(jobs, slices)]
    stream_err = _max_err(scatter.scatter_add_rows_batch(stream_jobs, num_v),
                          scatter.scatter_add_rows_batch_twin(stream_jobs, num_v))
    _check(stream_err <= TOLERANCES["scatter_add_rows"],
           f"scatter_add_rows (8 stream jobs): max abs err {stream_err}")
    stream_bound = _scatter_batch_bound(stream_jobs, num_v)["bound_ms"]
    read_rows = sum(scatter.used_rows(job)[0].numel() for job in stream_jobs)
    idx_cat = torch.cat([idx for idx, _ in jobs]).long()
    vals_cat = torch.cat([vals for _, vals in jobs])

    def k7_batch():
        return scatter.scatter_add_rows_batch(jobs, num_v)

    def k7_stream_batch():
        return scatter.scatter_add_rows_batch(stream_jobs, num_v)

    def per_bucket():
        return functools.reduce(torch.add, [scatter.scatter_add_rows(idx, vals, num_v)
                                            for idx, vals in jobs])

    def index_add():
        return torch.zeros((num_v, 64), device=dev).index_add_(0, idx_cat, vals_cat)

    rows = int(idx_cat.numel())
    batch = dict(
        jobs=len(jobs), rows=rows, nonzero=float((vals_cat != 0).float().mean()),
        max_abs_err=err, ms=_time_ms(k7_batch, 20), device_ms=_device_ms(k7_batch),
        plain_ms=_time_ms(lambda: scatter.scatter_add_rows_batch_twin(jobs, num_v), 3),
        library_ms=_time_ms(index_add, 20), library_device_ms=_device_ms(index_add),
        per_bucket_ms=_time_ms(per_bucket, 20), per_bucket_device_ms=_device_ms(per_bucket),
        hot_id_max_abs_err=hot_err, hot_id_ms=hot_ms, hot_id_device_ms=hot_device_ms,
        stream_max_abs_err=stream_err, stream_read_rows=read_rows,
        stream_ms=_time_ms(k7_stream_batch, 20), stream_device_ms=_device_ms(k7_stream_batch),
        stream_bound_ms=stream_bound, **_scatter_batch_bound(jobs, num_v))
    scatter_entry["flagship_batch"] = batch
    scatter_entry["max_abs_err"] = max(scatter_entry["max_abs_err"], err)
    print(f"scatter_add_rows: the {len(jobs)} buckets' stream gradients of a cold flagship "
          f"step ({rows} rows, nonzero share {batch['nonzero']:.3f}) into one "
          f"[{num_v}, 64] table in one launch: max abs err {err:.3g}; {batch['ms']:.4f} ms "
          f"by CUDA events, kernels {batch['device_ms']} ms by the profiler (memset "
          f"included; twin {batch['plain_ms']:.3f}; index_add_ {batch['library_ms']:.4f}, "
          f"kernels {batch['library_device_ms']}; per-bucket design "
          f"{batch['per_bucket_ms']:.4f}, kernels {batch['per_bucket_device_ms']}), bound "
          f"{batch['bound_ms']:.4f}; with each slice's num_valid, as the train path passes "
          f"them ({read_rows} rows read, {rows - read_rows} padding rows not): max abs err "
          f"{stream_err:.3g}, {batch['stream_ms']:.4f} ms by CUDA events, kernels "
          f"{batch['stream_device_ms']}, bound {stream_bound:.4f}")


def _bucket_slices(mesh, origins, directions):
    """Three buckets of the flagship's cold step: the train rays marched at
    bound 384 and cut into 8 quantile buckets of 512 rays at the cold
    tune's bounds (as phase 11 cuts them); the deepest at S=257, the median
    at its adaptive budget, the shallowest at the budgets' floor, S=33.
    Yields (label, slice, samples, ray mask, distances evenly spread over
    each ray's range)."""
    import torch
    from tetranerf_torch.ops import fused
    from tetranerf_torch.utils.shapes import scaled_budget

    res, order, plan = _cold_bucket_plan(mesh, origins, directions)
    for label, k in (("deepest", 7), ("median", 3), ("shallowest", 0)):
        _, lo, hi, t = plan[k]
        budget = {"deepest": 128, "shallowest": 16}.get(label, scaled_budget(128, t, 384))
        num_samples = 2 * budget + 1
        sl = fused.slice_march(res, order[lo:hi], t)
        nears, fars, _, _, ray_mask = fused.ray_bounds(sl)
        edges = torch.linspace(0.0, 1.0, num_samples + 1, device=origins.device)
        edges = nears[:, None] + edges[None, :] * (fars - nears)[:, None]
        distances = ((edges[:, 1:] + edges[:, :-1]) / 2.0).contiguous()
        yield label, sl, num_samples, ray_mask, distances


def _bucket_shape_check(name, label, shape, cases, bound):
    """Kernel ``name`` of ``ops/interp.py`` at one bucket's ``shape``: each
    of ``cases`` ((case, args) pairs) within its tolerance of the twin (a
    mask output equal), and two launches bit-equal; then the first case
    timed by CUDA events and the profiler beside its twin and ``bound``."""
    import torch
    from tetranerf_torch.ops import interp

    kernel, twin = getattr(interp, name), getattr(interp, name + "_twin")
    errs = []
    for case, args in cases:
        first, ref = kernel(*args), twin(*args)
        if isinstance(first, tuple):  # K3: (out, mask)
            _check(torch.equal(first[1], ref[1]),
                   f"{name} ({label} bucket, {case}): mask differs from the twin")
            first_out, ref = first[0], ref[0]
        else:
            first_out = first
        err = _max_err(first_out, ref)
        _check(err <= TOLERANCES[name], f"{name} ({label} bucket, {case}): max abs err {err}")
        again = kernel(*args)
        _check(all(torch.equal(x, y) for x, y in zip(
            first if isinstance(first, tuple) else (first,),
            again if isinstance(again, tuple) else (again,))),
            f"{name} ({label} bucket, {case}): two launches differ")
        errs.append(err)
    args = cases[0][1]
    out = dict(bucket=label, **shape, max_abs_err=max(errs),
               ms=_time_ms(lambda: kernel(*args), 20),
               device_ms=_device_ms(lambda: kernel(*args)),
               plain_ms=_time_ms(lambda: twin(*args), 3), **bound(*args))
    print(f"{name}, {label} bucket ({', '.join(f'{k} {v}' for k, v in shape.items())}): "
          f"max abs err {max(errs):.3g} ({', '.join(c for c, _ in cases)}), two launches "
          f"bit-equal; {out['ms']:.4f} ms by CUDA events, kernel {out['device_ms']} ms by "
          f"the profiler (twin {out['plain_ms']:.3f}), bound {out['bound_ms']:.4f}")
    return out


def _interp_bucket_checks(mesh, origins, directions, gen):
    """K3 at the three bucket shapes of :func:`_bucket_slices`, with random
    endpoint features; samples sorted and shuffled."""
    import torch

    shapes = []
    for label, sl, num_samples, ray_mask, distances in _bucket_slices(mesh, origins,
                                                                      directions):
        num_rays, max_t = sl.t1.shape
        feats = torch.randn((num_rays, max_t + 1, 64), generator=gen, device=origins.device)
        perm = torch.randperm(num_samples, generator=gen, device=origins.device)
        cases = [(order, (sl.t0.contiguous(), sl.t1, sl.num_valid, ray_mask,
                          dist.contiguous(), feats))
                 for order, dist in (("sorted", distances), ("shuffled", distances[:, perm]))]
        shapes.append(_bucket_shape_check(
            "sample_interp", label, dict(rays=num_rays, max_t=max_t, samples=num_samples),
            cases, _interp_bound))
    return shapes


def _backward_bucket_checks(mesh, origins, directions, gen):
    """K2b (random endpoint cotangents onto the bucket's stream) and K3b
    (random sample cotangents, samples sorted and shuffled) at the three
    bucket shapes of :func:`_bucket_slices`."""
    import torch

    blend, interp_bwd = [], []
    for label, sl, num_samples, ray_mask, distances in _bucket_slices(mesh, origins,
                                                                      directions):
        num_rays, max_t = sl.t1.shape
        s = sl.stream
        num_end, num_stream = s.pos.shape[1], s.vids.shape[1]
        g_end = torch.randn((num_rays, num_end, 64), generator=gen, device=origins.device)
        blend.append(_bucket_shape_check(
            "stream_blend_backward", label,
            dict(rays=num_rays, max_t=max_t, endpoints=num_end, slots=num_stream),
            [("stream", (g_end, s.pos.contiguous(), s.bary.contiguous(), num_stream))],
            _blend_bwd_bound))
        g = torch.randn((num_rays, num_samples, 64), generator=gen, device=origins.device)
        perm = torch.randperm(num_samples, generator=gen, device=origins.device)
        cases = [(order, (sl.t0.contiguous(), sl.t1, sl.num_valid, ray_mask,
                          dist.contiguous(), g))
                 for order, dist in (("sorted", distances), ("shuffled", distances[:, perm]))]
        interp_bwd.append(_bucket_shape_check(
            "sample_interp_backward", label,
            dict(rays=num_rays, max_t=max_t, samples=num_samples), cases, _interp_bwd_bound))
    return blend, interp_bwd


def _cold_bucket_plan(mesh, origins, directions):
    """The cold march of the train rays at bound 384, its crossing-count
    order and its 8-bucket plan ``(k, lo, hi, t)`` at the cold tune's
    bounds (``Trainer.tune_traversal_steps``'s quantiles)."""
    import torch
    from tetranerf_torch.ops.march import march
    from tetranerf_torch.training.trainer import quantile_bucket_bounds

    res = march(mesh, origins, directions, 384)
    bounds = quantile_bucket_bounds(res.num_valid.cpu().numpy(), 8, 384, 100.0,
                                    margin=1.5) + (384,)
    order = torch.argsort(res.num_valid, stable=True)
    num_rays = origins.shape[0]
    plan = [(k, num_rays * k // 8, num_rays * (k + 1) // 8, t) for k, t in enumerate(bounds)]
    return res, order, plan


def _rel_check(name, pairs, max_rtol=MLP_MAX_RTOL):
    """Max abs error over (kernel, twin) pairs, each held to MLP_NORM_RTOL
    and to ``max_rtol`` (None: the max abs error reported, not held)."""
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
        _check(max_rtol is None or e <= max_rtol * max(scale, 1e-30),
               f"{name}: output {i}: max abs err {e} against largest entry {scale}")
        err = max(err, e)
    return err


def _mlp_bounds(x, head_dir, weights, flops=BF16_TENSOR_FLOPS, chain_flops=None):
    """Bounds of K4 and K4b (``head_dir`` given) or K5 and K5b on these
    inputs: the bytes each must move (x, head_dir, the weights and the
    outputs once; the backward reads the cotangents and writes dx,
    dhead_dir and the weight gradients) against the products (one pass
    forward, three backward) at ``flops``: bf16 on the tensor cores, or
    the generic route's float32 (3xTF32). With ``chain_flops`` the
    backward's forward chain (its first pass) runs at that rate instead
    (the generic float32 backward's f32 FMAs), its time added to the
    other products'."""
    rows = x.shape[0] * x.shape[1]
    macs = sum(w.numel() for w in weights if w.dim() == 2)  # per row
    param_bytes = sum(w.numel() for w in weights) * 4
    hd = 0 if head_dir is None else head_dir.numel() * 4
    out = rows * (16 if head_dir is not None else 4)
    # The chain's products as the operations at `flops` that take as long.
    chain = 2 * macs * rows * (1 if chain_flops is None else flops / chain_flops)
    bwd = _bound(2 * x.numel() * 4 + 2 * hd + 2 * param_bytes + out,
                 chain + 4 * macs * rows, flops)
    if chain_flops is not None and bwd["bound_by"] == "operations":
        bwd["bound_peak"] = f"forward chain at {_PEAKS[chain_flops]}, then {_PEAKS[flops]}"
    return _bound(x.numel() * 4 + hd + param_bytes + out, 2 * macs * rows, flops), bwd


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

    def entry(name, replaces, err, ms, plain_ms, unfused_ms, bound):
        print(f"{name}: max abs err {err:.3g}; {ms:.3f} ms, twin {plain_ms:.3f} ms, "
              f"un-fused stack {unfused_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms")
        results.append(_entry(
            name, "tetranerf_torch/csrc/mlp.cu", replaces, err, ms, plain_ms, bound,
            unfused_ms=unfused_ms))

    def unfused_backward(fn, x_in, grads):
        """Time of the autograd backward alone of ``fn(x_in)`` (its
        forward recorded once, the graph kept)."""
        xg = x_in.clone().requires_grad_()
        outs = fn(xg)
        return _time_ms(lambda: torch.autograd.grad(
            outs, [xg, *params], grads, retain_graph=True, allow_unused=True), 5)

    # K4 / K4b: the field MLPs at 4096 x 257 rows.
    bound_fwd, bound_bwd = _mlp_bounds(x, head_dir, weights)
    fwd = (x, head_dir, weights, n_base, n_head, dt)
    err = _rel_check("fused_field_mlps", zip(mlp.fused_field_mlps(*fwd),
                                             mlp.fused_field_mlps_twin(*fwd)))
    with torch.no_grad():
        unfused = _time_ms(lambda: plain.field_mlps(x, d), 10)
    entry("fused_field_mlps", "tetranerf_tpu/ops/pallas_mlp.py:244", err,
          _time_ms(lambda: mlp.fused_field_mlps(*fwd), 10),
          _time_ms(lambda: mlp.fused_field_mlps_twin(*fwd), 3), unfused, bound_fwd)
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
                           (g_rgb, g_dens[..., 0])), bound_bwd)

    # K5 / K5b: the density MLP at 4096 x 128 rows (the coarse round).
    bound_fwd, bound_bwd = _mlp_bounds(x_c, None, w_dens)
    fwd = (x_c, w_dens, n_base, dt)
    err = _rel_check("fused_density_mlp", [(mlp.fused_density_mlp(*fwd),
                                           mlp.fused_density_mlp_twin(*fwd))])
    with torch.no_grad():
        unfused = _time_ms(lambda: plain.density_at(x_c), 10)
    entry("fused_density_mlp", "tetranerf_tpu/ops/pallas_mlp.py:415", err,
          _time_ms(lambda: mlp.fused_density_mlp(*fwd), 10),
          _time_ms(lambda: mlp.fused_density_mlp_twin(*fwd), 3), unfused, bound_fwd)
    bwd = (x_c, w_dens, g_c, n_base, dt)
    dx, grads = mlp.fused_density_mlp_backward(*bwd)
    dx_t, grads_t = mlp.fused_density_mlp_backward_twin(*bwd)
    err = _rel_check("fused_density_mlp_backward", [(dx, dx_t), *zip(grads, grads_t)])
    del dx, grads, dx_t, grads_t
    entry("fused_density_mlp_backward", "tetranerf_tpu/ops/pallas_mlp.py:448", err,
          _time_ms(lambda: mlp.fused_density_mlp_backward(*bwd), 10),
          _time_ms(lambda: mlp.fused_density_mlp_backward_twin(*bwd), 3),
          unfused_backward(plain.density_at, x_c, g_c[..., 0]), bound_bwd)
    del plain
    # The flagship's bucket shapes (512 rays; 257, 193 and 33 fine samples).
    timed = mlp_bucket_checks(model, dev, MLP_BUCKET_SHAPES, timed=True)
    for r in results:
        r["bucket_shapes"] = timed[r["name"]]
    return results


def mlp_bucket_checks(model, dev, shapes, timed=False):
    """K4, K4b, K5 and K5b against their twins at the shapes bucketed
    shading gives them: ``(rays, coarse samples, fine samples)`` per case,
    each held to ``MLP_NORM_RTOL`` and ``MLP_MAX_RTOL`` as in phase 8.
    With ``timed``, also each kernel's CUDA-event ms beside its bound:
    returns ``{wrapper: [{"shape", "ms", "bound_ms"}, ...]}``."""
    import torch
    from tetranerf_torch.ops import mlp

    cfg = model.config
    dt = model.compute_dtype
    n_base, n_head = len(model.mlp_base.layers), len(model.mlp_head.layers)
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for rays, n_coarse, n_fine in shapes:
        num_fine = n_coarse + n_fine + 1
        x = randn(rays, num_fine, cfg.field_dim)
        d = torch.nn.functional.normalize(randn(rays, 3), dim=1)
        g_rgb, g_dens = randn(rays, num_fine, 3), randn(rays, num_fine, 1)
        x_c, g_c = randn(rays, n_coarse, cfg.field_dim), randn(rays, n_coarse, 1)
        with torch.no_grad():
            head_dir, weights = model.fused_field_inputs(d)
            weights = [w.detach() for w in weights]
            w_dens = [w.detach() for w in model.density_weights()]
        label = f"at {rays} rays x {num_fine} / {n_coarse} samples"
        fwd = (x, head_dir, weights, n_base, n_head, dt)
        _rel_check(f"fused_field_mlps {label}",
                   zip(mlp.fused_field_mlps(*fwd), mlp.fused_field_mlps_twin(*fwd)))
        bwd = (x, head_dir, weights, g_rgb, g_dens, n_base, n_head, dt)
        dx, dhd, grads = mlp.fused_field_mlps_backward(*bwd)
        dx_t, dhd_t, grads_t = mlp.fused_field_mlps_backward_twin(*bwd)
        _rel_check(f"fused_field_mlps_backward {label}",
                   [(dx, dx_t), (dhd, dhd_t), *zip(grads, grads_t)])
        fwd_c = (x_c, w_dens, n_base, dt)
        _rel_check(f"fused_density_mlp {label}", [(mlp.fused_density_mlp(*fwd_c),
                                                   mlp.fused_density_mlp_twin(*fwd_c))])
        bwd_c = (x_c, w_dens, g_c, n_base, dt)
        dx, grads = mlp.fused_density_mlp_backward(*bwd_c)
        dx_t, grads_t = mlp.fused_density_mlp_backward_twin(*bwd_c)
        _rel_check(f"fused_density_mlp_backward {label}",
                   [(dx, dx_t), *zip(grads, grads_t)])
        print(f"fused MLP kernels {label}: within tolerance of their twins")
        if timed:
            del dx, dhd, grads, dx_t, dhd_t, grads_t
            field, dens = _mlp_bounds(x, head_dir, weights), _mlp_bounds(x_c, None, w_dens)
            for name, fn, args, bound in (
                    ("fused_field_mlps", mlp.fused_field_mlps, fwd, field[0]),
                    ("fused_field_mlps_backward", mlp.fused_field_mlps_backward, bwd,
                     field[1]),
                    ("fused_density_mlp", mlp.fused_density_mlp, fwd_c, dens[0]),
                    ("fused_density_mlp_backward", mlp.fused_density_mlp_backward,
                     bwd_c, dens[1])):
                ms = _time_ms(lambda: fn(*args), 10)
                rows = args[0].shape[0] * args[0].shape[1]
                print(f"  {name} {label} ({rows} rows): {ms:.4f} ms, bound "
                      f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
                out.setdefault(name, []).append(dict(
                    shape=list(args[0].shape), ms=ms, bound_ms=bound["bound_ms"]))
    return out


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
        train=True, uniforms=uniforms, bucket_steps=trainer.tuned_bucket_steps,
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
            train=True, bucket_steps=trainer.tuned_bucket_steps,
        )
    return sum(kept.values())


def _profile_steps(trainer, batches, median_ms):
    """Device time by kernel over ``batches`` train steps, and the share of
    the time in which the card ran no kernel: within the profiled window
    (the profiler's own host work slows the launches there) and against
    the unprofiled median step ``median_ms``."""
    import torch
    from tetranerf_torch.ops.stream_dtypes import STREAM_TYPES
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
        return {}
    memsets = [e for e in kernels if "memset" in e.name.lower()]
    print(f"profile: memsets per step {len(memsets) / len(batches):.1f}, "
          f"{sum(e.time_range.elapsed_us() for e in memsets) / 1e3 / len(batches):.4f} ms")
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
    per_step = {}
    for name, us in by_name.items():
        wrapper = _WRAPPER_OF.get(_port_kernel(name))
        if wrapper:
            if wrapper in _LOWP_INSTANCE:
                # A low-precision stream's instance of K2, K2b or K7, by the
                # row type in its template arguments.
                wrapper += next((t.suffix for t in STREAM_TYPES.values() if t.suffix
                                 and re.search(rf"\b{t.cuda_type}\b", name)), "")
            per_step[wrapper] = per_step.get(wrapper, 0.0) + us / 1e3 / len(batches)
    return per_step


_PORT_KERNELS = ("march_kernel", "blend_kernel", "blend_flag_kernel", "blend_bwd_kernel",
                 "interp_kernel", "interp_bwd_kernel", "scatter_add_kernel",
                 "mlp_fwd_kernel", "mlp_aux_kernel", "mlp_bwd_kernel", "sum_rows_kernel",
                 "gather_kernel")
# The wrapper (launch counter) of each port kernel with a bound per step.
_WRAPPER_OF = {"march_kernel": "march", "blend_kernel": "stream_blend_gather",
               # The flag pass K2's launch runs first for six software types.
               "blend_flag_kernel": "stream_blend_gather",
               "blend_bwd_kernel": "stream_blend_backward",
               "interp_kernel": "sample_interp",
               "interp_bwd_kernel": "sample_interp_backward",
               "scatter_add_kernel": "scatter_add_rows", "gather_kernel": "row_gather",
               # K4 and K5 run one kernel (K5: no head); K4b is three launches.
               "mlp_fwd_kernel": "fused_mlp_forward",
               "mlp_aux_kernel": "fused_field_mlps_backward",
               "mlp_bwd_kernel": "fused_field_mlps_backward",
               "sum_rows_kernel": "fused_field_mlps_backward"}


_LOWP_INSTANCE = ("stream_blend_gather", "stream_blend_backward", "scatter_add_rows")


def _port_kernel(name):
    """The function name of a port kernel in a profiler event, else None."""
    if "(anonymous namespace)::" not in name:
        return None
    fn = name.split("::")[1].split("(")[0].split("<")[0]
    return fn if fn in _PORT_KERNELS else None


@contextlib.contextmanager
def _recording_bounds():
    """Within the block, every call of a port wrapper on the model's path
    (K1, K2, K2b, K3, K3b, K7, K8; the batched ones where the path calls
    them) adds its bound in ms, from its own inputs (K1: from the steps its
    rays took), to the yielded dict under its launch counter. The bounds
    are computed on the card around each call, so time nothing inside the
    block."""
    import importlib

    import torch
    from tetranerf_torch.ops import fused, interp, mlp, scatter
    from tetranerf_torch.ops.stream_dtypes import F32, row_type, rows_type

    march_mod = importlib.import_module("tetranerf_torch.ops.march")

    sums = {}
    sites = [
        (fused, "stream_blend_gather_batch", _blend_batch_bound),
        (interp, "stream_blend_gather_batch", _blend_batch_bound),
        (fused, "sample_interp", _interp_bound),
        (interp, "sample_interp", _interp_bound),
        (interp, "sample_interp_backward", _interp_bwd_bound),
        (interp, "stream_blend_backward", _blend_bwd_bound),
        (interp, "scatter_add_rows_batch", _scatter_batch_bound),
        (scatter, "scatter_add_rows_batch", _scatter_batch_bound),
        (fused, "row_gather_batch", _gather_bound),
        (mlp, "fused_field_mlps", lambda x, hd, w, *_: _mlp_bounds(x, hd, w)[0]),
        (mlp, "fused_field_mlps_backward", lambda x, hd, w, *_: _mlp_bounds(x, hd, w)[1]),
        (mlp, "fused_density_mlp", lambda x, w, *_: _mlp_bounds(x, None, w)[0]),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]
    counters = {"stream_blend_gather_batch": "stream_blend_gather",
                "scatter_add_rows_batch": "scatter_add_rows",
                "row_gather_batch": "row_gather"}
    # The row type of a low-precision instance: the field's, K2b's output
    # type, the first job's values'.
    lowp_arg = {"stream_blend_gather_batch": lambda a: rows_type(a[0], a[2]),
                "stream_blend_backward": lambda a: row_type(a[4]) or F32,
                "scatter_add_rows_batch": lambda a: rows_type(a[0][0][1], a[2])}
    arity = {"stream_blend_gather_batch": 3, "stream_blend_backward": 5,
             "scatter_add_rows_batch": 3}
    # The arguments a bound reads: K2's not its row type (the rows' bytes
    # give it).
    bound_args = {"stream_blend_gather_batch": 2}

    def record(fn, bound):
        name = fn.__name__

        def call(*args):
            counter = counters.get(name, name)
            if name in lowp_arg:
                full = args + (None,) * (arity[name] - len(args))
                counter += lowp_arg[name](full).suffix
            cost = bound(*args[:bound_args.get(name, len(args))])
            sums[counter] = sums.get(counter, 0.0) + cost["bound_ms"]
            return fn(*args)
        return call

    march_intervals = march_mod.march_intervals

    def record_march(*args):
        out = march_intervals(*args)
        sums["march"] = sums.get("march", 0.0) + _march_bound(out)["bound_ms"]
        return out

    for (mod, attr, bound), (_, _, fn) in zip(sites, saved):
        setattr(mod, attr, record(fn, bound))
    march_mod.march_intervals = record_march
    try:
        yield sums
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        march_mod.march_intervals = march_intervals


def _kernel_group(name):
    if _port_kernel(name):
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
    step 1 alone (a steady step: no occupancy work), and the median step
    in ms."""
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

    prof = _profile_steps(trainer, batches[:2], med)
    if fused:
        # Each fused kernel's device ms per step beside its bound from the
        # step's own inputs (K4 and K5 share one kernel, so one line).
        with _recording_bounds() as bounds:
            trainer.train_step(batches[2])
        rows = {"fused_mlp_forward (K4 + K5)": (
                    prof.get("fused_mlp_forward"),
                    bounds["fused_field_mlps"] + bounds["fused_density_mlp"]),
                "fused_field_mlps_backward (K4b)": (
                    prof.get("fused_field_mlps_backward"),
                    bounds["fused_field_mlps_backward"])}
        print(f"{label}: fused kernels per step (ms by the profiler / bound ms): " +
              "; ".join(f"{k} {'not measured' if ms is None else f'{ms:.4f}'} / "
                        f"{b:.4f}" for k, (ms, b) in rows.items()))
    return launches, per_step, med


FLAGSHIP_KERNELS = TRAIN_KERNELS + ("row_gather",)


def _host_us(fn, calls, reps=10):
    """Host time to enqueue ``fn``'s launches (the card idle, nothing
    waited for), per launch: the median over ``reps``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(np.median(times))


def gather_checks(mesh, origins, directions):
    """Phase 11: K8 against its twin (bit for bit: a copy), against itself
    one table per launch, and against ``torch.index_select`` of the same
    rows and columns (``library_ms``), on one cold flagship step's bucket
    slices (one batch) and on a wide f32 table (one job)."""
    import torch
    from tetranerf_torch.ops import fused, gather

    res, order, plan = _cold_bucket_plan(mesh, origins, directions)
    jobs = fused.slice_march_jobs(res, order, plan, (origins, directions))
    per_bucket = len(jobs) // len(plan)
    # The 7 march tensors of each bucket: the per-table design's 56 launches.
    march_jobs = [j for i, j in enumerate(jobs) if i % per_bucket < 7]
    outs = gather.row_gather_batch(jobs)
    for (table, idx, w), out, ref in zip(jobs, outs, gather.row_gather_batch_twin(jobs)):
        what = f"{tuple(table.shape)} {table.dtype} width {w}"
        _check(torch.equal(out, ref), f"row_gather_batch: differs from the twin at {what}")
        _check(torch.equal(out, gather.row_gather(table, idx, w)),
               f"row_gather_batch: differs from the single-table K8 at {what}")
    del outs

    def batch(js):
        return lambda: gather.row_gather_batch(js)

    def single(js):
        return lambda: [gather.row_gather(*j) for j in js]

    def index_select(js):
        return lambda: [torch.index_select(table[:, :w], 0, idx) for table, idx, w in js]

    gen = torch.Generator(device=origins.device).manual_seed(11)
    wide = torch.randn(GATHER_TABLE, generator=gen, device=origins.device)
    rows = torch.randint(0, GATHER_TABLE[0], (GATHER_ROWS,), generator=gen,
                         device=origins.device, dtype=torch.int32)
    _check(torch.equal(gather.row_gather(wide, rows), gather.row_gather_twin(wide, rows)),
           "row_gather: differs from the twin on the wide table")
    entry = _entry(
        "row_gather", "tetranerf_torch/csrc/gather.cu",
        "tetranerf_tpu/ops/pallas_gather.py:73", 0.0,
        _time_ms(batch(jobs), 10), _time_ms(lambda: gather.row_gather_batch_twin(jobs), 10),
        _gather_bound(jobs), library_ms=_time_ms(index_select(jobs), 10),
        jobs_per_step=len(jobs), slice_bounds=[t for *_, t in plan],
        device_ms=_device_ms(batch(jobs)),
        library_device_ms=_device_ms(index_select(jobs)),
        single_table_ms=_time_ms(single(jobs), 10),
        single_table_device_ms=_device_ms(single(jobs)),
        host_us_per_launch_single=_host_us(single(march_jobs), len(march_jobs)),
        host_us_per_launch_batch=_host_us(batch(march_jobs), 1),
        march_jobs_ms=_time_ms(batch(march_jobs), 10),
        march_jobs_device_ms=_device_ms(batch(march_jobs)),
        march_jobs_single_ms=_time_ms(single(march_jobs), 10),
        march_jobs_library_ms=_time_ms(index_select(march_jobs), 10),
        march_jobs_library_device_ms=_device_ms(index_select(march_jobs)),
        march_jobs_bound_ms=_gather_bound(march_jobs)["bound_ms"],
        wide_table_ms=_time_ms(lambda: gather.row_gather(wide, rows), 20),
        wide_table_plain_ms=_time_ms(lambda: gather.row_gather_twin(wide, rows), 20),
        wide_table_library_ms=_time_ms(lambda: torch.index_select(wide, 0, rows), 20),
        wide_table_bound_ms=_gather_bound([(wide, rows, GATHER_TABLE[1])])["bound_ms"],
    )
    moved = sum(idx.shape[0] * (2 * w * table.element_size() + 4) for table, idx, w in jobs)
    print(f"row_gather: bit-exact against the twin and the single-table K8, job by job; "
          f"one cold step's slices of {origins.shape[0]} rays at bounds "
          f"{entry['slice_bounds']} = {len(jobs)} jobs, {moved / 1e6:.1f} MB moved, "
          f"one launch: {entry['ms']:.4f} ms (kernel {entry['device_ms']} ms by the "
          f"profiler; twin {entry['plain_ms']:.3f}; {len(jobs)} single-table K8 "
          f"{entry['single_table_ms']:.3f}, kernels {entry['single_table_device_ms']}; "
          f"{len(jobs)} index_select {entry['library_ms']:.3f}, kernels "
          f"{entry['library_device_ms']}; bound {entry['bound_ms']:.4f})")
    print(f"row_gather: the {len(march_jobs)} march-tensor copies: one batch "
          f"{entry['march_jobs_ms']:.4f} ms (kernel {entry['march_jobs_device_ms']}), "
          f"{len(march_jobs)} single-table K8 {entry['march_jobs_single_ms']:.3f} ms, "
          f"{len(march_jobs)} index_select {entry['march_jobs_library_ms']:.3f} ms (kernels "
          f"{entry['march_jobs_library_device_ms']}), bound "
          f"{entry['march_jobs_bound_ms']:.4f}; host us per K8 launch: "
          f"{entry['host_us_per_launch_single']:.1f} single-table x {len(march_jobs)}, "
          f"{entry['host_us_per_launch_batch']:.1f} for the one batch")
    print(f"row_gather: [{GATHER_TABLE[0]}, {GATHER_TABLE[1]}] f32 x {GATHER_ROWS} rows: "
          f"{entry['wide_table_ms']:.4f} ms (twin {entry['wide_table_plain_ms']:.4f}, "
          f"index_select {entry['wide_table_library_ms']:.4f}, bound "
          f"{entry['wide_table_bound_ms']:.4f})")
    return entry


def _ref_uniforms(model, trainer, num_rays, seed):
    """Numpy uniforms of one train forward at the trainer's bounds: one dict
    per bucket of the model's plan (or one dict when the forward is not
    bucketed)."""
    cfg = model.config
    rng = np.random.default_rng(seed)

    def draw(n, n_coarse, n_fine):
        return {"coarse": rng.random((n, n_coarse + 1), np.float32),
                "fine": rng.random((n, n_fine + 1), np.float32),
                "background": rng.random((n, 3), np.float32)}

    full = trainer.max_steps
    bounds = model.bucket_bounds(full, None, trainer.tuned_bucket_steps)
    if cfg.ray_buckets < 2 or all(b >= full for b in bounds):
        return draw(num_rays, cfg.num_samples, cfg.num_fine_samples)
    out = [None] * len(bounds)
    for k, lo, hi, _, n_coarse, n_fine in model.bucket_plan(num_rays, bounds):
        out[k] = draw(hi - lo, n_coarse, n_fine)
    return out


def _ref_step(label, model, trainer, batch, dev):
    """One 256-ray step's loss and field gradient of ``model`` at the
    trainer's bounds and cap, on the card and on the CPU twins."""
    uniforms = _ref_uniforms(model, trainer, REF_RAYS, 7)
    model_cpu = copy.deepcopy(model).to("cpu")
    loss_g, grad_g = _loss_and_field_grad(model, trainer.mesh, trainer, batch,
                                          uniforms, dev)
    loss_c, grad_c = _loss_and_field_grad(model_cpu, trainer.mesh.to("cpu"), trainer,
                                          batch, uniforms, "cpu")
    model.zero_grad(set_to_none=True)
    loss_err = abs(loss_g - loss_c) / loss_c
    grad_err = float((grad_g - grad_c).abs().max() / grad_c.abs().max())
    print(f"{label} vs CPU twins ({REF_RAYS} rays): loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(rel {loss_err:.3g}), field gradient max abs diff / max {grad_err:.3g}")
    _check(loss_err <= REF_LOSS_RTOL, f"{label} ref: loss rel err {loss_err}")
    _check(grad_err <= REF_GRAD_RTOL, f"{label} ref: field grad rel err {grad_err}")


def flagship_train_phase(colors, mesh_plain, dev, plain_median_ms, march_kernels=None):
    """Phase 12: the preset as it ships, trained through two retunes.
    Returns the trainer, the launch counts of the run and of one steady
    step after the first retune. ``march_kernels`` is the kernels one
    ``march()`` call launches (phase 3's count: the hull slab and K1)."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    cfg = tetranerf_preset()
    model = TetraNerf(cfg, mesh_plain.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(TrainConfig(), model, mesh_plain, device=dev)
    rng = np.random.default_rng(1)  # phase 7's five batches
    batches = [_train_batch(rng, TRAIN_RAYS) for _ in range(TRAIN_BATCHES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    losses, overflow, step_ms, log = [], [], [], io.StringIO()
    bounds = {}
    for step in range(FLAGSHIP_STEPS):
        b = batches[step % TRAIN_BATCHES]
        before = dict(cuda.launch_counts)
        t = time.perf_counter()
        with contextlib.redirect_stderr(log):
            m = trainer.train_step(b)
        losses.append(float(m["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        overflow.append(int(m["overflow_rays"]))
        if step in (0, 128, 256):
            bounds[step] = (trainer.max_steps, trainer.tuned_bucket_steps,
                            round(trainer.occ_depth_cap, 3))
        if step == 130:
            per_step = {k: n - before[k] for k, n in cuda.launch_counts.items()}
    launches = dict(cuda.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    retunes = [line for line in log.getvalue().splitlines() if line.startswith("# retune@")]
    for line in retunes:
        print(line)
    _check([line.split(":")[0] for line in retunes] == ["# retune@128", "# retune@256"],
           f"flagship train: retune lines {retunes}")
    cold = float(np.median(step_ms[1:128]))
    warm = float(np.median(step_ms[129:256]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"flagship train: {FLAGSHIP_STEPS} steps of {TRAIN_RAYS} rays; (bound, bucket "
          f"bounds, cap) at steps 0 / 128 / 256: {bounds}; median step {cold:.2f} ms "
          f"cold (steps 1-127) = {TRAIN_RAYS / cold * 1e3:.0f} rays/s, {warm:.2f} ms "
          f"after the first retune (steps 129-255) = {TRAIN_RAYS / warm * 1e3:.0f} rays/s; "
          f"phase 7 (ray_buckets=1) median {plain_median_ms:.2f} ms; ms of the retune "
          f"steps {round(step_ms[128], 2)} / {round(step_ms[256], 2)}; peak memory "
          f"{peak_gb:.2f} GB")
    print(f"flagship train: loss first 5 mean {first:.5f}, last 5 mean {last:.5f}; "
          f"losses {[round(x, 5) for x in losses[::20]]} (every 20th); overflow_rays "
          f"{overflow[::20]} (every 20th), max {max(overflow)}; occupancy mean "
          f"{float(trainer.occupancy.mean()):.3f}; launches {launches}; launches in "
          f"step 130 {per_step}")
    saved = _saved_bytes(trainer, batches[0], dev)
    print(f"flagship train: autograd keeps {saved / 1e9:.3f} GB for the backward of one "
          f"step after the retunes")
    _check(all(np.isfinite(losses)), f"flagship train: non-finite loss {losses}")
    _check(last < first, f"flagship train: loss did not fall ({first} -> {last})")
    for k in FLAGSHIP_KERNELS:
        _check(launches[k] > 0, f"flagship train: {k} did not launch: {launches}")
        _check(per_step[k] > 0, f"flagship train: {k} not in a steady step: {per_step}")
    # One K8 slice, one K2 over every bucket, K2b per bucket, one K7 into
    # the one field gradient.
    expected = {"row_gather": 1, "stream_blend_gather": 1,
                "stream_blend_backward": cfg.ray_buckets, "scatter_add_rows": 1}
    print("flagship train: launches per steady step: " + ", ".join(
        f"{k} {per_step[k]} (expected {n})" for k, n in expected.items()))
    for k, n in expected.items():
        _check(per_step[k] == n,
               f"flagship train: {k} launched {per_step[k]} times in a step, not {n}")

    ref_batch = _train_batch(rng, REF_RAYS)
    _ref_step("flagship train", trainer.model, trainer, ref_batch, dev)
    fused = TetraNerf(dataclasses.replace(cfg, fused_mlps=True), mesh_plain.num_vertices,
                      device=dev)
    fused.load_state_dict(trainer.model.state_dict())
    _ref_step("flagship train (fused MLPs)", fused, trainer, ref_batch, dev)
    # The fused kernels at a shallow bucket's shape: the shallowest bucket
    # of this batch at the tuned bounds, and the budgets' floor (16 + 16).
    bounds = fused.bucket_bounds(trainer.max_steps, None, trainer.tuned_bucket_steps)
    _, lo, hi, _, n_coarse, n_fine = fused.bucket_plan(TRAIN_RAYS, bounds)[0]
    mlp_bucket_checks(fused, dev, [(hi - lo, n_coarse, n_fine), (hi - lo, 16, 16)])
    del fused
    step_ms = _profile_steps(trainer, batches[:2], warm)
    with _recording_bounds() as step_bounds:
        trainer.train_step(batches[2])
    step_ms = {k: dict(ms=step_ms.get(k), bound_ms=step_bounds[k], launches=per_step[k])
               for k in step_bounds}
    print(f"flagship train: march() per steady step: {per_step['march']} call(s), each "
          f"{march_kernels} kernels (the hull slab and one K1 launch, no fill or epilogue "
          f"kernel): {per_step['march'] * march_kernels if march_kernels else None} launches")
    _check(per_step["march"] == 1, f"flagship train: K1 {per_step['march']} times in a step")
    print("flagship train: port kernels per steady step after the retune (ms by the "
          "profiler, bound ms from the step's own inputs, launches): " + "; ".join(
              f"{k} {v['ms'] if v['ms'] is None else round(v['ms'], 4)} / "
              f"{v['bound_ms']:.4f} / {v['launches']}" for k, v in step_ms.items()))
    print("flagship train: K2, K2b and K7 per steady step against the earlier designs' "
          "(PERF.md): " + "; ".join(
        f"{k} {step_ms[k]['ms']} (was {ms})" for k, ms in EARLIER_PHASE12_MS.items()))
    _k7_step_jobs(trainer, batches[3])
    return trainer, launches, per_step, step_ms, cold


def _k7_step_jobs(trainer, batch):
    """What K7 gets in one ``trainer.train_step(batch)``: its jobs' rows,
    the rows it reads (each ray's used slots: every job carries its rays'
    ``num_valid``) and the padding rows it does not, nonzero rows and
    16-byte vectors of f32, distinct ids, id 0's rows and the longest run
    of one id in input order; its kernel time on them (as the step runs
    it), on the same jobs with every slot read, and on the same ids with
    zero rows (the same bytes read, no atomic issued), against the twin
    within the scatter tolerance."""
    import torch
    from tetranerf_torch.ops import interp, scatter

    seen = []
    real = interp.scatter_add_rows_batch

    def spy(jobs, num_rows, row_type=None):
        seen.append(([tuple(x.clone() for x in job) for job in jobs], num_rows))
        return real(jobs, num_rows, row_type)

    interp.scatter_add_rows_batch = spy
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            trainer.train_step(batch)
    finally:
        interp.scatter_add_rows_batch = real
    _check(len(seen) == 1, f"flagship train: K7 called {len(seen)} times in a step")
    jobs, num_v = seen[0]
    _check(all(len(job) == 3 for job in jobs), "flagship train: K7 jobs without num_valid")
    err = _max_err(scatter.scatter_add_rows_batch(jobs, num_v),
                   scatter.scatter_add_rows_batch_twin(jobs, num_v))
    _check(err <= TOLERANCES["scatter_add_rows"], f"flagship train: K7 of a step: err {err}")
    every_slot = [job[:2] for job in jobs]
    ids = torch.cat([i for i, _ in every_slot]).long()
    vals = torch.cat([v for _, v in every_slot])
    read = sum(scatter.used_rows(job)[0].numel() for job in jobs)
    change = torch.ones_like(ids, dtype=torch.bool)
    change[1:] = ids[1:] != ids[:-1]
    starts = torch.nonzero(change).flatten()
    zeros = [(i, torch.zeros_like(v), nv) for i, v, nv in jobs]
    stats = dict(
        jobs=len(jobs), rows=int(ids.numel()), read_rows=read,
        padding_rows_not_read=int(ids.numel()) - read,
        valid_rows=int(((ids >= 0) & (ids < num_v)).sum()),
        nonzero_rows=int((vals != 0).any(dim=1).sum()),
        nonzero_vectors=int((vals.reshape(vals.shape[0], -1, 4) != 0).any(dim=2).sum()),
        vectors=int(vals.numel() // 4), distinct_ids=int(ids.unique().numel()),
        id0_rows=int((ids == 0).sum()),
        longest_run=int(torch.diff(starts, append=starts.new_tensor([ids.numel()])).max()),
        max_abs_err=err,
        ms=_time_ms(lambda: scatter.scatter_add_rows_batch(jobs, num_v), 20),
        every_slot_ms=_time_ms(lambda: scatter.scatter_add_rows_batch(every_slot, num_v), 20),
        device_ms=_device_ms(lambda: scatter.scatter_add_rows_batch(jobs, num_v)),
        every_slot_device_ms=_device_ms(
            lambda: scatter.scatter_add_rows_batch(every_slot, num_v)),
        zero_rows_device_ms=_device_ms(lambda: scatter.scatter_add_rows_batch(zeros, num_v)),
        bound_ms=_scatter_batch_bound(jobs, num_v)["bound_ms"],
        every_slot_bound_ms=_scatter_batch_bound(every_slot, num_v)["bound_ms"])
    print(f"flagship train: K7 on a steady step's jobs: {stats}")
    print(f"flagship train: K7 on a steady step's jobs {stats['device_ms']} ms by the "
          f"profiler, {stats['ms']:.4f} by CUDA events (the earlier design's per step, "
          f"PERF.md: {EARLIER_PHASE12_MS['scatter_add_rows']}), bound {stats['bound_ms']:.4f}; "
          f"{stats['padding_rows_not_read']} padding rows of {stats['rows']} not read; every "
          f"slot read {stats['every_slot_device_ms']} ms by the profiler, "
          f"{stats['every_slot_ms']:.4f} by CUDA events, bound "
          f"{stats['every_slot_bound_ms']:.4f}")


def flagship_render_phase(trainer, dev):
    """Phase 13: ``Trainer.render_rays`` of the flagship trainer, and 256
    rays against the CPU twins (both rendered as one 256-ray chunk: the
    buckets are quantiles of the chunk's own rays)."""
    import torch
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.render import Renderer
    from tetranerf_torch.utils.synthetic import sample_sphere_rays

    origins, directions = sample_sphere_rays(
        np.random.default_rng(0), REQUESTS * REQUEST_RAYS
    )
    trainer.render_rays(origins[:CHUNK], directions[:CHUNK], chunk=CHUNK)  # warm-up
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t = time.perf_counter()
    outs = []
    for i in range(REQUESTS):
        sl = slice(i * REQUEST_RAYS, (i + 1) * REQUEST_RAYS)
        outs.append(trainer.render_rays(origins[sl], directions[sl], chunk=CHUNK))
    seconds = time.perf_counter() - t
    launches = dict(cuda.launch_counts)
    out = {k: np.concatenate([o_[k] for o_ in outs]) for k in outs[0]}
    print(f"flagship render: {REQUESTS} x {REQUEST_RAYS} rays in {seconds:.3f} s = "
          f"{REQUESTS * REQUEST_RAYS / seconds:.0f} rays/s at bound {trainer.max_steps}, "
          f"buckets {trainer.tuned_bucket_steps}, cap {trainer.occ_depth_cap:.3f}; "
          f"overflow {int(out['traversal_overflow'].sum())}, hit "
          f"{int(out['ray_mask'].sum())}, launches {launches}")
    for k in RENDER_KERNELS + ("row_gather",):
        _check(launches[k] > 0, f"flagship render: {k} did not launch: {launches}")
    chunks = REQUESTS * REQUEST_RAYS // CHUNK
    print(f"flagship render: launches per chunk: K8 {launches['row_gather'] / chunks}, "
          f"K2 {launches['stream_blend_gather'] / chunks}")
    for k in ("row_gather", "stream_blend_gather"):
        _check(launches[k] == chunks,
               f"flagship render: {k} launched {launches[k]} times in {chunks} chunks")
    for k in ("rgb", "depth", "accumulation"):
        _check(np.isfinite(out[k]).all(), f"flagship render: non-finite {k}")
    _check(out["rgb"].min() >= 0.0 and out["rgb"].max() <= 1.0, "flagship render: rgb range")

    o, d = origins[:REF_RAYS], directions[:REF_RAYS]
    got = trainer.render_rays(o, d, chunk=REF_RAYS)
    ref = Renderer(copy.deepcopy(trainer.model).to("cpu"), trainer.mesh.to("cpu"), "cpu",
                   occ_depth_cap=trainer.occ_depth_cap, max_steps=trainer.max_steps,
                   bucket_steps=trainer.tuned_bucket_steps).render_rays(o, d, chunk=REF_RAYS)
    _check(np.array_equal(ref["ray_mask"], got["ray_mask"]), "flagship ref: ray_mask")
    _check(np.array_equal(ref["traversal_overflow"], got["traversal_overflow"]),
           "flagship ref: overflow")
    rgb_err = float(np.abs(ref["rgb"] - got["rgb"]).max())
    _check(rgb_err <= RENDER_RGB_TOL, f"flagship ref: rgb max abs err {rgb_err}")
    print(f"flagship render vs CPU twins ({REF_RAYS} rays): rgb max abs err {rgb_err:.3g}")
    return launches


def _png_decode_ms(tmp):
    """Host ms to decode one 800x800 RGBA PNG by ``utils/png.py``: rows of
    the sub filter (the row path; what ``write_png`` writes) and rows of the
    Paeth filter (the wavefront), each checked against the pixels."""
    import struct
    import zlib

    from tetranerf_torch.utils import png

    yy, xx = np.mgrid[0:800, 0:800]
    img = np.stack([np.sin(xx / 30.0 + k) * 100 + np.cos(yy / 17.0) * 20 + 128
                    for k in range(4)], axis=-1).astype(np.uint8)
    sub = tmp / "sub.png"
    png.write_png(sub, img)
    # Paeth rows: the predictor from the raw neighbours, vectorised.
    raw = img.reshape(800, -1).astype(np.int16)
    a = np.pad(raw, ((0, 0), (4, 0)))[:, :-4]
    b = np.pad(raw, ((1, 0), (0, 0)))[:-1]
    c = np.pad(raw, ((1, 0), (4, 0)))[:-1, :-4]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((800, 1), 4), (raw - pred) & 255], axis=1)
    paeth = tmp / "paeth.png"
    with open(paeth, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        for kind, body in ((b"IHDR", struct.pack(">IIBBBBB", 800, 800, 8, 6, 0, 0, 0)),
                           (b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes())),
                           (b"IEND", b"")):
            f.write(struct.pack(">I", len(body)) + kind + body
                    + struct.pack(">I", zlib.crc32(kind + body)))
    out = {}
    for name, path in (("sub", sub), ("paeth", paeth)):
        _check(np.array_equal(png.read_png(path), img), f"png: {name} decode differs")
        times = []
        for _ in range(5):
            t = time.perf_counter()
            png.read_png(path)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = float(np.median(times))
    return out


def cli_phase(scene, dev, tmp):
    """Phase 14: train the sphere dataset from disk through the port's CLI,
    under the directory ``tmp`` (``sphere/``, ``out/final/``). ``scene`` is
    phase 1's ``(points, colors, cells)``. Returns the kernel launches of
    the 300-step run and its final metrics."""
    import re

    import torch
    from tetranerf_torch.models import TetraNerf
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.training import cli
    from tetranerf_torch.training.checkpoints import reference_state_dict
    from tetranerf_torch.training.trainer import Trainer
    from tetranerf_torch.utils.synthetic_dataset import write_sphere_dataset

    t_phase = time.perf_counter()
    data, out = tmp / "sphere", tmp / "out"
    dec = _png_decode_ms(tmp)
    print(f"cli: png decode of one 800x800 RGBA image on the host, median of 5: "
          f"{dec['sub']:.1f} ms with sub rows (the row path), {dec['paeth']:.1f} ms "
          f"with Paeth rows (the wavefront)")
    t = time.perf_counter()
    write_sphere_dataset(data, scene=scene)
    print(f"cli: sphere dataset (40 + 8 views at 256^2, {len(scene[0])} points) "
          f"written in {time.perf_counter() - t:.2f} s")

    # Instrumentation of this run only: when the first step ends, and
    # the eval renders' rays and seconds (render_rays returns numpy,
    # so each call has finished on the card when it returns).
    marks = {"first_step": None, "render_rays": 0, "render_s": 0.0}
    train_step, render_rays = Trainer.train_step, Trainer.render_rays

    def timed_step(self, batch, uniforms=None):
        m = train_step(self, batch, uniforms)
        if marks["first_step"] is None:
            float(m["loss"])
            marks["first_step"] = time.perf_counter()
        return m

    def timed_render(self, origins, directions, *a, **k):
        t = time.perf_counter()
        r = render_rays(self, origins, directions, *a, **k)
        marks["render_s"] += time.perf_counter() - t
        marks["render_rays"] += len(origins)
        return r

    args = ["--data", str(data), "--tetrahedra-path", str(data / "tetra.npz"),
            "--device", str(dev), "--log-every", "50",
            "--steps-per-eval-batch", "100", "--steps-per-eval-image", "200",
            "--steps-per-eval-all-images", str(CLI_STEPS)]
    stdout, stderr = io.StringIO(), io.StringIO()
    Trainer.train_step, Trainer.render_rays = timed_step, timed_render
    try:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t_main = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            trainer = cli.main(args + ["--output-dir", str(out),
                                       "--max-num-iterations", str(CLI_STEPS)])
        main_s = time.perf_counter() - t_main
        launches = dict(cuda.launch_counts)
    finally:
        Trainer.train_step, Trainer.render_rays = train_step, render_rays
    log = stderr.getvalue().splitlines()
    for line in log:
        if not line.startswith("step "):
            print("cli:", line)
    steps = [(int(m.group(1)), float(m.group(2)), float(m.group(3).replace(",", "")))
             for m in (re.match(r"step (\d+)/\d+ loss=(\S+) psnr=\S+ rays/s=(\S+)", x)
                       for x in log) if m]
    evals = {int(m.group(1)): float(m.group(2))
             for m in (re.match(r"eval step (\d+): psnr=(\S+)", x) for x in log) if m}
    final = json.loads(stdout.getvalue().strip().splitlines()[-1])
    print(f"cli: main() to the end of step 1 {marks['first_step'] - t_main:.2f} s "
          f"(dataset load, mesh build, model, the bound tune; the kernels were built "
          f"in phase 2); {CLI_STEPS} steps, evals and the final eval in {main_s:.2f} s")
    print("cli: fit's log lines (step, loss, rays/s since step 1, eval time "
          f"included after step 100): {steps}")
    print(f"cli: eval renders {marks['render_rays']} rays in {marks['render_s']:.3f} s "
          f"= {marks['render_rays'] / marks['render_s']:.0f} rays/s; held-out "
          f"psnr of the eval batches {evals}; final {final}")
    print(f"cli: launches {launches}")

    _check([s[0] for s in steps] == list(range(50, CLI_STEPS + 1, 50)),
           f"cli: log steps {steps}")
    _check(all(np.isfinite(s[1]) for s in steps), f"cli: non-finite loss {steps}")
    _check(sorted(evals) == [100, 200, 300], f"cli: eval steps {sorted(evals)}")
    _check(evals[300] > evals[100], f"cli: eval psnr did not rise {evals}")
    _check(any(x.startswith("eval-image step 200") for x in log)
           and any(x.startswith(f"eval-all-images step {CLI_STEPS}") for x in log),
           "cli: image evals missing")
    _check([x.split(":")[0] for x in log if x.startswith("# retune@")]
           == ["# retune@128", "# retune@256"], "cli: retune lines")
    _check(final["eval_split"] == "test", f"cli: eval split {final}")
    _check(0.0 < final["psnr"] < 100.0 and -1.0 <= final["mipnerf_ssim"] <= 1.0
           and -1.0 <= final["skimage_ssim"] <= 1.0, f"cli: final metrics {final}")
    for k in FLAGSHIP_KERNELS:
        _check(launches[k] > 0, f"cli: {k} did not launch: {launches}")

    # final/ into a fresh trainer: the weights and the occupancy column.
    model = TetraNerf(trainer.model.config, trainer.mesh.num_vertices,
                      num_train_images=40, device=dev)
    fresh = Trainer(trainer.config, model,
                    trainer.mesh.with_occupancy(torch.zeros_like(trainer.occupancy)),
                    device=dev)
    fresh.restore_checkpoint(out / "final")
    want, got = reference_state_dict(trainer.model), reference_state_dict(fresh.model)
    _check(fresh.step == trainer.step == CLI_STEPS, f"cli: restored step {fresh.step}")
    for k in want:
        _check(np.array_equal(want[k], got[k]), f"cli: restored {k} differs")
    _check(torch.equal(fresh.mesh.march_table[:, 24], trainer.mesh.march_table[:, 24]),
           "cli: restored occupancy column differs")
    del fresh, model, trainer
    torch.cuda.empty_cache()

    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        resumed = cli.main(args + ["--output-dir", str(tmp / "resumed"),
                                   "--max-num-iterations", str(CLI_RESUME_STEPS),
                                   "--load-checkpoint", str(out / "final")])
    _check(resumed.step == CLI_STEPS + CLI_RESUME_STEPS, f"cli: resumed step {resumed.step}")
    print(f"cli: resumed from final/ for {CLI_RESUME_STEPS} steps (with its final eval) "
          f"in {time.perf_counter() - t:.2f} s; restored weights and occupancy bit-equal")
    del resumed
    torch.cuda.empty_cache()
    print(f"cli: phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return launches, final


def _cache_bytes(cache):
    """Device bytes of a ``Trainer.cache_camera`` cache: every chunk's march
    tensors (its vertex stream included) and padded rays."""
    import torch

    total = 0
    for res, o, d in cache["chunks"]:
        for x in [*res, *res.stream, o, d]:
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
    return total


def _post_png(port, body, tmp):
    """A viewer frame, decoded by ``utils/png.py`` (through a file under
    ``tmp``), and the seconds the request took."""
    import urllib.request

    from tetranerf_torch.utils.png import read_png

    t = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/render", method="POST",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        _check(r.headers["Content-Type"] == "image/png", "serve: frame is not a PNG")
        data = r.read()
    seconds = time.perf_counter() - t
    path = tmp / "frame.png"
    path.write_bytes(data)
    return read_png(path), seconds


def _missed_frame_split(viewer, trainer, full_frame):
    """The viewer's caches dropped and the full frame asked for again: its
    seconds, the host seconds inside ``Trainer.cache_camera`` (each call
    synchronised at its end), and the card's milliseconds of every
    ``march()`` and K1 launch inside it (CUDA events around each call)."""
    import importlib

    import torch
    from tetranerf_torch.ops import fused

    march_mod = importlib.import_module("tetranerf_torch.ops.march")
    spans = {"march": [], "k1": []}
    host = [0.0]

    def evented(fn, key):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return call

    cache_camera = trainer.cache_camera

    def timed_cache(*args, **kwargs):
        t = time.perf_counter()
        out = cache_camera(*args, **kwargs)
        torch.cuda.synchronize()
        host[0] += time.perf_counter() - t
        return out

    saved = fused.march, march_mod.march_intervals
    viewer._caches.clear()
    trainer.cache_camera = timed_cache
    fused.march = evented(fused.march, "march")
    march_mod.march_intervals = evented(march_mod.march_intervals, "k1")
    try:
        frame_s, _ = full_frame()
    finally:
        fused.march, march_mod.march_intervals = saved
        del trainer.cache_camera
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    return dict(frame_s=frame_s, cache_camera_s=host[0], march_ms=ms["march"],
                k1_ms=ms["k1"], marches=len(spans["march"]))


def serve_phase(tmp, dev, cli_final):
    """Phase 15: serve phase 14's ``final/`` checkpoint: the render CLI over
    the 8 test views, the viewer (page, a fast 400^2 frame, an 800^2 pose
    as 8 progressive bands twice: misses, then hits on the cached
    marches), and the live viewer while the restored trainer trains.
    ``cli_final`` is phase 14's final metrics. Returns the launches of the
    render CLI, of every viewer request and of the cached bands alone."""
    import urllib.request

    import torch
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.render import Renderer
    from tetranerf_torch.scripts import render
    from tetranerf_torch.training.datasets import load_dataset
    from tetranerf_torch.utils.png import read_png
    from tetranerf_torch.viewer import ViewerServer, _camera_rays, _look_at

    t_phase = time.perf_counter()
    data, final = tmp / "sphere", tmp / "out" / "final"
    args = ["--checkpoint", str(final), "--data", str(data), "--tetrahedra-path",
            str(data / "tetra.npz"), "--output", str(tmp / "renders"), "--device", str(dev)]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        mean = render.main(args)
    render_s = time.perf_counter() - t
    render_launches = dict(cuda.launch_counts)
    with open(tmp / "renders" / "metrics.json") as f:
        saved = json.load(f)
    _check(saved == mean and all(np.isfinite(v) for v in saved.values()),
           f"serve render: metrics.json {saved}")
    for k in RENDER_KERNELS:
        _check(render_launches[k] > 0, f"serve render: {k} did not launch: {render_launches}")
    print(f"serve render: tetranerf-torch-render over the 8 test views in "
          f"{render_s:.2f} s (mesh build and restore included): psnr {mean['psnr']:.3f} "
          f"(phase 14's final eval {cli_final['psnr']:.3f}: a checkpoint holds neither "
          f"the tuned bounds nor the cap), mipnerf_ssim {mean['mipnerf_ssim']:.4f}, "
          f"render_rays_per_sec {mean['render_rays_per_sec']:.0f}; launches "
          f"{render_launches}")

    t = time.perf_counter()
    trainer, test = render.load_trainer(final, data, "test", data / "tetra.npz",
                                        device=dev)
    h, w = test.height, test.width
    pngs = sorted((tmp / "renders").glob("test_*.png"))
    _check(len(pngs) == 2 * test.num_images, f"serve render: {len(pngs)} PNGs")
    shapes = {read_png(x).shape for x in pngs}
    _check(shapes == {(h, w, 3), (h, w)}, f"serve render: PNG shapes {shapes}")
    o, d = test.camera_rays(0)
    want = trainer.render_rays(o, d, chunk=16384)["rgb"].reshape(h, w, 3)
    got = read_png(tmp / "renders" / "test_0000.png").astype(np.float32) / 255.0
    err = float(np.abs(got - np.clip(want, 0, 1)).max())
    _check(err <= RENDER_RGB_TOL, f"serve render: view 0 rgb max abs err {err}")
    print(f"serve render: view 0's PNG against render_rays of a trainer restored the "
          f"same way ({time.perf_counter() - t:.2f} s): max abs err {err:.4f}")

    viewer = ViewerServer(trainer, port=0, chunk=16384, host="127.0.0.1").start()
    try:
        port = viewer.port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60) as r:
            _check("orbit" in r.read().decode(), "serve viewer: page")
        pos, side = [0.3, 2.4, 0.6], SERVE_FULL_SIDE
        band = side // SERVE_BANDS
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        fast = {"position": pos, "side": SERVE_FAST_SIDE, "quality": "fast"}
        img, fast_s = _post_png(port, fast, tmp)
        _check(img.shape == (SERVE_FAST_SIDE,) * 2 + (3,),
               f"serve viewer: fast frame {img.shape}")
        fast_launches = dict(cuda.launch_counts)

        def full_frame():
            before = dict(cuda.launch_counts)
            t = time.perf_counter()
            for y in range(0, side, band):
                img, _ = _post_png(port, {"position": pos, "side": side, "quality": "full",
                                          "rows": [y, y + band]}, tmp)
                _check(img.shape == (band, side, 3), f"serve viewer: band {img.shape}")
            return time.perf_counter() - t, {k: n - before[k]
                                             for k, n in cuda.launch_counts.items()}

        miss_s, miss = full_frame()
        hit_s, hits = full_frame()
        split = _missed_frame_split(viewer, trainer, full_frame)
        viewer_launches = dict(cuda.launch_counts)
        caches = list(viewer._caches.values())
        cache_gb = sum(_cache_bytes(c) for c in caches) / 1e9
        print(f"serve viewer: fast {SERVE_FAST_SIDE}^2 frame {fast_s * 1e3:.1f} ms "
              f"(launches {fast_launches}); first full {side}^2 frame in "
              f"{SERVE_BANDS} bands (cache misses) "
              f"{miss_s:.3f} s; the cached refine {hit_s:.3f} s = "
              f"{side * side / hit_s:.0f} rays/s; the {len(caches)} cached bands hold "
              f"{cache_gb:.3f} GB on the device; launches on the misses {miss}, on the "
              f"hits {hits}")
        print(f"serve viewer: missed minus cached frame {miss_s - hit_s:.3f} s; a third "
              f"frame with the caches dropped ({split['frame_s']:.3f} s) spent "
              f"{split['cache_camera_s']:.3f} s in cache_camera (host clock, to its "
              f"end on the card), of which march() {split['march_ms']:.2f} ms and K1 "
              f"{split['k1_ms']:.2f} ms on the card (CUDA events, {split['marches']} "
              f"calls), the rest the host's launches, the depth sort's transfer and "
              f"sort")
        _check(len(caches) == SERVE_BANDS, f"serve viewer: {len(caches)} cached bands")
        _check(miss["march"] > 0, f"serve viewer: K1 not launched on the misses: {miss}")
        _check(hits["march"] == 0, f"serve viewer: K1 launched on the hits: {hits}")
        for k in ("stream_blend_gather", "sample_interp"):
            _check(hits[k] > 0, f"serve viewer: {k} not launched on the hits: {hits}")

        # Band 0's dense re-shade against the render forward of its rays. A
        # restored trainer has no tuned bucket bounds, so render_rays shades
        # at the untuned linear split, which cuts rays deeper than their
        # bucket's bound (the traversal_overflow count): the check takes the
        # forward with every bucket at the full bound, which cuts nothing,
        # and the gap to render_rays is printed beside it.
        ro, rd = _camera_rays(_look_at(pos), side, viewer.camera_angle_x)
        ro, rd = ro[: band * side], rd[: band * side]
        dense = trainer.render_cached(caches[0])
        full = trainer.max_steps
        ref = Renderer(trainer.model, trainer.mesh, dev, occ_depth_cap=trainer.occ_depth_cap,
                       max_steps=full, bucket_steps=(full,) * (trainer.model.config.ray_buckets - 1)
                       ).render_rays(ro, rd, chunk=16384)
        err = float(np.abs(dense["rgb"] - ref["rgb"]).max())
        rays = trainer.render_rays(ro, rd, chunk=16384)
        print(f"serve viewer: band 0's dense re-shade against the forward at the full "
              f"bound {full}: rgb max abs err {err:.3g}; against render_rays (untuned "
              f"bucket bounds {trainer.model.bucket_bounds(full)}): "
              f"{float(np.abs(dense['rgb'] - rays['rgb']).max()):.3g}, with "
              f"{int(rays['traversal_overflow'].sum())} of {band * side} rays cut")
        _check(err <= RENDER_RGB_TOL, f"serve viewer: dense re-shade rgb max abs err {err}")

        # Live: train on one thread while the main thread asks for frames.
        train = load_dataset(data, "train")
        rng = np.random.default_rng(3)
        batches = [train.sample_ray_batch(rng, TRAIN_RAYS) for _ in range(SERVE_LIVE_STEPS)]
        step, version = trainer.step, trainer.march_version
        errors, updates = [], []
        update_occupancy = trainer.update_occupancy
        trainer.update_occupancy = lambda b: updates.append(trainer.step) or update_occupancy(b)

        def train_loop():
            try:
                for b in batches:
                    trainer.train_step(b)
                torch.cuda.synchronize()
            except BaseException as exc:  # re-raised on the main thread
                errors.append(exc)

        thread = threading.Thread(target=train_loop)
        t = time.perf_counter()
        thread.start()
        try:
            frame_s = [_post_png(port, fast, tmp)[1] for _ in range(4)]
        finally:
            thread.join(timeout=300)
        live_s = time.perf_counter() - t
        _check(not thread.is_alive(), "serve live: the train thread did not end")
        del trainer.update_occupancy
        if errors:
            raise errors[0]
        _check(trainer.step == step + SERVE_LIVE_STEPS, f"serve live: step {trainer.step}")
        _check(trainer.march_version > version, "serve live: march_version did not move")
        # The cadence counts the restored trainer's own steps, as JAX's does.
        _check(updates == [step], f"serve live: occupancy updates at steps {updates}")
        before = cuda.launch_counts["march"]
        _post_png(port, {"position": pos, "side": side, "quality": "full",
                         "rows": [0, band]}, tmp)
        _check(cuda.launch_counts["march"] > before,
               "serve live: the full frame after training did not march")
        print(f"serve live: {SERVE_LIVE_STEPS} train steps of {TRAIN_RAYS} rays and 4 "
              f"fast frames "
              f"({', '.join(f'{x * 1e3:.1f}' for x in frame_s)} ms) in {live_s:.2f} s; "
              f"occupancy updated at step(s) {updates} (restored at step {step}); "
              f"march_version {version} -> {trainer.march_version}; the next full band "
              f"marched again")
    finally:
        viewer.stop()
    del trainer, viewer
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_phase
    print(f"serve: phase 15 took {elapsed:.1f} s")
    _check(elapsed < 30.0, f"serve: phase 15 took {elapsed:.1f} s, not under 30 s")
    return render_launches, viewer_launches, hits


SKIP_RESOLUTION = 64
SKIP_STEPS = 160
MERGED_STEPS = 72


def _camera_batch(rng, num_rays):
    from tetranerf_torch.utils.synthetic import camera_ray_targets, sample_camera_rays

    o, d = sample_camera_rays(rng, num_rays)
    return {"origins": o, "directions": d, "rgb": camera_ray_targets(o, d)}


def _locate_bound(rows, num_points):
    """K9 from the rows its walks need (``rows``): per row its four planes
    and neighbour ids read (80 bytes) and four planes evaluated (28 flops);
    per point its position and seed read and its cell written (20 bytes)."""
    return _bound(rows * 80 + num_points * 20, rows * 28)


def locate_checks(mesh, chase_ns):
    """Phase 16a: K9 against its twin on the camera mesh's 64^3 voxel
    centres from their nearest vertices' cells, as ``make_skip_setup`` calls
    it: every cell exactly; its time by CUDA events, its bound and its
    latency floor (the longest walk's rows x ``chase_ns``)."""
    import torch
    from tetranerf_torch.ops.march import locate_points, locate_points_twin
    from tetranerf_torch.ops.skip_grid import LOCATE_STEPS, voxel_centers_and_seeds

    dev = mesh.device
    centers, seeds = voxel_centers_and_seeds(mesh, SKIP_RESOLUTION)
    points, seeds = torch.from_numpy(centers).to(dev), torch.from_numpy(seeds).to(dev)
    args = (mesh.march_table, seeds, points, LOCATE_STEPS)
    ker = locate_points(*args)
    twin, rows = locate_points_twin(*args, return_rows=True)
    _check(torch.equal(ker, twin), "locate: cells differ from the twin")
    longest = int(rows.max())
    entry = _entry(
        "locate", "tetranerf_torch/csrc/march.cu", "tetranerf_tpu/ops/fused.py:87", 0.0,
        _time_ms(lambda: locate_points(*args), 10),
        _time_ms(lambda: locate_points_twin(*args), 3),
        _locate_bound(int(rows.sum()), points.shape[0]),
        latency_floor_ms=longest * chase_ns / 1e6, longest_walk_rows=longest,
        walk_rows_mean=float(rows.float().mean()),
        outside_hull=int((ker < 0).sum()), points=points.shape[0],
    )
    print(f"locate: {points.shape[0]} voxel centres, every cell equal to the twin's "
          f"({entry['outside_hull']} outside the hull); {entry['ms']:.4f} ms by CUDA "
          f"events (twin {entry['plain_ms']:.3f}), bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}), latency floor {entry['latency_floor_ms']:.4f} ms "
          f"({longest} rows x {chase_ns:.1f} ns); rows a walk {entry['walk_rows_mean']:.2f} "
          f"mean")
    return entry


def _skip_table_bound(occ, setup, max_dist=16):
    """``build_skip_table`` from its inputs: the EMA, the anchors, the
    vertex and centroid voxels read once and the table written once (bytes);
    27 compares a voxel for the dilation and each of the ``max_dist``
    Chebyshev rounds (operations)."""
    voxels = setup.anchors.numel()
    num_bytes = sum(x.numel() * x.element_size() for x in (occ, *setup)) + voxels * 32
    return _bound(num_bytes, voxels * 27 * (max_dist + 1))


def _skip_run(cfg, colors, mesh_plain, dev, batches, label):
    """``SKIP_STEPS`` train steps of the preset ``cfg`` on the camera batches
    in turn: the trainer, the losses, the ms of each step, the launches, and
    the step at which a skip grid attached (None)."""
    import torch
    from tetranerf_torch.models import TetraNerf
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    model = TetraNerf(cfg, mesh_plain.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(TrainConfig(), model, mesh_plain, device=dev)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    losses, step_ms, attach, log = [], [], None, io.StringIO()
    versions = []
    for step in range(SKIP_STEPS):
        had = trainer.mesh.has_skip_grid
        t = time.perf_counter()
        with contextlib.redirect_stderr(log):
            m = trainer.train_step(batches[step % len(batches)])
        losses.append(float(m["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        versions.append(trainer.march_version)
        if not had and trainer.mesh.has_skip_grid:
            attach = step
    launches = dict(cuda.launch_counts)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"{label}: {SKIP_STEPS} steps, bound {trainer.max_steps}, buckets "
          f"{trainer.tuned_bucket_steps}, cap {trainer.occ_depth_cap:.2f}; loss first 5 "
          f"mean {first:.5f}, last 5 mean {last:.5f}; losses "
          f"{[round(x, 5) for x in losses[::20]]} (every 20th); grid attached at step "
          f"{attach}; march_version {versions[::16]} (every 16th); "
          + "; ".join(line for line in log.getvalue().splitlines()
                      if line.startswith("# retune@")))
    _check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    _check(last < first, f"{label}: loss did not fall ({first} -> {last})")
    return trainer, step_ms, launches, attach, versions


def _march_stats(res):
    nv = res.num_valid.float()
    return dict(hit=int(res.hit.sum()), crossings_mean=float(nv.mean()),
                crossings_max=int(nv.max()))


def _object_shell_occupancy(mesh):
    """Density 1e3 in the cells whose centroid lies within 0.05 of an object
    sphere's surface of the camera scene, 0 elsewhere."""
    import torch
    from tetranerf_torch.utils.synthetic import _CAM_SPHERES

    centroids = mesh.vertices[mesh.cells.long()].mean(dim=1).double()
    near = torch.zeros(mesh.num_cells, dtype=torch.bool, device=mesh.device)
    for c, r in _CAM_SPHERES:
        dist = (centroids - torch.from_numpy(c).to(mesh.device)).norm(dim=1)
        near |= (dist - r).abs() < 0.05
    return torch.where(near, 1e3, 0.0).float()


def _k1_grid_check(mesh, o, d, steps, cap, label, march_entry):
    """K1 with ``mesh``'s skip grid against its twin (every output), and its
    time with and without the grid on the same rays, with the share of rays
    the trace drops and the crossings a ray either way."""
    from tetranerf_torch.ops.march import march_intervals, march_intervals_twin
    from tetranerf_torch.ops.traversal import hull_intersect

    args = (mesh.march_table, mesh.hull_cells, o, d, *hull_intersect(mesh.hull_eqs, o, d),
            steps, -(-steps // 16) * 16, 16, True, cap)
    grid = (mesh.skip_table, mesh.skip_meta)
    ker, twin = march_intervals(*args, *grid), march_intervals_twin(*args, *grid)
    err = _march_err(ker, twin, f"march with the {label} grid")
    _check(err <= TOLERANCES["march"], f"march with the {label} grid: max abs err {err}")
    march_entry["max_abs_err"] = max(march_entry["max_abs_err"], err)
    plain = march_intervals(*args)
    with_grid, without = _march_stats(ker), _march_stats(plain)
    dropped = int((plain.hit & ~ker.hit).sum())
    out = dict(ms=_time_ms(lambda: march_intervals(*args, *grid), 10),
               ms_without_grid=_time_ms(lambda: march_intervals(*args), 10),
               rays=o.shape[0], bound=steps, dropped_share=dropped / o.shape[0],
               free_voxels=float((mesh.skip_table[..., 0] > 0).float().mean()),
               with_grid=with_grid, without_grid=without, **_march_bound(ker))
    print(f"skip: K1 with the {label} grid ({out['free_voxels']:.3f} of the voxels free) "
          f"equal to its twin in every output (t, bary max abs err {err:.3g}); "
          f"{o.shape[0]} rays at bound {steps}: K1 {out['ms']:.4f} ms with the grid, "
          f"{out['ms_without_grid']:.4f} ms without (CUDA events), bound "
          f"{out['bound_ms']:.4f} ms; the trace drops {dropped} rays "
          f"({out['dropped_share']:.3f}); crossings a ray mean / max "
          f"{with_grid['crossings_mean']:.1f} / {with_grid['crossings_max']} with, "
          f"{without['crossings_mean']:.1f} / {without['crossings_max']} without")
    return out


def skip_phase(dev, march_entry, chase_ns):
    """Phase 16: the empty-space skip grid on ``make_camera_scene(100_000)``
    with ``tetranerf_preset(skip_grid_resolution=64)``. Returns the K9
    entry and the launches of the run with the grid (the path
    ``skip_train``); adds K1's times with and without the grid to
    ``march_entry``."""
    import torch
    from tetranerf_torch.geometry import build_mesh, triangulate
    from tetranerf_torch.models import tetranerf_preset
    from tetranerf_torch.ops.skip_grid import build_skip_table, make_skip_setup
    from tetranerf_torch.utils.synthetic import make_camera_scene

    t_phase = time.perf_counter()
    points, colors = make_camera_scene(NUM_POINTS, seed=0)
    mesh_plain = build_mesh(points, triangulate(points), device="cpu")
    mesh = mesh_plain.to(dev)
    print(f"skip: camera scene, {NUM_POINTS} points, {mesh.num_cells} cells, "
          f"{len(mesh.hull_eqs)} hull facets, built in {time.perf_counter() - t_phase:.1f} s")
    entry = locate_checks(mesh, chase_ns)
    torch.cuda.synchronize()
    t = time.perf_counter()
    setup = make_skip_setup(mesh, SKIP_RESOLUTION)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    anchors = setup.anchors
    print(f"skip: make_skip_setup at G={SKIP_RESOLUTION} in {setup_s:.3f} s (host kd-tree "
          f"seeds, K9 over the centres); {int((anchors >= 0).sum())} of {anchors.numel()} "
          f"centres inside the hull")
    entry["make_skip_setup_s"] = setup_s

    rng = np.random.default_rng(1)
    batches = [_camera_batch(rng, TRAIN_RAYS) for _ in range(TRAIN_BATCHES)]
    runs = {}
    for res_g in (SKIP_RESOLUTION, 0):
        label = f"skip train (G={res_g})"
        runs[res_g] = _skip_run(tetranerf_preset(skip_grid_resolution=res_g), colors,
                                mesh_plain, dev, batches, label)
        torch.cuda.empty_cache()
    trainer, step_ms, launches, attach, versions = runs[SKIP_RESOLUTION]
    refresh = trainer.model.config.occupancy_refresh_every
    _check(attach == refresh, f"skip: the grid attached at step {attach}, not {refresh}")
    bumps = [v[attach] - v[attach - 1] for v in (versions, runs[0][4])]
    _check(bumps[0] == bumps[1] + 1,
           f"skip: march_version moved by {bumps} at the attach (with, without the grid)")
    _check(runs[0][3] is None, "skip: a grid attached with skip_grid_resolution=0")
    for k in ("march", "locate"):
        _check(launches[k] > 0, f"skip train: {k} did not launch: {launches}")
    _check(launches["locate"] == 1, f"skip train: K9 launched {launches['locate']} times")

    # The table on the card against the same ops on the CPU, from the EMA.
    occ = trainer.occupancy
    setup_run = trainer._skip_setup
    table = build_skip_table(occ, setup_run)
    table_cpu = build_skip_table(occ.cpu(), type(setup_run)(*(x.cpu() for x in setup_run)))
    _check(torch.equal(table.cpu().view(torch.int32), table_cpu.view(torch.int32)),
           "skip: build_skip_table on the card differs from the CPU")
    _check(torch.equal(table.view(torch.int32), trainer.mesh.skip_table.view(torch.int32)),
           "skip: the attached table is not the EMA's")
    table_ms = _time_ms(lambda: build_skip_table(occ, setup_run), 10)
    setup_cpu = type(setup_run)(*(x.cpu() for x in setup_run))
    t = time.perf_counter()
    build_skip_table(occ.cpu(), setup_cpu)
    cpu_ms = (time.perf_counter() - t) * 1e3
    bound = _skip_table_bound(occ, setup_run)
    rho = table[..., 0]
    print(f"skip: build_skip_table on the card equal to the CPU's bit for bit; "
          f"{table_ms:.4f} ms by CUDA events (the same ops on the host CPU {cpu_ms:.1f} ms), "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
          f"{float((rho > 0).float().mean()):.3f} of the voxels free (rho > 0), rho max "
          f"{float(rho.max()):.4f}")
    entry["build_skip_table"] = dict(ms=table_ms, cpu_ms=cpu_ms, **bound)

    # K1 with the grid on the last step's batch, against its twin and
    # against K1 without the grid on the same batch: the trained grid, and
    # one from an EMA that marks only the objects' shells (density 1e3 in
    # cells within 0.05 of an object sphere's surface), as a converged
    # field would.
    b = batches[(SKIP_STEPS - 1) % len(batches)]
    o = torch.as_tensor(b["origins"], device=dev)
    d = torch.as_tensor(b["directions"], device=dev)
    shell = _object_shell_occupancy(mesh)
    grids = {
        "trained": (trainer.mesh, float(trainer.occ_depth_cap)),
        "object shells": (mesh.with_occupancy(shell).with_skip_grid(
            build_skip_table(shell, setup), setup.meta), float(-np.log(1e-4))),
    }
    march_entry["with_grid"] = {
        label: _k1_grid_check(grid_mesh, o, d, trainer.max_steps, cap, label, march_entry)
        for label, (grid_mesh, cap) in grids.items()}

    # Step times before and after the attach, beside the run without a grid.
    windows = {"before": [s for s in range(1, attach)],
               "after": [s for s in range(attach + 1, SKIP_STEPS) if s != 128]}
    med = {g: {w: float(np.median([runs[g][1][s] for s in idx])) for w, idx in windows.items()}
           for g in runs}
    print(f"skip: median ms/step before the attach (steps 1-{attach - 1}) / after it "
          f"(steps {attach + 1}-{SKIP_STEPS - 1} but 128): G={SKIP_RESOLUTION} "
          f"{med[SKIP_RESOLUTION]['before']:.2f} / {med[SKIP_RESOLUTION]['after']:.2f}, "
          f"G=0 {med[0]['before']:.2f} / {med[0]['after']:.2f}; rays/s after "
          f"{TRAIN_RAYS / med[SKIP_RESOLUTION]['after'] * 1e3:.0f} / "
          f"{TRAIN_RAYS / med[0]['after'] * 1e3:.0f}; ms of the attach step "
          f"{runs[SKIP_RESOLUTION][1][attach]:.2f} (G=0: {runs[0][1][attach]:.2f})")
    entry["train_median_ms"] = med
    for g in runs:
        _profile_steps(runs[g][0], batches[:2], med[g]["after"])

    # Eval renders of both trainers on the same camera rays.
    from tetranerf_torch.utils.synthetic import sample_camera_rays

    ro, rd = sample_camera_rays(np.random.default_rng(0), REQUEST_RAYS)
    rays_s = {}
    for g in runs:
        tr = runs[g][0]
        tr.render_rays(ro[:CHUNK], rd[:CHUNK], chunk=CHUNK)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = tr.render_rays(ro, rd, chunk=CHUNK)
        rays_s[g] = REQUEST_RAYS / (time.perf_counter() - t)
        _check(np.isfinite(out["rgb"]).all(), f"skip render (G={g}): non-finite rgb")
    print(f"skip: eval render {REQUEST_RAYS} camera rays at chunk {CHUNK}: "
          f"{rays_s[SKIP_RESOLUTION]:.0f} rays/s with the grid, {rays_s[0]:.0f} without")
    entry["render_rays_per_s"] = rays_s
    print(f"skip: phase 16 took {time.perf_counter() - t_phase:.1f} s")
    del runs
    return entry, launches


def _mlp_calls(model):
    """Count the model's MLP chains (its field and density MLP calls) in the
    returned dict while the wrappers stay installed."""
    calls = {"field_mlps": 0, "density_mlp": 0}
    for name in calls:
        fn = getattr(model, name)

        def counted(*args, fn=fn, name=name):
            calls[name] += 1
            return fn(*args)

        setattr(model, name, counted)
    return calls


def merged_phase(colors, mesh_plain, dev):
    """Phase 17: the flagship on the sphere with ``bucket_merge_mlps`` against
    the per-bucket shading from the same seeds: one step's loss and field
    gradient, the MLP chains and GEMM launches a step, median ms/step and
    the idle share. Returns the launches of the merged run."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(1)  # phase 7's five batches
    batches = [_train_batch(rng, TRAIN_RAYS) for _ in range(TRAIN_BATCHES)]
    runs = {}
    for merge in (False, True):
        cfg = tetranerf_preset(bucket_merge_mlps=merge)
        model = TetraNerf(cfg, mesh_plain.num_vertices, point_colors=colors,
                          generator=torch.Generator().manual_seed(0), device=dev)
        trainer = Trainer(TrainConfig(), model, mesh_plain, device=dev)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        losses, step_ms = [], []
        for step in range(MERGED_STEPS):
            if step == MERGED_STEPS - 1:  # a steady step: no occupancy work
                calls = _mlp_calls(model)
            t = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                m = trainer.train_step(batches[step % TRAIN_BATCHES])
            losses.append(float(m["loss"]))  # waits for the step
            step_ms.append((time.perf_counter() - t) * 1e3)
        launches = dict(cuda.launch_counts)
        step_calls = dict(calls)
        del model.field_mlps, model.density_mlp
        gemms = [e for e in _device_kernels(lambda: trainer.train_step(batches[0]))
                 if _kernel_group(e.name) == "GEMM"]
        med = float(np.median(step_ms[1:]))
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        label = "merged" if merge else "per-bucket"
        print(f"merged MLPs ({label}): {MERGED_STEPS} steps, median {med:.2f} ms/step "
              f"(steps 1-{MERGED_STEPS - 1}) = {TRAIN_RAYS / med * 1e3:.0f} rays/s; MLP "
              f"chains a steady step {step_calls}; GEMM launches a step {len(gemms)}; "
              f"loss first 5 mean {first:.5f}, last 5 mean {last:.5f}")
        _check(all(np.isfinite(losses)) and last < first,
               f"merged MLPs ({label}): loss did not fall ({first} -> {last})")
        _profile_steps(trainer, batches[:2], med)
        runs[merge] = dict(trainer=trainer, median_ms=med, calls=step_calls,
                           gemm_launches=len(gemms), launches=launches)
    k = tetranerf_preset().ray_buckets
    _check(runs[True]["calls"] == {"field_mlps": 1, "density_mlp": 1},
           f"merged MLPs: chains a step {runs[True]['calls']}, not 1 + 1")
    _check(runs[False]["calls"] == {"field_mlps": k, "density_mlp": k},
           f"per-bucket MLPs: chains a step {runs[False]['calls']}, not {k} + {k}")

    # One step's loss and field gradient, merged against per-bucket, on the
    # per-bucket trainer's state and bounds with the same random numbers.
    trainer = runs[False]["trainer"]
    merged = TetraNerf(tetranerf_preset(bucket_merge_mlps=True), mesh_plain.num_vertices,
                       device=dev)
    merged.load_state_dict(trainer.model.state_dict())
    batch = _train_batch(rng, TRAIN_RAYS)
    uniforms = _ref_uniforms(trainer.model, trainer, TRAIN_RAYS, 7)
    loss_p, grad_p = _loss_and_field_grad(trainer.model, trainer.mesh, trainer, batch,
                                          uniforms, dev)
    loss_m, grad_m = _loss_and_field_grad(merged, trainer.mesh, trainer, batch, uniforms,
                                          dev)
    trainer.model.zero_grad(set_to_none=True)
    loss_err = abs(loss_m - loss_p) / loss_p
    grad_err = float((grad_m - grad_p).abs().max() / grad_p.abs().max())
    print(f"merged MLPs: one {TRAIN_RAYS}-ray step against the per-bucket step: loss "
          f"{loss_m:.6f} vs {loss_p:.6f} (rel {loss_err:.3g}), field gradient max abs "
          f"diff / max {grad_err:.3g}; median ms/step {runs[True]['median_ms']:.2f} merged, "
          f"{runs[False]['median_ms']:.2f} per-bucket; phase 17 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    _check(loss_err <= REF_LOSS_RTOL, f"merged MLPs: loss rel err {loss_err}")
    _check(grad_err <= REF_GRAD_RTOL, f"merged MLPs: field grad rel err {grad_err}")
    return runs[True]["launches"]


SHARD_STEPS = 16
SHARD_TIMEOUT_S = 300
# Phase 18's runs: (label, ranks, device, backend, model shards). Each rank
# is this script started again with ``--shard-rank``.
SHARD_RUNS = (("nccl", 1, "cuda", "nccl", 1), ("gloo", 2, "cuda:0", "gloo", 1))
# Phase 20's: the field over 2 model shards, 1 x 2 and 2 x 2 ranks sharing
# the card over gloo (NCCL takes one rank a card).
MODEL_SHARD_RUNS = (("gloo1x2", 2, "cuda:0", "gloo", 2), ("gloo2x2", 4, "cuda:0", "gloo", 2))
# Steps taken after a model-shard run's compared ones, each gather timed
# between two synchronisations.
GATHER_TIMED_STEPS = 2
RANK_SCRIPT = Path(__file__).resolve()
LEVER_STEPS = 40
GRAD_BUDGET_PER_RAY = 200
# Data shards against one process: a mean of local means against one mean,
# gradients summed in another order (and K7's atomic order): losses to
# 1e-5 of themselves, the field to 1e-4 of its largest entry.
SHARD_LOSS_RTOL = 1e-5
SHARD_FIELD_RTOL = 1e-4
# One rank against one process differs only by K7's atomic order, when two
# no-group runs differ at all: held to this multiple of the spread between
# those two runs, and at least to the floor.
SHARD_NOISE_FACTOR = 10
SHARD_NOISE_FLOOR = 1e-6
# The low-precision streams' kernels against their plain versions: K2's
# rows widen exactly, so K2's f32 tolerance; K2b's f32 sums in another
# order are each rounded to the type once: within one rounding of the
# twin's f32 sum (stream_dtypes.one_rounding_bound) plus LOWP_SUM_ATOL for
# the order of the f32 sums (of unit-scale terms, whose sum may cancel to
# near zero); K7 adds the widened rows in atomic order (its f32 tolerance).
LOWP_STREAMS = ("bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")
# The seven software row types (uint8 codes, stream_dtypes.py), each run
# MINI_STEPS flagship steps.
MINI_STREAMS = ("float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz", "float8_e3m4",
                "float8_e4m3", "float8_e8m0fnu", "float4_e2m1fn")
MINI_STEPS = 16
LOWP_SUM_ATOL = 1e-6
# The first loss of a low-precision stream's run against f32's: the f32
# stream's features move by a rounding of the field to the type. Measured
# on the H100 at 4.7e-7 (bf16), 0 (f16), 7.0e-7 (e4m3fn) and 1.0e-6
# (e5m2); each limit is 10-100 times that.
# The software types: 1.4e-6 to 7.9e-6 on the CPU at field 16, hidden 32
# and 256 rays (e4m3fn there 3.2e-6), so the fp8 limit; float4_e2m1fn,
# whose rounding is 4 times as coarse as e4m3's, 1.3e-4 at field 8 and 64
# rays: 1e-3. float8_e8m0fnu's losses are NaN.
LOWP_LOSS_RTOL = {"bfloat16": 1e-5, "float16": 1e-5, "float8_e4m3fn": 1e-4,
                  "float8_e5m2": 1e-4, **dict.fromkeys(MINI_STREAMS, 1e-4),
                  "float4_e2m1fn": 1e-3}
# The ms per steady flagship step of the stream instances before the
# software K2 instances' flag and K2b's per-slot lists (PERF.md section 6
# rows 2-*, 2b-*, NVIDIA H100 80GB HBM3 at 700 W; phase 12's K2b 0.2135 and
# K2 0.1280), printed beside this run's.
EARLIER_STEP_MS = {
    "stream_blend_gather": 0.1595, "stream_blend_gather_bf16": 0.1582,
    "stream_blend_gather_f16": 0.1529, "stream_blend_gather_e4m3fn": 0.1519,
    "stream_blend_gather_e5m2": 0.1522, "stream_blend_gather_e4m3fnuz": 0.5594,
    "stream_blend_gather_e5m2fnuz": 0.5593, "stream_blend_gather_e4m3b11fnuz": 0.5598,
    "stream_blend_gather_e3m4": 0.5688, "stream_blend_gather_e4m3": 0.5646,
    "stream_blend_gather_e8m0fnu": 0.4871, "stream_blend_gather_e2m1fn": 0.2205,
    "stream_blend_backward": 0.2756, "stream_blend_backward_bf16": 0.2559,
    "stream_blend_backward_f16": 0.2620, "stream_blend_backward_e4m3fn": 0.2669,
    "stream_blend_backward_e5m2": 0.2828, "stream_blend_backward_e4m3fnuz": 0.3798,
    "stream_blend_backward_e5m2fnuz": 0.3799, "stream_blend_backward_e4m3b11fnuz": 0.3779,
    "stream_blend_backward_e3m4": 0.3737, "stream_blend_backward_e4m3": 0.3711,
    "stream_blend_backward_e8m0fnu": 0.7041, "stream_blend_backward_e2m1fn": 0.3736,
    # K7 before its 16-byte lanes (PERF.md rows 7, 7-bf16, 7-f16, 7-f8,
    # 7-sw: a lane group of 16 a row, NaN components off the float atomics).
    "scatter_add_rows": 0.1556, "scatter_add_rows_bf16": 0.1102,
    "scatter_add_rows_f16": 0.0865, "scatter_add_rows_e4m3fn": 0.0813,
    "scatter_add_rows_e5m2": 0.0813, "scatter_add_rows_e4m3fnuz": 0.1000,
    "scatter_add_rows_e5m2fnuz": 0.0998, "scatter_add_rows_e4m3b11fnuz": 0.1000,
    "scatter_add_rows_e3m4": 0.0934, "scatter_add_rows_e4m3": 0.0928,
    "scatter_add_rows_e8m0fnu": 0.1359, "scatter_add_rows_e2m1fn": 0.0845,
}
EARLIER_PHASE12_MS = {"stream_blend_gather": 0.1280, "stream_blend_backward": 0.2135,
                      "scatter_add_rows": 0.1319}
# The path of each low-precision stream's flagship run.
LOWP_PATHS = {"bfloat16": "stream_lp_train", "float16": "stream_f16_train",
              "float8_e4m3fn": "stream_e4m3fn_train", "float8_e5m2": "stream_e5m2_train",
              **{name: f"stream_{name.split('_', 1)[1]}_train" for name in MINI_STREAMS}}

def _shard_trainer(dev, group=None, mesh_plain=None, colors=None, scene=None):
    """The unmodified preset's trainer on the phase-1 sphere: from
    ``mesh_plain`` and ``colors``, or built from the ``scene`` npz (a
    rank's own copy of the same points and cells)."""
    import torch
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    if scene is not None:
        data = np.load(scene)
        mesh_plain = build_mesh(data["points"], data["cells"], device="cpu")
        colors = data["colors"]
    model = TetraNerf(tetranerf_preset(), mesh_plain.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    config = TrainConfig(num_model_shards=1 if group is None else group.model_count)
    return Trainer(config, model, mesh_plain, device=dev, group=group)


def _shard_batches(rows=None):
    """Phase 7's five batches (this rank's ``rows`` of each)."""
    rng = np.random.default_rng(1)
    batches = [_train_batch(rng, TRAIN_RAYS) for _ in range(TRAIN_BATCHES)]
    if rows is not None:
        batches = [{k: v[rows] for k, v in b.items()} for b in batches]
    return batches


def _shard_steps(trainer, rows=None):
    """:data:`SHARD_STEPS` steps on phase 7's five batches (this rank's
    ``rows`` of each): losses, ms per step, the bounds and cap, the EMA and
    the parameters after the run, the launches, the peak memory, and the
    bytes of the field block with its gradient and RAdam moments."""
    import torch
    from tetranerf_torch.ops import cuda

    batches = _shard_batches(rows)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    losses, step_ms = [], []
    for step in range(SHARD_STEPS):
        t = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            m = trainer.train_step(batches[step % TRAIN_BATCHES])
        losses.append(float(m["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
    field = trainer.model.tetrahedra_field
    return dict(losses=losses, step_ms=step_ms, launches=dict(cuda.launch_counts),
                bounds=(trainer.max_steps, trainer.tuned_bucket_steps, trainer.occ_depth_cap),
                occupancy=trainer.occupancy.cpu(),
                params={k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
                max_memory=torch.cuda.max_memory_allocated(),
                field_bytes=field.numel() * field.element_size() * 4,
                field_shape=tuple(field.shape))


def _timed_gathers(trainer, rows):
    """:data:`GATHER_TIMED_STEPS` more steps with every column gather timed
    on the host clock between two synchronisations: per step the gathers'
    count, their full-width bytes and ms; then the bytes a gather after the
    sample lerp K3 would move at the run's bucket plan instead (both
    rounds' samples at full width, ``Σ R_b (2 ns_b + nf_b) F 4``)."""
    import torch
    from tetranerf_torch.parallel import distributed

    plain, calls = distributed.Group.gather_columns, []

    def timed(self, xs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain(self, xs)
        torch.cuda.synchronize()
        calls.append((sum(x.numel() for x in out) * 4, (time.perf_counter() - t) * 1e3))
        return out

    batches = _shard_batches(rows)
    distributed.Group.gather_columns = timed
    per_step = []
    try:
        for step in range(GATHER_TIMED_STEPS):
            calls.clear()
            with contextlib.redirect_stderr(io.StringIO()):
                float(trainer.train_step(batches[step % TRAIN_BATCHES])["loss"])
            per_step.append(dict(count=len(calls), bytes=sum(b for b, _ in calls),
                                 ms=sum(m for _, m in calls),
                                 largest=max(calls)[0] if calls else 0))
    finally:
        distributed.Group.gather_columns = plain
    model = trainer.model
    bounds = model.bucket_bounds(trainer.max_steps, None, trainer.tuned_bucket_steps)
    num_feat = model.config.field_dim
    after_k3 = sum((hi - lo) * (2 * ns + nf) * num_feat * 4
                   for _, lo, hi, _, ns, nf in model.bucket_plan(TRAIN_RAYS, bounds))
    return dict(per_step=per_step, after_k3_bytes=after_k3 // trainer.group.data_count)


def _shard_rank_main(run_dir) -> int:
    """A rank of phase 18, 20 or 23, started by :func:`_spawn_ranks` with
    torchrun's environment: joins the group, trains its rows (phase 23: runs
    :func:`_viewer_rank_run`) and saves the result."""
    import torch

    sys.path.insert(0, str(ROOT))
    from tetranerf_torch.parallel import destroy, init_distributed

    run_dir = Path(run_dir)
    spec = json.loads((run_dir / "spec.json").read_text())
    group = init_distributed(spec["device"], backend=spec["backend"],
                             model_shards=spec["model_shards"])
    try:
        trainer = _shard_trainer(group.device, group, scene=run_dir.parent / "scene.npz")
        if spec.get("viewer"):
            torch.save(_viewer_rank_run(trainer, group), run_dir / f"rank{group.rank}.pt")
            return 0
        rows = group.batch_slice(TRAIN_RAYS)
        out = _shard_steps(trainer, rows)
        if group.model_count > 1:
            out["gathers"] = _timed_gathers(trainer, rows)
        out.update(rank=group.rank, world=group.world, device=str(group.device),
                   backend=torch.distributed.get_backend(), model_count=group.model_count)
        torch.save(out, run_dir / f"rank{group.rank}.pt")
    finally:
        destroy(group)
    return 0


def _spawn_ranks(tmp, label, world, device, backend, model_shards=1, viewer=False):
    """Start ``world`` ranks of this script on the card with torchrun's
    environment set here (``model_shards`` of the field; with ``viewer``
    phase 23's run instead of phase 18's steps), wait for all, and fail if
    any fails (the others are killed then). Returns their results and the
    wall seconds."""
    import socket

    import torch

    run_dir = tmp / label
    run_dir.mkdir()
    (run_dir / "spec.json").write_text(json.dumps(
        {"device": device, "backend": backend, "model_shards": model_shards,
         "viewer": viewer}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    t = time.perf_counter()
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")
        log = open(run_dir / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(RANK_SCRIPT), "--shard-rank", str(run_dir)],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    try:
        deadline = time.perf_counter() + SHARD_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: the others may wait on it forever
            _check(time.perf_counter() < deadline,
                   f"shards ({label}): the ranks ran past {SHARD_TIMEOUT_S} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t
    for rank, p in enumerate(procs):
        text = (run_dir / f"rank{rank}.log").read_text()
        _check(p.returncode == 0,
               f"shards ({label}): rank {rank} of {world} exited {p.returncode}:\n{text[-4000:]}")
    return [torch.load(run_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)], wall


def _bit_equal(a, b):
    import torch

    return all(torch.equal(a[k], b[k]) for k in a)


def _shard_compare(label, run, ref, tol):
    """Hold ``run`` (a rank's result) to the one-process ``ref``: the bounds,
    cap and EMA equal, and bit for bit where ``tol`` is None, else losses
    to ``tol[0]`` relative and the field to ``tol[1]`` of its largest
    entry. Returns the largest relative loss difference and field
    difference."""
    import torch

    loss_err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
    field, field_ref = run["params"]["tetrahedra_field"], ref["params"]["tetrahedra_field"]
    field_err = float((field - field_ref).abs().max() / field_ref.abs().max())
    _check(run["bounds"] == ref["bounds"],
           f"shards ({label}): bounds and cap {run['bounds']} vs {ref['bounds']}")
    _check(torch.equal(run["occupancy"], ref["occupancy"]),
           f"shards ({label}): the occupancy EMA differs from one process")
    if tol is None:
        _check(run["losses"] == ref["losses"] and _bit_equal(run["params"], ref["params"]),
               f"shards ({label}): not bit-equal to one process (losses rel {loss_err:.3g})")
    else:
        _check(loss_err <= tol[0], f"shards ({label}): loss rel err {loss_err} > {tol[0]}")
        _check(field_err <= tol[1], f"shards ({label}): field rel err {field_err} > {tol[1]}")
    return loss_err, field_err


def _full_params(ranks, model_count):
    """Rank 0's parameters with the field put together from the model
    ranks of data index 0 (ranks ``0 .. M-1``, columns in model order)."""
    import torch

    params = dict(ranks[0]["params"])
    params["tetrahedra_field"] = torch.cat(
        [ranks[m]["params"]["tetrahedra_field"] for m in range(model_count)], dim=1)
    return params


def _run_ranks(tmp, ref, noise_tol, label, world, device, backend, model_count=1):
    """One run of ranks (:func:`_spawn_ranks`) held to the no-group ``ref``:
    every rank the same losses, EMA and replicated parameters as rank 0 and
    the same field block as the rank of its columns in data index 0; one
    rank bit for bit to ``ref``'s first loss and to ``noise_tol`` (None:
    bit-equal) after it, more ranks to :data:`SHARD_LOSS_RTOL` and
    :data:`SHARD_FIELD_RTOL` with the field put together from its column
    blocks. Returns the ranks' results, the run's name and its errors."""
    import torch

    ranks, wall = _spawn_ranks(tmp, label, world, device, backend, model_count)
    grid = f" as {world // model_count} x {model_count}" if model_count > 1 else ""
    name = f"{backend}, {world} rank{'s' if world > 1 else ''}{grid} on {device}"
    _check(all(r["backend"] == backend and r["world"] == world
               and r["model_count"] == model_count for r in ranks),
           f"shards ({name}): backends {[r['backend'] for r in ranks]}")
    for r in ranks[1:]:
        same_cols = ranks[r["rank"] % model_count]["params"]["tetrahedra_field"]
        _check(r["losses"] == ranks[0]["losses"]
               and torch.equal(r["params"]["tetrahedra_field"], same_cols)
               and all(torch.equal(v, ranks[0]["params"][k])
                       for k, v in r["params"].items() if k != "tetrahedra_field")
               and torch.equal(r["occupancy"], ranks[0]["occupancy"]),
               f"shards ({name}): rank {r['rank']}'s parameters differ from rank 0's")
    if world == 1:
        # One rank is the one-process step: its first loss, before K7's
        # atomic order can move a parameter, bit for bit; after it, as far
        # from one process as two no-group runs are from each other.
        _check(ranks[0]["losses"][0] == ref["losses"][0],
               f"shards ({name}): step 0 loss {ranks[0]['losses'][0]} vs {ref['losses'][0]}")
        tol = noise_tol
    else:
        tol = (SHARD_LOSS_RTOL, SHARD_FIELD_RTOL)
    run = dict(ranks[0], params=_full_params(ranks, model_count))
    loss_err, field_err = _shard_compare(name, run, ref, tol)
    for r in ranks:
        for k in ("march", "stream_blend_gather", "stream_blend_backward",
                  "scatter_add_rows", "row_gather"):
            _check(r["launches"][k] > 0, f"shards ({name}): rank {r['rank']}: {k} did "
                   f"not launch: {r['launches']}")
    devices = sorted({r["device"] for r in ranks})
    shared = (" (ranks sharing a card: a measure of correctness, not of scaling)"
              if len(devices) < world else "")
    print(f"shards: {name} ({', '.join(devices)}), {TRAIN_RAYS // (world // model_count)} "
          f"rows each{shared}: the ranks bit-equal to each other; bounds, cap and occupancy "
          f"equal to one process; losses within {loss_err:.3g} relative, the field within "
          f"{field_err:.3g} of its max ("
          + ("bit-equal" if tol is None else f"held to {tol[0]:.3g} and {tol[1]:.3g}")
          + f"); median {[round(_median_step(r), 2) for r in ranks]} "
          f"ms/step against {_median_step(ref):.2f} with no group in this process "
          f"({wall:.1f} s for the ranks, start-up included)")
    return ranks, name


def _median_step(run):
    return float(np.median(run["step_ms"][1:]))


def shard_phase(points, colors, cells, mesh_plain, dev, tmp, phase12_ms=None,
                runs=None):
    """Phase 18: data shards on the card, the unmodified preset at full
    width on phase 1's sphere, global batches of 4096 rays, each run of
    ``runs`` (default :data:`SHARD_RUNS`: (a) one rank over NCCL, (b) two
    ranks on ``cuda:0`` over gloo with 2048 rows each) against the same
    steps in this process with no group (:func:`_run_ranks`). Returns each
    run's launches (its rank 0's) and ms/step, and the no-group run with
    the tolerance of one rank (phase 20 holds its runs to the same)."""
    import torch

    t_phase = time.perf_counter()
    np.savez(tmp / "scene.npz", points=points, colors=colors, cells=cells)
    ref = _shard_steps(_shard_trainer(dev, mesh_plain=mesh_plain, colors=colors))
    again = _shard_steps(_shard_trainer(dev, mesh_plain=mesh_plain, colors=colors))
    torch.cuda.empty_cache()
    repeatable = again["losses"] == ref["losses"] and _bit_equal(again["params"], ref["params"])
    spread = max(abs(a - b) / abs(b) for a, b in zip(again["losses"], ref["losses"]))
    field = ref["params"]["tetrahedra_field"]
    field_spread = float((again["params"]["tetrahedra_field"] - field).abs().max()
                         / field.abs().max())
    print(f"shards: two no-group runs of {SHARD_STEPS} steps bit-equal: {repeatable} "
          f"(losses {spread:.3g} relative apart, the field {field_spread:.3g} of its max"
          + ("" if repeatable else ": K7 adds in atomic order") + ")")
    noise_tol = None if repeatable else tuple(
        max(SHARD_NOISE_FACTOR * x, SHARD_NOISE_FLOOR) for x in (spread, field_spread))
    out = {}
    for label, *run in runs or SHARD_RUNS:
        ranks, _ = _run_ranks(tmp, ref, noise_tol, label, *run)
        out[label] = dict(launches=ranks[0]["launches"], ms=[_median_step(r) for r in ranks],
                          max_memory=[r["max_memory"] for r in ranks])
    print(f"shards: {SHARD_STEPS} steps of the preset, {TRAIN_RAYS} rays a global batch, "
          f"bounds and cap {ref['bounds']}; phase 12's cold median "
          f"{'not run' if phase12_ms is None else f'{phase12_ms:.2f} ms/step'}; phase 18 "
          f"took {time.perf_counter() - t_phase:.1f} s")
    return out, ref


def _model_width_kernel_checks(mesh, origins, directions, num_feat):
    """K2, K2b and K7 at a model shard's width ``num_feat`` (the flagship's
    64 over the model shards) on all 8 buckets of a cold flagship step,
    each against its plain version, timed by CUDA events beside it and
    beside its bound. Returns one dict per kernel name."""
    import torch
    from tetranerf_torch.ops import fused, interp, scatter

    dev = origins.device
    num_v = mesh.num_vertices
    gen = torch.Generator(device=dev).manual_seed(23)
    field = torch.randn((num_v, num_feat), generator=gen, device=dev)
    res, order, plan = _cold_bucket_plan(mesh, origins, directions)
    streams = [(sl.stream.vids, sl.stream.pos, sl.stream.bary)
               for sl, _ in fused.slice_march_buckets(res, order, plan)]
    out = {}

    def record(name, err, kernel, plain, bound):
        _check(err <= TOLERANCES[name], f"{name} at width {num_feat}: err {err}")
        out[name] = dict(width=num_feat, max_abs_err=err, ms=_time_ms(kernel, 20),
                         plain_ms=_time_ms(plain, 3), **bound)
        e = out[name]
        print(f"model shards: {name} at F={num_feat} on the {len(streams)} buckets of a cold "
              f"flagship step: max abs err {err:.3g}; {e['ms']:.4f} ms by CUDA events, bound "
              f"{e['bound_ms']:.4f} ({e['bound_by']}); plain version {e['plain_ms']:.3f} ms")

    feats = interp.stream_blend_gather_batch(field, streams)
    err = max(_max_err(a, b) for a, b in zip(
        feats, interp.stream_blend_gather_batch_twin(field, streams)))
    record("stream_blend_gather", err,
           lambda: interp.stream_blend_gather_batch(field, streams),
           lambda: interp.stream_blend_gather_batch_twin(field, streams),
           _blend_batch_bound(field, streams))
    bwd = [(torch.randn(f.shape, generator=gen, device=dev), pos, bary, vids.shape[1])
           for f, (vids, pos, bary) in zip(feats, streams)]
    del feats
    gsf = [interp.stream_blend_backward(*a) for a in bwd]
    err = max(_max_err(g, interp.stream_blend_backward_twin(*a)) for g, a in zip(gsf, bwd))
    bounds = [_blend_bwd_bound(*a) for a in bwd]
    record("stream_blend_backward", err,
           lambda: [interp.stream_blend_backward(*a) for a in bwd],
           lambda: [interp.stream_blend_backward_twin(*a) for a in bwd],
           dict(bounds[0], bound_ms=sum(b["bound_ms"] for b in bounds)))
    jobs = [(vids.reshape(-1).clamp_min(0), g.reshape(-1, num_feat))
            for (vids, _, _), g in zip(streams, gsf)]
    err = _max_err(scatter.scatter_add_rows_batch(jobs, num_v),
                   scatter.scatter_add_rows_batch_twin(jobs, num_v))
    record("scatter_add_rows", err, lambda: scatter.scatter_add_rows_batch(jobs, num_v),
           lambda: scatter.scatter_add_rows_batch_twin(jobs, num_v),
           _scatter_batch_bound(jobs, num_v))
    return out


def model_shard_phase(mesh_plain, dev, tmp, ref, runs=MODEL_SHARD_RUNS,
                      one_rank_memory=None):
    """Phase 20: the field sharded over 2 model shards, ``runs`` of phase
    18's 16 flagship steps (1 x 2 and 2 x 2 ranks on ``cuda:0`` over
    gloo) each held to phase 18's no-group run ``ref`` at phase 18's
    tolerances (:func:`_run_ranks`, the field put together from its column
    blocks); per rank the bytes of its field block with gradient and
    moments, the peak memory, ms/step, and the column gathers of
    :data:`GATHER_TIMED_STEPS` more steps (count, bytes, ms) beside the
    bytes a gather after K3 would move; then K2, K2b and K7 at the shard's
    width against their plain versions (:func:`_model_width_kernel_checks`).
    ``one_rank_memory`` is the peak memory of phase 18's one-rank run, a
    process of its own like these ranks (this process's peak counts the
    earlier phases' tensors).
    Returns the launches of each run's rank 0 and the kernels' results."""
    import torch
    from tetranerf_torch.utils.synthetic import sample_sphere_rays

    t_phase = time.perf_counter()
    out = {}
    full_bytes = ref["field_bytes"]
    for label, *run in runs:
        ranks, name = _run_ranks(tmp, ref, None, label, *run)
        for r in ranks:
            gathers = r["gathers"]
            steps = "; ".join(f"{g['count']} gathers, {g['bytes'] / 1e6:.1f} MB (largest "
                              f"{g['largest'] / 1e6:.1f}), {g['ms']:.1f} ms"
                              for g in gathers["per_step"])
            print(f"model shards ({name}): rank {r['rank']}: field block {r['field_shape']}, "
                  f"with its gradient and RAdam moments {r['field_bytes'] / 1e6:.1f} MB "
                  f"(one process: {full_bytes / 1e6:.1f} MB); peak memory "
                  f"{r['max_memory'] / 1e9:.2f} GB (one rank, no model shards: "
                  + ("not measured" if one_rank_memory is None
                     else f"{one_rank_memory / 1e9:.2f} GB")
                  + f"); median {_median_step(r):.2f} ms/step; the column gathers of "
                  f"{GATHER_TIMED_STEPS} more steps, each timed between two synchronisations: "
                  f"{steps}; a gather after K3 instead would move "
                  f"{gathers['after_k3_bytes'] / 1e6:.1f} MB a step's train forward")
            _check(r["field_shape"][1] * r["model_count"] == ref["field_shape"][1],
                   f"model shards ({name}): rank {r['rank']} holds {r['field_shape']}")
        out[label] = dict(launches=ranks[0]["launches"], ms=[_median_step(r) for r in ranks],
                          gathers=ranks[0]["gathers"])
    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(2), TRAIN_RAYS)
        kernels = _model_width_kernel_checks(
            mesh_plain.to(dev), torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            ref["field_shape"][1] // runs[0][4])
    torch.cuda.empty_cache()
    print(f"model shards: phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return out, kernels


def _rounding_check(name, dev):
    """K2b's instance for ``name``: each boundary value of
    ``stream_dtypes.boundary_values(name)`` but -NaN and -0 (the card's
    arithmetic makes every NaN positive, and a sum 0 + -0 is +0) the f32
    sum of one endpoint of weight 1, rounded to the codes ``jnp.astype``
    gives (``BOUNDARY_CODES``); and the field's cast (``round_to``) on the
    card, -NaN and -0 included. Returns the number of codes checked."""
    import torch
    from tetranerf_torch.ops import interp
    from tetranerf_torch.ops.stream_dtypes import (BOUNDARY_CODES, STREAM_TYPES,
                                                   boundary_values, round_to)

    t = STREAM_TYPES[name]
    x = torch.tensor(boundary_values(name))
    want = list(BOUNDARY_CODES[name])
    code_type = {2: torch.int16, 1: torch.uint8}[torch.empty((), dtype=t.storage).element_size()]

    def bits(v):
        return [int(c) & 0xFFFF for c in v.view(code_type).cpu()]

    sums = ~(torch.signbit(x) & ((x == 0) | x.isnan()))
    n = int(sums.sum())
    g = x[sums][None, :, None].expand(1, n, 2).contiguous().to(dev)
    pos = torch.full((1, n, 4), n, dtype=torch.int32)  # zero weights: the spare slot n
    pos[0, :, 0] = torch.arange(n, dtype=torch.int32)
    bary = torch.zeros((1, n, 4))
    bary[..., 0] = 1.0
    gsf = interp.stream_blend_backward(g, pos.to(dev), bary.to(dev), n + 1, t)
    want_sums = [c for c, keep in zip(want, sums.tolist()) if keep]
    _check(bits(gsf[0, :n, 0]) == want_sums and bits(gsf[0, :n, 1]) == want_sums,
           f"stream_blend_backward ({name}): rounding {bits(gsf[0, :n, 0])}, not {want_sums}")
    cast = round_to(x.to(dev), t)
    _check(bits(cast) == want, f"round_to ({name}) on the card: {bits(cast)}, not {want}")
    return 2 * n + len(want)


def _nan_aware_err(a, b, what):
    """The largest difference of ``a`` and ``b`` where both are finite, after
    checking that their NaNs and infinities lie at the same places."""
    import torch

    a, b = a.double(), b.double()
    _check(torch.equal(a.isnan(), b.isnan()), f"{what}: NaN at other places than the twin's")
    inf = b.isinf()
    _check(torch.equal(a.isinf(), inf) and torch.equal(a[inf], b[inf]),
           f"{what}: infinities other than the twin's")
    keep = b.isfinite()
    return float((a[keep] - b[keep]).abs().max()) if bool(keep.any()) else 0.0


def _lever_kernel_checks(mesh, origins, directions):
    """K2, K2b and K7's instance for each low-precision row type against
    their plain versions on all 8 buckets of a cold flagship step, each
    timed beside its f32 instance (same inputs, same call) with both
    bounds; K2b's and the field cast's rounding of the boundary values.
    The software types (:data:`MINI_STREAMS`): K2 and K7 with their NaNs
    at the twin's places, K2b's codes bit-equal to the f32 instance's sums
    rounded by ``round_to``. Prints a hash of each K2b instance's outputs
    (f32's too): equal hashes from two trees' runs are the same bits."""
    import hashlib

    import torch
    from tetranerf_torch.ops import fused, interp, scatter, stream_dtypes
    from tetranerf_torch.ops.stream_dtypes import (BOUNDARY_CODES, STREAM_TYPES,
                                                   one_rounding_bound, round_to, widen)

    dev = origins.device
    num_v = mesh.num_vertices
    gen = torch.Generator(device=dev).manual_seed(19)
    field = torch.randn((num_v, 64), generator=gen, device=dev)
    # K2's software instances also on a field with NaN or infinity codes in
    # its second 32 columns: one entry in 100 there +-1e6, past every
    # type's range (float8_e8m0fnu's NaN where negative), the rest positive.
    edge = torch.rand((num_v, 32), generator=gen, device=dev) < 0.01
    bad_field = field.clone()
    bad_field[:, 32:] = torch.where(edge, 1e6 * torch.sign(field[:, 32:]),
                                    field[:, 32:].abs() + 0.25)
    res, order, plan = _cold_bucket_plan(mesh, origins, directions)
    slices = [sl for sl, _ in fused.slice_march_buckets(res, order, plan)]
    streams = [(sl.stream.vids, sl.stream.pos, sl.stream.bary) for sl in slices]
    gs = [torch.randn((pos.shape[0], pos.shape[1], 64), generator=gen, device=dev)
          for _, pos, _ in streams]
    bwd = [(g, pos, bary, vids.shape[1]) for g, (vids, pos, bary) in zip(gs, streams)]
    gsf_f32 = [interp.stream_blend_backward(*a) for a in bwd]
    entries = []

    def output_hash(name, outs):
        digest = hashlib.sha256()
        for x in outs:
            digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        print(f"{name}: the {len(outs)} buckets' outputs, sha256 {digest.hexdigest()[:16]}")

    output_hash("stream_blend_backward", gsf_f32)

    def entry(name, f32_name, replaces, source, err, kernel, plain, f32, bound, f32_bound,
              **extra):
        e = _entry(name, source, replaces, err, _time_ms(kernel, 20), _time_ms(plain, 3),
                   bound, device_ms=_device_ms(kernel), f32_instance=f32_name,
                   f32_ms=_time_ms(f32, 20), f32_device_ms=_device_ms(f32),
                   f32_bound_ms=f32_bound["bound_ms"], jobs=len(streams), **extra)
        print(f"{name}: the {len(streams)} buckets of a cold flagship step: max abs err "
              f"{err:.3g}; {e['ms']:.4f} ms by CUDA events, kernels {e['device_ms']} by the "
              f"profiler, bound {e['bound_ms']:.4f} ({e['bound_by']}); f32 instance "
              f"{e['f32_ms']:.4f} ms, kernels {e['f32_device_ms']}, bound "
              f"{e['f32_bound_ms']:.4f}; plain version {e['plain_ms']:.3f} ms")
        entries.append(e)

    def bound_sum(fn, *extra):
        total = [fn(*a, *extra) for a in bwd]
        return dict(total[0], bound_ms=sum(b["bound_ms"] for b in total))

    def blend_check(name, field_lp, t):
        """K2's instance against its twin (NaN and infinities at the twin's
        places for the software types): the largest error and NaN share."""
        sfx = t.suffix
        outs = interp.stream_blend_gather_batch(field_lp, streams, t)
        twin = interp.stream_blend_gather_batch_twin(field_lp, streams, t)
        _check(all(o.dtype == torch.float32 for o in outs), f"stream_blend_gather{sfx}: dtype")
        if t.minifloat:
            err = max(_nan_aware_err(a, b, f"stream_blend_gather{sfx} ({name})")
                      for a, b in zip(outs, twin))
        else:
            err = max(_max_err(a, b) for a, b in zip(outs, twin))
        _check(err <= TOLERANCES["stream_blend_gather"],
               f"stream_blend_gather{sfx} ({name}): err {err}")
        nan = sum(int(o.isnan().sum()) for o in outs) / sum(o.numel() for o in outs)
        return err, nan

    for name in LOWP_STREAMS + MINI_STREAMS:
        t = STREAM_TYPES[name]
        sfx, mini = t.suffix, t.minifloat
        # float8_e8m0fnu has no sign: its field with no non-finite code is
        # the magnitudes.
        field_lp = round_to(field.abs() if name == "float8_e8m0fnu" else field, t)
        err, _ = blend_check(name, field_lp, t)
        extra = {}
        if mini:
            # The field with non-finite codes: where the type has them, the
            # flag the kernel reads is set and each ray's slot rows counted.
            bad_lp = round_to(bad_field, t)
            flagged = [bool(stream_dtypes.nonfinite(f, t).any()) for f in (field_lp, bad_lp)]
            _check(flagged == [False, t.dense_nan],
                   f"stream_blend_gather{sfx}: non-finite codes {flagged}")
            bad_err, bad_nan = blend_check(f"{name}, non-finite codes", bad_lp, t)

            def bad_call(bad_lp=bad_lp, t=t):
                return interp.stream_blend_gather_batch(bad_lp, streams, t)

            extra = dict(nonfinite_max_abs_err=bad_err, nonfinite_nan_share=bad_nan,
                         nonfinite_ms=_time_ms(bad_call, 20),
                         nonfinite_device_ms=_device_ms(bad_call))
            print(f"stream_blend_gather{sfx}: on the field with non-finite codes (flag "
                  f"{'set' if flagged[1] else 'clear'}): max abs err {bad_err:.3g}, NaN share "
                  f"{bad_nan:.3f}; {extra['nonfinite_ms']:.4f} ms by CUDA events, kernels "
                  f"{extra['nonfinite_device_ms']} by the profiler")
        entry(f"stream_blend_gather{sfx}", "stream_blend_gather",
              "tetranerf_tpu/ops/pallas_interp.py:214", "tetranerf_torch/csrc/blend.cu", err,
              lambda: interp.stream_blend_gather_batch(field_lp, streams, t),
              lambda: interp.stream_blend_gather_batch_twin(field_lp, streams, t),
              lambda: interp.stream_blend_gather_batch(field, streams),
              _blend_batch_bound(field_lp, streams), _blend_batch_bound(field, streams), **extra)

        gsf = [interp.stream_blend_backward(*a, t) for a in bwd]
        output_hash(f"stream_blend_backward{sfx}", gsf)
        err, over = 0.0, 0.0
        for out, a, f32 in zip(gsf, bwd, gsf_f32):
            ref = interp.stream_blend_backward_twin(*a)
            _check(out.dtype == t.storage, f"stream_blend_backward{sfx}: dtype")
            value = widen(out, t)
            bound = one_rounding_bound(ref, t, LOWP_SUM_ATOL)
            if mini:
                # The f32 instance's sums, rounded as round_to rounds.
                _check(torch.equal(out, round_to(f32, t)),
                       f"stream_blend_backward{sfx}: codes other than the rounded f32 sums")
                top = widen(torch.tensor([t.max_code], dtype=torch.uint8, device=dev), t)
                keep = widen(round_to(ref, t), t).isfinite() & (ref.abs() <= top)
                value, ref, bound = value[keep], ref[keep], bound[keep]
            diff = (value - ref).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            over = max(over, float((diff - bound).max()) if diff.numel() else 0.0)
        _check(over <= 0, f"stream_blend_backward{sfx}: beyond one rounding ({over})")
        checked = _rounding_check(name, dev) if name in BOUNDARY_CODES else 0
        entry(f"stream_blend_backward{sfx}", "stream_blend_backward",
              "tetranerf_tpu/ops/pallas_interp.py:257", "tetranerf_torch/csrc/blend.cu", err,
              lambda: [interp.stream_blend_backward(*a, t) for a in bwd],
              lambda: [interp.stream_blend_backward_twin(*a, t) for a in bwd],
              lambda: [interp.stream_blend_backward(*a) for a in bwd],
              bound_sum(_blend_bwd_bound, t), bound_sum(_blend_bwd_bound),
              rounding_codes_checked=checked)

        # As the train path passes them: with each slice's num_valid.
        jobs = [(vids.reshape(-1).clamp_min(0), g.reshape(-1, 64), sl.num_valid)
                for (vids, _, _), g, sl in zip(streams, gsf, slices)]
        jobs_f32 = [(job[0], widen(job[1], t), *job[2:]) for job in jobs]
        got = scatter.scatter_add_rows_batch(jobs, num_v, t)
        want = scatter.scatter_add_rows_batch_twin(jobs, num_v, t)
        err = (_nan_aware_err(got, want, f"scatter_add_rows{sfx}") if mini
               else _max_err(got, want))
        _check(got.dtype == torch.float32, f"scatter_add_rows{sfx}: dtype")
        _check(err <= TOLERANCES["scatter_add_rows"], f"scatter_add_rows{sfx}: err {err}")
        del got, want
        entry(f"scatter_add_rows{sfx}", "scatter_add_rows",
              "tetranerf_tpu/ops/pallas_scatter.py:105", "tetranerf_torch/csrc/scatter.cu", err,
              lambda: scatter.scatter_add_rows_batch(jobs, num_v, t),
              lambda: scatter.scatter_add_rows_batch_twin(jobs, num_v, t),
              lambda: scatter.scatter_add_rows_batch(jobs_f32, num_v),
              _scatter_batch_bound(jobs, num_v, t), _scatter_batch_bound(jobs_f32, num_v))
        if name == "float8_e8m0fnu":
            e = entries[-1]
            nan_rows = sum(int(job[1].isnan().any(dim=1).sum()) for job in jobs_f32)
            print(f"scatter_add_rows{sfx}: on its {nan_rows} rows with a NaN (of "
                  f"{sum(job[1].shape[0] for job in jobs_f32)}) {e['ms']:.4f} ms by CUDA events "
                  f"({e['device_ms']} by the profiler), the f32 instance on the same rows "
                  f"{e['f32_ms']:.4f} ms ({e['f32_device_ms']}); before NaN rows skipped "
                  f"the float atomics (PERF.md rows 7 and 7-sw): 2.2784 and 2.3248 ms")
        for e in entries[-3:]:
            e["stream"] = name
        del gsf, jobs, jobs_f32
    return entries


def lever_phase(colors, mesh_plain, dev):
    """Phase 19: the stream levers. K2, K2b and K7's low-precision instances
    against their plain versions (:func:`_lever_kernel_checks`); then the
    preset in f32, with each low-precision ``field_stream_dtype`` and with
    ``grad_stream_budget_per_ray`` from the same seeds: the first step's
    loss against f32 (the budget's forward is f32's, bit for bit; a
    float8_e8m0fnu stream's losses are NaN, as JAX's), the rays the budget
    drops, ms/step and, for each low-precision stream, its instances' ms per
    steady step beside their bounds and the f32 kernels'. Returns the
    kernel entries, each low-precision stream run's launches by its path
    (:data:`LOWP_PATHS`), and the budget run's launches
    (``budget_train``)."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.ops.stream_dtypes import STREAM_TYPES
    from tetranerf_torch.training.trainer import TrainConfig, Trainer
    from tetranerf_torch.utils.synthetic import sample_sphere_rays

    t_phase = time.perf_counter()
    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(2), TRAIN_RAYS)
        entries = _lever_kernel_checks(mesh_plain.to(dev), torch.from_numpy(o).to(dev),
                                       torch.from_numpy(d).to(dev))
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)  # phase 7's five batches
    batches = [_train_batch(rng, TRAIN_RAYS) for _ in range(TRAIN_BATCHES)]
    runs = {}
    # In turns, the f32 run again last: medians on the host clock drift.
    for label, extra, steps in (
            ("f32", {}, LEVER_STEPS),
            *((name, {"field_stream_dtype": name}, LEVER_STEPS) for name in LOWP_STREAMS),
            ("budget", {"grad_stream_budget_per_ray": GRAD_BUDGET_PER_RAY}, LEVER_STEPS),
            *((name, {"field_stream_dtype": name}, MINI_STEPS) for name in MINI_STREAMS),
            ("f32 again", {}, LEVER_STEPS)):
        model = TetraNerf(tetranerf_preset(**extra), mesh_plain.num_vertices,
                          point_colors=colors, generator=torch.Generator().manual_seed(0),
                          device=dev)
        trainer = Trainer(TrainConfig(), model, mesh_plain, device=dev)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        losses, dropped, step_ms = [], [], []
        for step in range(steps):
            before = dict(cuda.launch_counts)
            t = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                m = trainer.train_step(batches[step % TRAIN_BATCHES])
            losses.append(float(m["loss"]))  # waits for the step
            step_ms.append((time.perf_counter() - t) * 1e3)
            dropped.append(int(m.get("grad_stream_dropped_rays", -1)))
        per_step = {k: n - before[k] for k, n in cuda.launch_counts.items()}
        launches = dict(cuda.launch_counts)
        med = float(np.median(step_ms[1:]))
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if label == "float8_e8m0fnu":  # no zero, no sign: NaN in JAX's model too
            _check(all(np.isnan(losses)), f"levers ({label}): losses {losses}, not NaN")
        elif label in MINI_STREAMS:
            _check(all(np.isfinite(losses)), f"levers ({label}): losses {losses}")
        else:
            _check(all(np.isfinite(losses)) and last < first,
                   f"levers ({label}): loss did not fall ({first} -> {last})")
        runs[label] = dict(trainer=trainer, losses=losses, dropped=dropped, median_ms=med,
                           launches=launches, per_step=per_step)
        print(f"levers ({label}): {steps} steps, median {med:.2f} ms/step "
              f"(steps 1-{steps - 1}); loss first 5 mean {first:.5f}, last 5 mean "
              f"{last:.5f}; launches in the last step "
              f"{ {k: v for k, v in per_step.items() if v} }")
    f32, budget = runs["f32"], runs["budget"]
    _check(budget["losses"][0] == f32["losses"][0],
           f"levers: the budget's first loss {budget['losses'][0]} is not f32's "
           f"{f32['losses'][0]} (its forward is the same)")
    _check(0 < max(budget["dropped"]) < TRAIN_RAYS,
           f"levers: the budget dropped {budget['dropped']} rays a step")
    _check(all(n == -1 for n in f32["dropped"]), "levers: dropped rays without a budget")
    kernels = ("stream_blend_gather", "stream_blend_backward", "scatter_add_rows")
    first_rel = {}
    for name in LOWP_STREAMS + MINI_STREAMS:
        lp, sfx = runs[name], STREAM_TYPES[name].suffix
        first_rel[name] = abs(lp["losses"][0] - f32["losses"][0]) / f32["losses"][0]
        _check(first_rel[name] <= LOWP_LOSS_RTOL[name] or name == "float8_e8m0fnu",
               f"levers: the {name} stream's first loss rel err {first_rel[name]}")
        # Each instance runs in its own type's run and in no other.
        for label, run in runs.items():
            for k in kernels:
                n = run["launches"][k + sfx]
                _check(n > 0 if label == name else n == 0,
                       f"levers ({label}): {k + sfx} launched {n} times")
        expected = {k + sfx: n for k, n in zip(kernels, (1, 8, 1))}
        expected.update({k: 0 for k in kernels})
        for k, n in expected.items():
            _check(lp["per_step"][k] == n,
                   f"levers: {k} launched {lp['per_step'][k]} times in a steady {name} step, "
                   f"not {n}")
    print(f"levers: first loss f32 {f32['losses'][0]:.6f}, "
          + ", ".join(f"{name} stream {runs[name]['losses'][0]:.6f} (rel {first_rel[name]:.3g})"
                      for name in LOWP_STREAMS + MINI_STREAMS)
          + f", budget {budget['losses'][0]:.6f} (bit-equal); {GRAD_BUDGET_PER_RAY} slots a "
          f"ray drop {budget['dropped'][::4]} rays (every 4th step, of {TRAIN_RAYS}); median "
          f"ms/step " + ", ".join(f"{label} {run['median_ms']:.2f}" for label, run in runs.items()))
    step_ms = {}
    for label in ("f32", *LOWP_STREAMS, *MINI_STREAMS):
        trainer = runs[label]["trainer"]
        print(f"levers ({label}):")
        dev_ms = _profile_steps(trainer, batches[:2], runs[label]["median_ms"])
        with _recording_bounds() as bounds:
            trainer.train_step(batches[2])
        step_ms[label] = {k: dict(ms=dev_ms.get(k), bound_ms=v) for k, v in bounds.items()}
    for e in entries:
        name, f32_name, stream = e["name"], e["f32_instance"], e["stream"]
        e["flagship_step_ms"] = step_ms[stream].get(name, {}).get("ms")
        e["flagship_step_bound_ms"] = step_ms[stream].get(name, {}).get("bound_ms")
        e["f32_flagship_step_ms"] = step_ms["f32"].get(f32_name, {}).get("ms")
        e["f32_flagship_step_bound_ms"] = step_ms["f32"].get(f32_name, {}).get("bound_ms")
        e["launches_per_step"] = runs[stream]["per_step"][name]
        e["launches_path"] = LOWP_PATHS[stream]
        print(f"levers: {name} per steady flagship step {e['flagship_step_ms']} ms by the "
              f"profiler (the earlier design's, PERF.md: {EARLIER_STEP_MS.get(name)}), bound "
              f"{e['flagship_step_bound_ms']}; f32 instance {e['f32_flagship_step_ms']} ms "
              f"(before: {EARLIER_STEP_MS.get(f32_name)}), bound {e['f32_flagship_step_bound_ms']}")
        if f32_name == "scatter_add_rows" and e["flagship_step_ms"]:
            # The bound's bytes over the kernel time (K7's bound is bytes).
            e["flagship_step_bound_share"] = e["flagship_step_bound_ms"] / e["flagship_step_ms"]
            e["flagship_step_gb_per_s"] = (e["flagship_step_bound_ms"] * HBM_BYTES_PER_S
                                           / 1e9 / e["flagship_step_ms"])
            print(f"levers: {name} per steady flagship step: {e['flagship_step_ms']:.4f} ms "
                  f"against the earlier design's {EARLIER_STEP_MS.get(name)}, "
                  f"{e['flagship_step_bound_share']:.0%} of its bound "
                  f"{e['flagship_step_bound_ms']:.4f}, {e['flagship_step_gb_per_s']:.0f} GB/s "
                  f"of the bytes it must move")
    print(f"levers: phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return (entries, {LOWP_PATHS[name]: runs[name]["launches"]
                      for name in LOWP_STREAMS + MINI_STREAMS}, budget["launches"])


TRACER_RAYS = 8192
TRACER_STEPS = 512
TRACER_POINTS = 65_536
TRACER_SAMPLES = 64
TRACER_FIELD_DIM = 64
# Rows of each output also computed on the CPU, where the march and the
# walk run as their twins.
TRACER_CHECK_RAYS = 256
TRACER_CHECK_POINTS = 4096
# interpolate_values sums 4 products per output in another order on the
# card (a batched product) than on the CPU; its field gradient adds ~16
# rows of a vertex in atomic order.
INTERP_TOL = 1e-5
INTERP_GRAD_RTOL = 1e-5


def _bary_bound(mesh, cells, dt):
    """The barycentrics' tolerance where two marches' distances differ by
    ``dt``: 1e-4 plus twice the cell's largest plane normal times ``|dt|``
    (a plane ``n . p + d`` moves by ``|n| |dt|`` along a unit ray)."""
    import torch

    safe = cells.clamp(0, mesh.num_cells - 1).long()
    norm = mesh.planes[safe][..., :3].norm(dim=-1).amax(dim=-1)
    return 1e-4 + 2.0 * norm * dt.abs()


def _tracer_check(label, ours, ref, mesh, cells=None, dist_key=None):
    """Ids and masks exactly; distances to ``TOLERANCES["march"]``;
    barycentrics to :func:`_bary_bound` of ``cells`` at the distances'
    differences (to 1e-4 without ``dist_key``). Returns the largest
    barycentric error."""
    import torch

    for k, v in ref.items():
        x = ours[k].cpu()
        if k == dist_key:
            err = _max_err(x, v, finite_only=True)
            _check(err <= TOLERANCES["march"], f"tracer: {label} {k} err {err}")
        elif not v.is_floating_point():
            _check(torch.equal(x, v), f"tracer: {label} {k} differs from the CPU")
    bary = "barycentric_coordinates"
    diff = (ours[bary].cpu() - ref[bary]).abs()
    diff = diff.reshape(diff.shape[:2] + (-1,)).amax(-1) if diff.dim() > 2 else diff.amax(-1)
    if dist_key is None:
        bound = torch.full_like(diff, 1e-4)
    else:
        dt = ours[dist_key].cpu() - ref[dist_key]
        dt = torch.where(torch.isfinite(dt), dt, 0.0)
        dt = dt.abs().amax(-1) if dt.dim() > 2 else dt
        bound = _bary_bound(mesh, cells, dt)
    _check(bool((diff <= bound).all()), f"tracer: {label} barycentrics beyond "
           f"{float((diff - bound).max())} of their bound")
    return float(diff.max())


def tracer_phase(points, cells, dev):
    """Phase 21: ``TetrahedraTracer`` on phase 1's sphere (the device's mesh
    built by ``load_tetrahedra``): ``trace_rays`` of 8192 rays at 512
    (K1), ``trace_rays_triangles`` (K1), ``find_tetrahedra`` of 65,536
    points (K9), ``find_visited_cells`` of 64 samples a ray and
    ``interpolate_values`` of a 64-wide field forward and backward, each
    launch counted on this path (the path ``tracer``), each output's first
    rows against the same calls on the CPU, each call timed by CUDA events.
    Returns the launches."""
    import torch
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.ops.interpolation import interpolate_values
    from tetranerf_torch.tracer import TetrahedraTracer
    from tetranerf_torch.utils.synthetic import sample_sphere_rays

    t_phase = time.perf_counter()
    card, cpu = TetrahedraTracer(dev), TetrahedraTracer("cpu")
    card.load_tetrahedra(points, cells)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t_phase
    cpu.mesh = card.mesh.to("cpu")
    o, d = sample_sphere_rays(np.random.default_rng(3), TRACER_RAYS)
    rng = np.random.default_rng(4)
    lo, hi = points.min(axis=0), points.max(axis=0)
    query = rng.uniform(lo, hi, (TRACER_POINTS, 3)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(29)
    keys = ("num_visited_cells", "visited_cells", "barycentric_coordinates", "hit_distances",
            "vertex_indices")

    def samples(traced):
        hd, num = traced["hit_distances"], traced["num_visited_cells"].long()
        near = hd[:, 0, 0]
        far = hd[torch.arange(hd.shape[0], device=hd.device), (num - 1).clamp_min(0), 1]
        u = torch.rand((hd.shape[0], TRACER_SAMPLES), generator=gen, device=dev)
        return (near[:, None] + u.sort(dim=1).values * (far - near)[:, None]).contiguous()

    def interp(matched, field):
        return interpolate_values(matched["vertex_indices"],
                                  matched["barycentric_coordinates"], field)

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    traced = card.trace_rays(o, d, TRACER_STEPS)
    triangles = card.trace_rays_triangles(o, d, TRACER_STEPS)
    found = card.find_tetrahedra(query)
    dist = samples(traced)
    matched = card.find_visited_cells(*(traced[k] for k in keys), dist)
    field = torch.randn((TRACER_FIELD_DIM, card.mesh.num_vertices), generator=gen,
                        device=dev).requires_grad_()
    feats = interp(matched, field)
    g = torch.randn(feats.shape, generator=gen, device=dev)
    (feats * g).sum().backward()
    torch.cuda.synchronize()
    launches = dict(cuda.launch_counts)
    _check(launches["march"] == 2 and launches["locate"] == 1,
           f"tracer: K1 launched {launches['march']} times (2 expected), K9 "
           f"{launches['locate']} (1 expected)")

    n, m = TRACER_CHECK_RAYS, TRACER_CHECK_POINTS
    errs = {}
    ref = cpu.trace_rays(o[:n], d[:n], TRACER_STEPS)
    errs["trace_rays"] = _tracer_check(
        "trace_rays", {k: v[:n] for k, v in traced.items()}, ref, cpu.mesh,
        ref["visited_cells"].clamp_max(cpu.mesh.num_cells), "hit_distances")
    ref = cpu.trace_rays_triangles(o[:n], d[:n], TRACER_STEPS)
    # Hit k + 1 leaves interval k, hit 0 enters interval 0.
    visited = cpu.trace_rays(o[:n], d[:n], TRACER_STEPS - 1)["visited_cells"]
    cells_hit = torch.cat([visited[:, :1], visited], dim=1).clamp_max(cpu.mesh.num_cells)
    errs["trace_rays_triangles"] = _tracer_check(
        "trace_rays_triangles", {k: v[:n] for k, v in triangles.items()}, ref, cpu.mesh,
        cells_hit, "hit_distances")
    ref = cpu.find_tetrahedra(query[:m])
    errs["find_tetrahedra"] = _tracer_check(
        "find_tetrahedra", {k: v[:m] for k, v in found.items()}, ref, cpu.mesh)
    _check(0 < int(found["valid_mask"].sum()) < TRACER_POINTS,
           "tracer: find_tetrahedra found every point or none")
    # The matching and the interpolation on the card's own inputs, moved.
    traced_rows = {k: traced[k][:n].cpu() for k in keys}
    ref = cpu.find_visited_cells(*(traced_rows[k] for k in keys), dist[:n].cpu())
    errs["find_visited_cells"] = _tracer_check(
        "find_visited_cells", {k: v[:n] for k, v in matched.items()}, ref, cpu.mesh)
    _check(bool(matched["mask"].any()), "tracer: no sample matched a cell")
    field_cpu = field.detach().cpu().requires_grad_()
    ref_feats = interp({k: v[:n].cpu() for k, v in matched.items()}, field_cpu)
    (ref_feats * g[:n].cpu()).sum().backward()
    err = _max_err(feats[:n].detach().cpu(), ref_feats.detach())
    _check(err <= INTERP_TOL, f"tracer: interpolate_values err {err}")
    # The card's gradient has every ray's samples; the CPU's the first n.
    field_card = field.detach().clone().requires_grad_()
    (interp({k: v[:n] for k, v in matched.items()}, field_card) * g[:n]).sum().backward()
    grad_err = _max_err(field_card.grad.cpu(), field_cpu.grad)
    scale = float(field_cpu.grad.abs().max())
    _check(grad_err <= INTERP_GRAD_RTOL * scale,
           f"tracer: interpolate_values field gradient err {grad_err} of {scale}")
    errs["interpolate_values"] = err

    def backward():
        f = field.detach().requires_grad_()
        (interp(matched, f) * g).sum().backward()

    times = {
        "trace_rays": _time_ms(lambda: card.trace_rays(o, d, TRACER_STEPS), 5),
        "trace_rays_triangles": _time_ms(
            lambda: card.trace_rays_triangles(o, d, TRACER_STEPS), 5),
        "find_tetrahedra": _time_ms(lambda: card.find_tetrahedra(query), 5),
        "find_visited_cells": _time_ms(
            lambda: card.find_visited_cells(*(traced[k] for k in keys), dist), 5),
        "interpolate_values": _time_ms(lambda: interp(matched, field.detach()), 5),
        "interpolate_values forward and backward": _time_ms(backward, 5),
    }
    crossings = traced["num_visited_cells"].float()
    print(f"tracer: load_tetrahedra of {len(points)} points on the card {load_s:.2f} s; "
          f"{TRACER_RAYS} rays at {TRACER_STEPS}: crossings mean {float(crossings.mean()):.1f}, "
          f"max {int(crossings.max())}; {int(found['valid_mask'].sum())} of {TRACER_POINTS} "
          f"points inside; {int(matched['mask'].sum())} of {matched['mask'].numel()} samples "
          f"matched; launches on the path {({k: v for k, v in launches.items() if v})}")
    for k, ms in times.items():
        print(f"tracer: {k} {ms:.3f} ms by CUDA events"
              + (f"; first rows against the CPU: max err {errs[k]:.3g}" if k in errs else ""))
    print(f"tracer: phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return launches, times


# Phase 22: the API surface on a tetrahedra file made by the port's CLI.
API_STEPS = 32
API_RANDOM_POINTS = 0.5
API_CHUNKS = (8192, 4096)
# The adapter model's image at two chunks, with one bound and one sample
# budget for every ray (ray_buckets=1): only the GEMMs' row count differs.
API_CHUNK_TOL = 1e-5
# The render CLI's PSNR and the metric hook's on the same bits (float64 on
# the card both).
API_PSNR_TOL = 1e-6
# Phase 23: the live viewer over 1 x 2 model shards (gloo ranks on one card):
# a fast frame and a full frame's band, held to one process's frames.
VIEWER_SHARD_FAST_SIDE = 128
VIEWER_SHARD_FULL_SIDE = 256
VIEWER_SHARD_BAND = (0, 32)
VIEWER_SHARD_TIMED_STEPS = 8
VIEWER_SHARD_TOL = 1e-5
VIEWER_SHARD_PNG_LEVELS = 1
# (label, ranks, device, backend, model shards), as phase 20's runs.
VIEWER_SHARD_RUN = ("viewer1x2", 2, "cuda:0", "gloo", 2)
VIEWER_SHARD_POSE = (0.6, 2.3, 0.7)
VIEWER_SHARD_LATE_POSE = (-1.9, 1.3, 0.9)


def _same_bits(got, want, label):
    """``got`` (tensors) equal to ``want`` (numpy) key for key, bit for bit."""
    _check(got.keys() == want.keys(), f"{label}: keys {sorted(got)} vs {sorted(want)}")
    for k in want:
        _check(np.array_equal(got[k].cpu().numpy(), want[k]), f"{label}: {k} differs")


def api_phase(data, dev, tmp):
    """Phase 22 (path ``api``): phase 14's dataset's points through
    ``tetranerf-torch-triangulate`` with random points, the unmodified
    preset trained on that file for :data:`API_STEPS` steps through
    ``cli.main``, restored as ``scripts/render.py`` restores, then the
    serving API on the card: ``TorchRenderAdapter`` on the 8 test views'
    CUDA tensors bit-equal to ``render_rays``; ``TetraNerfAdapterModel`` at
    chunks 8192 and 4096 each bit-equal to ``render_rays`` at its chunk,
    and the two chunks within :data:`API_CHUNK_TOL` with one bucket;
    ``state_dict`` into a fresh trainer rendering bit-equal; the metric
    hook's PSNR against the render CLI's on view 0. Returns the launches."""
    import torch
    from tetranerf_torch.geometry import load_tetrahedra, write_ply
    from tetranerf_torch.models import TetraNerf
    from tetranerf_torch.nerfstudio_model import TetraNerfAdapterModel
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.scripts import render, triangulate
    from tetranerf_torch.torch_adapter import TorchRenderAdapter
    from tetranerf_torch.training import cli
    from tetranerf_torch.training.trainer import Trainer
    from tetranerf_torch.utils.profiling import benchmark

    t_phase = time.perf_counter()
    cloud = load_tetrahedra(data / "tetra.npz")
    ply, th = tmp / "cloud.ply", tmp / "tetra.th"
    write_ply(ply, cloud["vertices"], cloud["colors"][:, :3])
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        triangulate.main(["--pointcloud", str(ply), "--output", str(th),
                          "--random-points-ratio", str(API_RANDOM_POINTS)])
    tri_s = time.perf_counter() - t
    tet = load_tetrahedra(th)
    num_points = len(cloud["vertices"])
    _check(len(tet["vertices"]) == num_points + int(num_points * API_RANDOM_POINTS)
           and tet["cells"].max() == len(tet["vertices"]) - 1,
           f"api: triangulate wrote {len(tet['vertices'])} vertices")
    print(f"api: tetranerf-torch-triangulate of the dataset's {num_points} points with "
          f"--random-points-ratio {API_RANDOM_POINTS}: {len(tet['vertices'])} vertices, "
          f"{len(tet['cells'])} cells in {tri_s:.2f} s (host: KD-tree spacing, Qhull)")

    never = str(10 * API_STEPS)  # no eval inside the run; the final eval runs
    args = ["--data", str(data), "--tetrahedra-path", str(th), "--device", str(dev),
            "--output-dir", str(tmp / "out"), "--max-num-iterations", str(API_STEPS),
            "--log-every", str(API_STEPS), "--steps-per-eval-batch", never,
            "--steps-per-eval-image", never, "--steps-per-eval-all-images", never]
    t = time.perf_counter()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(io.StringIO()):
        cli.main(args)
    final = json.loads(stdout.getvalue().strip().splitlines()[-1])
    _check(np.isfinite(final["psnr"]), f"api: final metrics {final}")
    print(f"api: cli.main, {API_STEPS} steps of the unmodified preset on that file with "
          f"the final eval over the test views: {time.perf_counter() - t:.2f} s; final "
          f"{final}")

    t = time.perf_counter()
    trainer, test = render.load_trainer(tmp / "out" / "final", data, "test", th, device=dev)
    print(f"api: restored as scripts/render.py restores in {time.perf_counter() - t:.2f} s")
    views = [test.camera_rays(i) for i in range(test.num_images)]
    o = np.concatenate([v[0] for v in views])
    d = np.concatenate([v[1] for v in views])
    o_dev, d_dev = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    adapter = TorchRenderAdapter(trainer, chunk=API_CHUNKS[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = adapter.get_outputs(o_dev, d_dev)
    torch.cuda.synchronize()
    adapter_s = time.perf_counter() - t
    t = time.perf_counter()
    want = trainer.render_rays(o, d, chunk=API_CHUNKS[0])
    render_s = time.perf_counter() - t
    _check(all(v.device == dev for v in out.values()), "api: adapter outputs off the card")
    _same_bits(out, want, "api: adapter vs render_rays")
    print(f"api: TorchRenderAdapter.get_outputs on {len(o)} rays on {dev} (the "
          f"{test.num_images} test views) at chunk {API_CHUNKS[0]}: bit-equal to "
          f"Trainer.render_rays in keys "
          f"{sorted(want)}; {len(o) / adapter_s:,.0f} rays/s (outputs stay on the card) "
          f"against render_rays' {len(o) / render_s:,.0f} rays/s (numpy out)")
    o0, d0 = o_dev[: len(views[0][0])], d_dev[: len(views[0][0])]
    bench_s = benchmark(adapter.get_outputs, [(o0, d0)], warmup=1, repeats=2,
                        min_dispatches=2)
    event_ms = _time_ms(lambda: adapter.get_outputs(o0, d0), 2)
    print(f"api: one view ({len(o0)} rays) through the adapter: utils.profiling.benchmark "
          f"{bench_s * 1e3:.2f} ms a call (2 calls between two synchronisations, best of "
          f"2), CUDA events {event_ms:.2f} ms (median of 2)")

    h, w = test.height, test.width
    bundle = types.SimpleNamespace(origins=o0.reshape(h, w, 3), directions=d0.reshape(h, w, 3))
    images = {}
    for chunk in API_CHUNKS:
        img = TetraNerfAdapterModel(trainer, chunk=chunk).get_outputs_for_camera_ray_bundle(
            bundle)
        _check(img["rgb"].shape == (h, w, 3) and img["depth"].shape == (h, w, 1),
               f"api: adapter model shapes {img['rgb'].shape}")
        _same_bits({k: v.reshape(h * w, *v.shape[2:]) for k, v in img.items()},
                   trainer.render_rays(views[0][0], views[0][1], chunk=chunk),
                   f"api: TetraNerfAdapterModel at chunk {chunk}")
        images[chunk] = img
    bucketed = {k: _max_err(images[API_CHUNKS[0]][k], images[API_CHUNKS[1]][k])
                for k in ("rgb", "depth", "accumulation")}
    one_cfg = dataclasses.replace(trainer.config, model=dataclasses.replace(
        trainer.model.config, ray_buckets=1))
    one_bucket = Trainer(one_cfg, TetraNerf(one_cfg.model, trainer.mesh.num_vertices,
                                            num_train_images=test.num_images, device=dev),
                         trainer.mesh, device=dev, auto_tune_steps=False)
    one_bucket.model.load_state_dict(trainer.model.state_dict())
    plain = [TetraNerfAdapterModel(one_bucket, chunk=c).get_outputs_for_camera_ray_bundle(
        bundle) for c in API_CHUNKS]
    plain_err = {k: _max_err(plain[0][k], plain[1][k]) for k in ("rgb", "depth", "accumulation")}
    _check(max(plain_err.values()) <= API_CHUNK_TOL,
           f"api: ray_buckets=1 chunks {API_CHUNKS} differ by {plain_err}")
    print(f"api: TetraNerfAdapterModel.get_outputs_for_camera_ray_bundle on view 0 "
          f"({h}x{w}) at chunks {API_CHUNKS}: each bit-equal to render_rays at its chunk; "
          f"the two chunks' max abs differences with ray_buckets=1 {plain_err} (tolerance "
          f"{API_CHUNK_TOL}), with the preset's 8 quantile buckets {bucketed} (a ray's "
          f"bucket, so its bound and adaptive sample budget, is its crossing-count rank "
          f"within its chunk)")
    del one_bucket, plain

    state = adapter.state_dict()
    fresh = Trainer(trainer.config, TetraNerf(trainer.model.config, trainer.mesh.num_vertices,
                                              num_train_images=test.num_images, device=dev),
                    trainer.mesh, device=dev, auto_tune_steps=False)
    TorchRenderAdapter(fresh).load_state_dict(state)
    again = TorchRenderAdapter(fresh, chunk=API_CHUNKS[0]).get_outputs(o0, d0)
    _same_bits(again, trainer.render_rays(views[0][0], views[0][1], chunk=API_CHUNKS[0]),
               "api: state_dict into a fresh trainer")
    field = state["tetrahedra_field"]
    print(f"api: state_dict ({len(state)} tensors, tetrahedra_field {tuple(field.shape)}) "
          f"loaded into a freshly built trainer renders view 0 bit-equal")
    del fresh

    model = TetraNerfAdapterModel(trainer, chunk=16384)
    img = model.get_outputs_for_camera_ray_bundle(bundle)
    metrics, panels = model.get_image_metrics_and_images(
        img, {"image": torch.from_numpy(test.images[0]).to(dev)})
    with contextlib.redirect_stderr(io.StringIO()):  # the CLI's render of view 0
        cli_metrics = render.render_split(trainer, test, tmp / "renders", chunk=16384,
                                          max_images=1)
    psnr_err = abs(metrics["psnr"] - cli_metrics["psnr"])
    _check(psnr_err <= API_PSNR_TOL and metrics["nerfstudio_ssim"] == metrics["mipnerf_ssim"]
           and panels["img"].shape == (h, 2 * w, 3),
           f"api: metric hook {metrics} vs the render CLI {cli_metrics}")
    launches = dict(cuda.launch_counts)
    for k in ("march", "stream_blend_gather", "sample_interp", "row_gather"):
        _check(launches[k] > 0, f"api: {k} did not launch: {launches}")
    print(f"api: get_image_metrics_and_images on view 0: psnr {metrics['psnr']:.6f} against "
          f"the render CLI's {cli_metrics['psnr']:.6f} on the same view (tolerance "
          f"{API_PSNR_TOL}), mipnerf_ssim = nerfstudio_ssim {metrics['mipnerf_ssim']:.5f}")
    print(f"api: launches over the phase: K1 {launches['march']}, K2 "
          f"{launches['stream_blend_gather']}, K3 {launches['sample_interp']}, K8 "
          f"{launches['row_gather']}; all {launches}")
    del trainer, adapter, model
    torch.cuda.empty_cache()
    print(f"api: phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _viewer_frames():
    """Phase 23's requests: ``(position, side, quality, rows)``."""
    full = VIEWER_SHARD_FULL_SIDE
    return {"fast": (VIEWER_SHARD_POSE, VIEWER_SHARD_FAST_SIDE, "fast",
                     (0, VIEWER_SHARD_FAST_SIDE)),
            "full": (VIEWER_SHARD_POSE, full, "full", VIEWER_SHARD_BAND),
            "late": (VIEWER_SHARD_LATE_POSE, VIEWER_SHARD_FAST_SIDE, "fast",
                     (0, VIEWER_SHARD_FAST_SIDE))}


def _post_frame(port, frame, replies, key):
    """POST ``frame`` to the viewer on ``port``; ``replies[key]`` becomes
    ``(status, PNG bytes, seconds)``."""
    import urllib.error
    import urllib.request

    position, side, quality, rows = frame
    body = json.dumps({"position": list(position), "side": side, "quality": quality,
                       "rows": list(rows)}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/render", method="POST", data=body)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=SHARD_TIMEOUT_S) as r:
            replies[key] = (r.status, r.read(), time.perf_counter() - t)
    except urllib.error.HTTPError as exc:
        replies[key] = (exc.code, b"", time.perf_counter() - t)


def _queue_frame(viewer, frame, replies, key):
    """A client thread posting ``frame``; returns once rank 0 has queued it."""
    queued = len(viewer._queue)
    thread = threading.Thread(target=_post_frame, args=(viewer.port, frame, replies, key),
                              daemon=True)
    thread.start()
    deadline = time.perf_counter() + SHARD_TIMEOUT_S
    while len(viewer._queue) == queued:
        _check(thread.is_alive() and time.perf_counter() < deadline,
               f"viewer shards: frame {key} was never queued")
        time.sleep(0.005)
    return thread


def _viewer_rank_run(trainer, group):
    """A rank of phase 23: every rank builds a viewer, rank 0 serves it.
    The fast and full frames are queued before a 2-step ``fit``, a third
    frame during its step 1's eval, all three served at step 1's boundary;
    then :data:`VIEWER_SHARD_TIMED_STEPS` steps with the viewer attached
    and idle, and as many without it. Every rank keeps its frames'
    outputs; rank 0 the replies."""
    import torch
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.viewer import ViewerServer

    batches = _shard_batches()
    frames = _viewer_frames()
    viewer = ViewerServer(trainer, port=0, host="127.0.0.1")
    outputs, plain = [], viewer._frame_outputs

    def recording(*args):
        out = plain(*args)
        outputs.append({k: np.asarray(v) for k, v in out.items()})
        return out

    viewer._frame_outputs = recording
    replies, threads, fit_s = {}, [], {}

    def fit(label, steps, attached=True, eval_fn=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            trainer.fit(lambda i: batches[i % TRAIN_BATCHES], num_iterations=steps,
                        log_every=0, eval_fn=eval_fn, eval_every=1,
                        viewer=viewer if attached else None)
        torch.cuda.synchronize()
        fit_s[label] = time.perf_counter() - t

    def mid_run(step, tr):
        if tr.is_main and step == 1:  # queued while rank 0 evaluates
            threads.append(_queue_frame(viewer, frames["late"], replies, "late"))

    try:
        cuda.reset_launch_counts()
        if group.rank == 0:
            viewer.start()
            threads += [_queue_frame(viewer, frames[k], replies, k) for k in ("fast", "full")]
        fit("first", 2, eval_fn=mid_run)
        fit("attached", VIEWER_SHARD_TIMED_STEPS)
        fit("detached", VIEWER_SHARD_TIMED_STEPS, attached=False)
        launches = dict(cuda.launch_counts)
        if group.rank == 0:
            _post_frame(viewer.port, frames["fast"], replies, "after_fit")
            for thread in threads:
                thread.join(SHARD_TIMEOUT_S)
            _check(not any(t.is_alive() for t in threads), "viewer shards: a client waits")
    finally:
        viewer.stop()
    return dict(outputs=outputs, replies=replies, fit_s=fit_s, launches=launches,
                rank=group.rank)


def viewer_shard_phase(points, colors, cells, mesh_plain, dev, tmp):
    """Phase 23 (path ``viewer_shards``): the live viewer over 1 x 2 model
    shards, gloo ranks on ``cuda:0`` as in phase 20, rank 0 serving the
    socket: a fast and a full frame queued before ``fit`` are served after
    step 1, and equal a no-group trainer's frames after the same step
    (float outputs to :data:`VIEWER_SHARD_TOL`, PNGs to
    :data:`VIEWER_SHARD_PNG_LEVELS` of 255); a frame asked for mid-run is
    answered; ms/step with the viewer attached and without; each frame's
    latency. Returns rank 0's launches over the viewer's run."""
    import torch
    from tetranerf_torch.utils.png import read_png
    from tetranerf_torch.viewer import ViewerServer, _colorize

    t_phase = time.perf_counter()
    np.savez(tmp / "scene.npz", points=points, colors=colors, cells=cells)
    label, world, device, backend, model_shards = VIEWER_SHARD_RUN
    ranks, wall = _spawn_ranks(tmp, label, world, device, backend, model_shards, viewer=True)
    frames = _viewer_frames()
    ref_trainer = _shard_trainer(dev, mesh_plain=mesh_plain, colors=colors)
    ref_viewer = ViewerServer(ref_trainer, port=0)
    batches = _shard_batches()
    want = {}
    with contextlib.redirect_stderr(io.StringIO()):
        ref_trainer.train_step(batches[0])
    for key in ("fast", "full"):
        position, side, quality, rows = frames[key]
        want[key] = ref_viewer._frame_outputs(position, side, quality, rows)
    replies = ranks[0]["replies"]
    errs, levels = {}, {}
    for i, key in enumerate(("fast", "full")):
        status, png, _ = replies[key]
        _check(status == 200, f"viewer shards: {key} frame answered {status}")
        ref = want[key]
        for r in ranks:
            got = r["outputs"][i]
            _check(got.keys() == ref.keys(), f"viewer shards: {key} keys")
            errs[(key, r["rank"])] = max(
                float(np.abs(got[k].astype(np.float64) - ref[k].astype(np.float64)).max())
                for k in ref)
        path = tmp / f"{key}.png"
        path.write_bytes(png)
        rows = frames[key][3]
        image = _colorize(ref, (rows[1] - rows[0], frames[key][1]), "rgb")
        levels[key] = int(np.abs(read_png(path).astype(int) - image.astype(int)).max())
    _check(max(errs.values()) <= VIEWER_SHARD_TOL, f"viewer shards: outputs off by {errs}")
    _check(max(levels.values()) <= VIEWER_SHARD_PNG_LEVELS,
           f"viewer shards: PNG levels apart {levels}")
    _check(replies["late"][0] == 200 and len(replies["late"][1]) > 0,
           f"viewer shards: the mid-run frame answered {replies['late'][0]}")
    _check(replies["after_fit"][0] == 503,
           f"viewer shards: a frame after fit answered {replies['after_fit'][0]}")
    fit_s = ranks[0]["fit_s"]
    per_step = {k: fit_s[k] / VIEWER_SHARD_TIMED_STEPS * 1e3 for k in ("attached", "detached")}
    print(f"viewer shards: {world // model_shards} x {model_shards} {backend} ranks on {device} "
          f"({wall:.1f} s with start-up); the fast "
          f"{VIEWER_SHARD_FAST_SIDE}^2 frame and the full frame's rows {VIEWER_SHARD_BAND} of "
          f"{VIEWER_SHARD_FULL_SIDE}^2 queued before fit, served after step 1: max abs "
          f"differences from one process's frames after the same step {errs} (tolerance "
          f"{VIEWER_SHARD_TOL}), PNGs {levels} levels of 255 apart; latencies (queued to "
          f"PNG, step 1 and the frames) fast {replies['fast'][2]:.2f} s, full "
          f"{replies['full'][2]:.2f} s; a fast frame queued during step 1's eval answered "
          f"in {replies['late'][2]:.2f} s; a frame after fit refused (503) in "
          f"{replies['after_fit'][2] * 1e3:.1f} ms")
    print(f"viewer shards: {VIEWER_SHARD_TIMED_STEPS} steps with the viewer attached and "
          f"idle {per_step['attached']:.2f} ms/step, without it {per_step['detached']:.2f} "
          f"ms/step (rank 0, fit's wall time over the steps; the first fit of 2 steps "
          f"{fit_s['first']:.2f} s with the three frames)")
    del ref_trainer, ref_viewer
    torch.cuda.empty_cache()
    launches = ranks[0]["launches"]
    for k in ("march", "stream_blend_gather", "sample_interp", "row_gather"):
        _check(launches[k] > 0, f"viewer shards: {k} did not launch: {launches}")
    print(f"viewer shards: launches of rank 0 {launches}; phase 23 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 24: the fused MLPs' generic route (float32, and bf16 at widths the
# wgmma instances lack). Kernel vs twin at the train slice's shapes and one
# bucket shape; the float32 preset trained with fused MLPs; a bf16 run at
# field 32, hidden 64.
GENERIC_STEPS = 24
GENERIC_BF16_STEPS = 16
GENERIC_BF16_WIDTHS = {"field_dim": 32, "hidden_size": 64}
# One bucket shape of the flagship's cold step: 512 rays x 33 fine / 16
# coarse samples.
GENERIC_BUCKET = (512, 16, 16)
# float32 kernel vs twin (TF32 off): each output and gradient within 1e-4
# of its largest entry. The forward outputs of the twin and of the kernel
# within 1e-5 in relative norm of the exact function (the twin on float64
# tensors), which a TF32 product (a 10-bit mantissa, ~5e-4 relative a
# product) would miss by an order: the kernel's 3xTF32 may not slip to
# plain TF32. Not the gradients: where a pre-activation lies within f32
# rounding of 0 the ReLU masks of f32 and f64 differ, and that moves a
# row's cotangent by a whole term (dx: ~9e-4 in relative norm at the train
# shape, for kernel and twin alike, while the two agree to ~3e-7).
F32_MAX_RTOL = 1e-4
F32_EXACT_RTOL = 1e-5
_GENERIC_NAMES = ("fused_field_mlps", "fused_field_mlps_backward", "fused_density_mlp",
                  "fused_density_mlp_backward")


def _f32_check(name, triples, forward):
    """Max abs error over ``(kernel, twin, exact)`` triples: the kernel to
    F32_MAX_RTOL of the f32 twin and, for a ``forward``, the f32 twin and
    the kernel to F32_EXACT_RTOL of the float64 twin in relative norm
    (``exact`` None: the kernel to the f32 twin only)."""
    err = 0.0
    for i, (k, t, x) in enumerate(triples):
        e = _max_err(k, t)
        scale = float(t.abs().max())
        if x is None:
            print(f"  {name} output {i} {tuple(t.shape)}: max abs err {e:.3g} of largest "
                  f"{scale:.3g} ({e / max(scale, 1e-30):.3g})")
            _check(e <= F32_MAX_RTOL * max(scale, 1e-30),
                   f"{name}: output {i}: max abs err {e} against largest entry {scale}")
            err = max(err, e)
            continue
        x = x.double()
        k_exact = float((k.double() - x).norm() / x.norm().clamp_min(1e-30))
        t_exact = float((t.double() - x).norm() / x.norm().clamp_min(1e-30))
        print(f"  {name} output {i} {tuple(t.shape)}: max abs err {e:.3g} of largest "
              f"{scale:.3g} ({e / max(scale, 1e-30):.3g}); relative norm to the f64 twin: "
              f"kernel {k_exact:.3g}, f32 twin {t_exact:.3g}")
        _check(e <= F32_MAX_RTOL * max(scale, 1e-30),
               f"{name}: output {i}: max abs err {e} against largest entry {scale}")
        _check(not forward or t_exact <= F32_EXACT_RTOL,
               f"{name}: output {i}: the f32 twin is {t_exact} from the f64 twin (TF32?)")
        _check(not forward or k_exact <= F32_EXACT_RTOL,
               f"{name}: output {i}: the kernel is {k_exact} from the f64 twin (TF32?)")
        err = max(err, e)
    return err


def _generic_kernel_checks(model, dev, route="generic"):
    """K4, K4b, K5 and K5b of ``model``'s stack (which the plan routes to
    ``route``'s kernels: the generic route, or phase 25's layered one)
    against their twins at the train slice's shapes (4096 rays x 257 / 128
    samples) and at GENERIC_BUCKET; at the train shape each kernel's
    CUDA-event ms beside its bound, the twin's and the un-fused stack's at
    the same dtype. Returns the entries ``{wrapper: dict}``."""
    import torch
    from tetranerf_torch.models import TetraNerf
    from tetranerf_torch.ops import mlp

    cfg = model.config
    dt = model.compute_dtype
    f32 = dt == torch.float32
    layered = route == "layered"
    flops = TF32X3_FLOPS if f32 else BF16_TENSOR_FLOPS
    # The layered float32 forward runs its products as f32 FMAs.
    fwd_flops = F32_FLOPS if f32 and layered else flops
    n_base, n_head = len(model.mlp_base.layers), len(model.mlp_head.layers)
    design = {False: "3xTF32 on mma.sync m16n8k8 (f32 sums a k8 step)",
              True: "forward chain as f32 FMAs in the twin's order (its ReLU masks), the "
                    "rest 3xTF32 on mma.sync m16n8k8"} if f32 else {
        False: "bf16 on mma.sync m16n8k16", True: "bf16 on mma.sync m16n8k16"}
    if f32 and layered:
        design[False] = "f32 FMAs in the twin's order"
    elif layered:
        design = {b: "bf16 on wgmma m64n128k16, two warpgroups a 128 x 128 tile, operands "
                     "(weights, x, activations, cotangents as bf16 copies) by cp.async into a "
                     "ring of 64-deep stages in the 128-byte swizzle; epilogues staged in "
                     "shared memory, a cotangent's bias and ray sums per tile" +
                     ("; the heads' gradients one pass over a_nb and a_L" if b else "")
                  for b in (False, True)}

    def passes(plan):
        if plan.phases == 1:
            return "one kernel, every weight gradient summed in shared memory"
        return ("the forward chain first, at the forward's warps, into a cache in global "
                "memory (activations, ReLU bits, head cotangents), then a pass over the "
                f"layers adding the cotangents to it, then {plan.phases - 1} weight-gradient "
                "phases reading it back")
    # Phase 25's deep stack takes the layered route for its field MLPs only:
    # its density MLP (6 layers) is on the wgmma route, which phase 8 checks.
    skip = set()
    for backward in (False, True):
        for heads in (n_head, 0):
            plan = mlp.launch_plan(cfg.field_dim, cfg.hidden_size, n_base, heads, backward, dt)
            if layered and not heads and plan.route != route:
                skip.add("fused_density_mlp_backward" if backward else "fused_density_mlp")
                continue
            _check(plan.route == route, f"{route}: {plan} for {cfg.field_dim} x "
                                        f"{cfg.hidden_size} at {dt}")
            if layered:
                rays = mlp.layered_chunk_rays(plan, TRAIN_RAYS, cfg.num_samples + (
                    cfg.num_fine_samples + 1 if heads else 0))
                print(f"layered route design, {cfg.field_dim} x {cfg.hidden_size} x "
                      f"{n_base} + {heads} {str(dt).split('.')[-1]}, "
                      f"{'K4b/K5b' if backward else 'K4/K5'}: {design[backward]}; a product "
                      f"kernel a layer, blocks of {plan.rows_per_tile} x "
                      f"{64 if f32 else 128} outputs, a ring of {plan.stages} stages in "
                      f"{plan.smem_bytes} bytes of shared memory; {plan.aux_tile_floats * 4} "
                      f"bytes of scratch a row, chunks of {rays} rays at the train shape; "
                      f"{plan.ws_floats * 4} bytes beside the rows (the backward's "
                      f"workspace, the weights' bf16 copies)")
                continue
            print(f"generic route design, {cfg.field_dim} x {cfg.hidden_size} "
                  f"{str(dt).split('.')[-1]}, {'K4b/K5b' if backward else 'K4/K5'} "
                  f"{'field' if heads else 'density'}: {design[backward]}; weights "
                  f"{'resident' if plan.resident else 'streamed in 64-column slabs'}; "
                  f"{plan.warps} warps, {plan.rows_per_tile} rows a block, "
                  f"{plan.smem_bytes} bytes of shared memory"
                  + (f"; {passes(plan)}" if backward else ""))
    plain = TetraNerf(dataclasses.replace(cfg, fused_mlps=False),
                      model.tetrahedra_field.shape[0], device=dev)
    plain.load_state_dict(model.state_dict())
    params = [p for n, p in plain.named_parameters() if n != "tetrahedra_field"]
    gen = torch.Generator(device=dev).manual_seed(24)
    with torch.no_grad():
        weights = [w.detach() for w in model.fused_field_inputs(
            torch.zeros(1, 3, device=dev))[1]]
        w_dens = [w.detach() for w in model.density_weights()]
    label = f"{cfg.field_dim} x {cfg.hidden_size} {str(dt).split('.')[-1]}"
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def check(name, kernel, twin, exact):
        if f32:
            return _f32_check(name, list(zip(kernel, twin, exact)), "backward" not in name)
        # Phase 25's bf16 stacks (up to 10 layers) are held to phase 8's
        # relative-norm tolerance: their largest single-entry differences
        # come from bf16 roundings on either side of a sum and ReLU masks
        # flipped near 0, compounded over the layers.
        return _rel_check(name, list(zip(kernel, twin)), None if layered else MLP_MAX_RTOL)

    def exact_of(fn, *args):
        """The twin on float64 tensors."""
        cast = [a.double() if torch.is_tensor(a) else
                [w.double() for w in a] if isinstance(a, list) else a for a in args]
        return fn(*cast)

    def flat(res):
        if torch.is_tensor(res):
            return [res]
        return [t for r in res for t in (r if isinstance(r, list) else [r])]

    shapes = [(TRAIN_RAYS, cfg.num_samples, cfg.num_fine_samples), GENERIC_BUCKET]
    for rays, n_coarse, n_fine in shapes:
        train_shape = rays == TRAIN_RAYS
        torch.cuda.reset_peak_memory_stats(dev)
        num_fine = n_coarse + n_fine + 1
        x = randn(rays, num_fine, cfg.field_dim)
        d = torch.nn.functional.normalize(randn(rays, 3), dim=1)
        g_rgb, g_dens = randn(rays, num_fine, 3), randn(rays, num_fine, 1)
        x_c, g_c = randn(rays, n_coarse, cfg.field_dim), randn(rays, n_coarse, 1)
        with torch.no_grad():
            head_dir = model.fused_field_inputs(d)[0].detach()
        at = f"{label} at {rays} rays x {num_fine} / {n_coarse} samples"
        fwd = (x, head_dir, weights, n_base, n_head, dt)
        bwd = (x, head_dir, weights, g_rgb, g_dens, n_base, n_head, dt)
        fwd_c = (x_c, w_dens, n_base, dt)
        bwd_c = (x_c, w_dens, g_c, n_base, dt)
        cases = (
            ("fused_field_mlps", "tetranerf_tpu/ops/pallas_mlp.py:244", mlp.fused_field_mlps,
             mlp.fused_field_mlps_twin, fwd, (x, head_dir, weights)),
            ("fused_field_mlps_backward", "tetranerf_tpu/ops/pallas_mlp.py:290",
             mlp.fused_field_mlps_backward, mlp.fused_field_mlps_backward_twin, bwd,
             (x, head_dir, weights)),
            ("fused_density_mlp", "tetranerf_tpu/ops/pallas_mlp.py:415",
             mlp.fused_density_mlp, mlp.fused_density_mlp_twin, fwd_c,
             (x_c, None, w_dens)),
            ("fused_density_mlp_backward", "tetranerf_tpu/ops/pallas_mlp.py:448",
             mlp.fused_density_mlp_backward, mlp.fused_density_mlp_backward_twin, bwd_c,
             (x_c, None, w_dens)),
        )
        for name, replaces, fn, twin_fn, args, bound_args in cases:
            if name in skip:
                continue
            backward = "backward" in name
            twin_out = flat(twin_fn(*args))
            exact = (flat(exact_of(twin_fn, *args)) if f32 and not (layered and backward)
                     else [None] * len(twin_out))
            err = check(f"{name}_{route} {at}", flat(fn(*args)), twin_out, exact)
            del twin_out, exact
            torch.cuda.empty_cache()
            if not train_shape:
                continue
            # float32: K4/K5's products as 3xTF32 (layered: f32 FMAs), K4b/K5b's
            # forward chain as f32 FMAs and the rest as 3xTF32; beside it every
            # product as f32 FMAs.
            bound = _mlp_bounds(*bound_args, flops=fwd_flops if not backward else flops,
                                chain_flops=F32_FLOPS if f32 else None)[backward]
            fma = (_mlp_bounds(*bound_args, flops=F32_FLOPS)["backward" in name]
                   if f32 else None)
            if name == "fused_field_mlps":
                with torch.no_grad():
                    library = _time_ms(lambda: plain.field_mlps(x, d), 5)
            elif name == "fused_density_mlp":
                with torch.no_grad():
                    library = _time_ms(lambda: plain.density_at(x_c), 5)
            else:
                xin, fn_plain, gr = ((x, lambda xg: plain.field_mlps(xg, d),
                                      (g_rgb, g_dens[..., 0]))
                                     if name == "fused_field_mlps_backward"
                                     else (x_c, plain.density_at, g_c[..., 0]))
                xg = xin.clone().requires_grad_()
                outs = fn_plain(xg)
                library = _time_ms(lambda: torch.autograd.grad(
                    outs, [xg, *params], gr, retain_graph=True, allow_unused=True), 5)
                del outs, xg
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base_bytes = torch.cuda.memory_allocated(dev)
            ms = _time_ms(lambda: fn(*args), 5)
            call_bytes = torch.cuda.max_memory_allocated(dev) - base_bytes
            twin_ms = _time_ms(lambda: twin_fn(*args), 3)
            extra = {"bound_f32_fma_ms": fma["bound_ms"]} if f32 else {}
            if layered:
                extra.update(_layered_extra(name, bound_args, dt, fwd_flops if not backward
                                            else flops, call_bytes, n_base, n_head))
                if backward:
                    # The backward's launches by kernel, and by mode and matrix.
                    heads = n_head if "field" in name else 0
                    rows = bound_args[0].shape[0] * bound_args[0].shape[1]
                    esz = 4 if f32 else 2
                    parts = _layered_launch_split(lambda: fn(*args), n_base + heads, rows,
                                                  (cfg.field_dim, cfg.hidden_size), esz, esz)
                    extra["launch_split"] = [dict(p, ms=round(p["ms"], 4)) for p in parts
                                             if "lay::" in p["kernel"]
                                             or p["kernel"].startswith("mode")]
                    print(f"{name}_{route} {at}: launches by kernel (profiler ms, bytes "
                          f"moved): " + json.dumps(extra["launch_split"]))
            print(f"{name}_{route} {at}: max abs err {err:.3g}; {ms:.3f} ms, twin "
                  f"{twin_ms:.3f} ms, un-fused stack {library:.3f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {bound['bound_peak']})"
                  + (f", f32 FMA bound {fma['bound_ms']:.4f} ms" if f32 else "")
                  + (f"; {extra}" if layered else ""))
            # No one PyTorch call computes the stack: library_ms stays null and
            # the un-fused stack's time goes beside it, as in phase 8.
            out[name] = _entry(f"{name}_{route}", "tetranerf_torch/csrc/mlp.cu", replaces,
                               err, ms, twin_ms, bound, unfused_ms=library,
                               compute_dtype=str(dt).split(".")[-1],
                               widths=[cfg.field_dim, cfg.hidden_size], **extra)
            torch.cuda.empty_cache()
        print(f"{route} fused MLP kernels {at}: within tolerance of their twins")
    del plain
    torch.cuda.empty_cache()
    return out


def _generic_train(cfg, colors, mesh_plain, dev, steps, label, ref, route="generic"):
    """``steps`` train steps of ``cfg`` (fused MLPs on ``route``) on phase
    7's batches: losses finite, launches by route; with ``ref`` also the
    last 4 losses below the first 4 and one 256-ray step against the CPU
    twins. Returns the run's launch counts and median ms a step."""
    import torch
    from tetranerf_torch.models import TetraNerf
    from tetranerf_torch.ops import cuda, mlp
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    model = TetraNerf(cfg, mesh_plain.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(TrainConfig(), model, mesh_plain, device=dev)
    rng = np.random.default_rng(1)  # phase 7's five batches
    batches = [_train_batch(rng, TRAIN_RAYS) for _ in range(TRAIN_BATCHES)]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    losses, step_ms = [], []
    for step in range(steps):
        t = time.perf_counter()
        losses.append(float(trainer.train_step(batches[step % TRAIN_BATCHES])["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(cuda.launch_counts)
    med = float(np.median(step_ms[1:]))
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    routes = {n: launches[n] for n in launches if "mlp" in n and launches[n]}
    print(f"{label}: {steps} steps of {TRAIN_RAYS} rays, median step {med:.2f} ms "
          f"(steps 1-{steps - 1}); loss first 4 mean {first:.5f}, last 4 mean "
          f"{last:.5f}; losses {[round(v, 5) for v in losses]}; fused MLP launches by "
          f"route {routes}")
    _check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    for name in _GENERIC_NAMES[:3]:
        if route == "generic":
            _check(launches[f"{name}_generic"] > 0, f"{label}: {name}_generic did not launch")
            _check(launches[name] == 0, f"{label}: {name} (wgmma) launched {launches[name]}")
            continue
        # Each kernel on the route its plan names (phase 25's deep stack: its
        # 6-layer density MLP on the wgmma route), none on another.
        heads = cfg.num_color_layers if "field" in name else 0
        plan = mlp.launch_plan(cfg.field_dim, cfg.hidden_size, cfg.num_density_layers, heads,
                               "backward" in name, cfg.compute_dtype)
        want = name if plan.route == "wgmma" else f"{name}_{plan.route}"
        for counter in (name, f"{name}_generic", f"{name}_layered"):
            _check((launches[counter] > 0) == (counter == want),
                   f"{label}: {counter} launched {launches[counter]} (the plan's: {want})")
    if ref:
        _check(last < first, f"{label}: loss did not fall ({first} -> {last})")
        _ref_step(label, model, trainer, _train_batch(rng, REF_RAYS), dev)
    del trainer, model
    torch.cuda.empty_cache()
    return launches, med


def generic_phase(colors, mesh_plain, dev):
    """Phase 24: the fused MLPs' generic route. Returns the kernels' entries
    (float32 at the preset's widths, with the bf16 run at field 32, hidden
    64 beside each) and the launch counts of the two train runs."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset

    t_phase = time.perf_counter()
    cfg32 = tetranerf_preset(fused_mlps=True, compute_dtype="float32")
    cfg16 = tetranerf_preset(fused_mlps=True, **GENERIC_BF16_WIDTHS)
    entries = {}
    for cfg in (cfg32, cfg16):
        model = TetraNerf(cfg, mesh_plain.num_vertices, point_colors=colors,
                          generator=torch.Generator().manual_seed(0), device=dev)
        entries[cfg.compute_dtype] = _generic_kernel_checks(model, dev)
        del model
        torch.cuda.empty_cache()
    launches32, med32 = _generic_train(cfg32, colors, mesh_plain, dev, GENERIC_STEPS,
                                       "generic float32 train", True)
    launches16, med16 = _generic_train(cfg16, colors, mesh_plain, dev, GENERIC_BF16_STEPS,
                                       "generic bf16 train (field 32, hidden 64)", False)
    out = []
    for name in _GENERIC_NAMES:
        e = entries["float32"][name]
        other = entries["bfloat16"][name]
        e["bf16_other_widths"] = {k: other[k] for k in (
            "widths", "max_abs_err", "ms", "plain_ms", "unfused_ms", "bound_ms", "bound_by")}
        e["train_median_step_ms"] = {"float32": med32, "bf16_other_widths": med16}
        out.append(e)
    print(f"generic: phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return out, launches32, launches16


# Phase 25: the fused MLPs' layered route (widths above 256, more than 8
# layers). Kernel vs twin at the train slice's shapes and GENERIC_BUCKET for
# a 512-wide stack in bf16 and float32 and a 6 + 4-layer stack in bf16
# (phase 24's tolerances); 16 cold steps of each stack in the preset's bf16.
LAYERED_STEPS = 16
LAYERED_STACKS = {"wide": {"hidden_size": 512},
                  "deep": {"num_density_layers": 6, "num_color_layers": 4}}
LAYERED_CHECKS = (("wide", "bfloat16"), ("wide", "float32"), ("deep", "bfloat16"))


def _layered_extra(name, bound_args, dt, flops, call_bytes, n_base, n_head):
    """A layered kernel's entry beside its bound: the bound's operations and
    bytes apart, and the bytes of the route's own activation traffic (each
    layer boundary's activation written and read back once; the backward's
    cotangents, operands of the dtype, written once and read by two
    products, its activations read again as masks and by the weight
    gradients), its time at the HBM rate, and the device bytes the timed
    call allocated."""
    import torch

    x, head_dir, weights = bound_args
    rows = x.shape[0] * x.shape[1]
    hidden = weights[0].shape[0]
    macs = sum(w.numel() for w in weights if w.dim() == 2)
    layers = n_base + (n_head if head_dir is not None else 0)
    esz = 2 if dt == torch.bfloat16 else 4
    chain = layers * hidden * esz * 2
    backward = "backward" in name
    per_row = x.shape[-1] * 4 + chain
    if backward:
        per_row += layers * hidden * (3 * esz + 2 * esz) + x.shape[-1] * 4
    ops = 2 * macs * rows * (3 if backward else 1)
    param_bytes = sum(w.numel() for w in weights) * 4
    io_bytes = (x.numel() * 4 + (0 if head_dir is None else head_dir.numel() * 4)
                + param_bytes) * (2 if backward else 1) + rows * (16 if head_dir is not None else 4)
    return dict(bound_ops_ms=_bound(0, ops, flops)["bound_ms"],
                bound_bytes_ms=_bound(io_bytes, 0)["bound_ms"],
                route_bytes=rows * per_row, route_bytes_ms=_bound(rows * per_row, 0)["bound_ms"],
                call_alloc_bytes=call_bytes)


def layered_phase(colors, mesh_plain, dev):
    """Phase 25: the fused MLPs' layered route. Returns the kernels' entries
    (the 512-wide stack in bf16, with its float32 and the deep stack's
    bf16 numbers beside each) and the launch counts of the two train runs."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset

    t_phase = time.perf_counter()
    entries = {}
    for stack, dtype in LAYERED_CHECKS:
        cfg = tetranerf_preset(fused_mlps=True, compute_dtype=dtype, **LAYERED_STACKS[stack])
        model = TetraNerf(cfg, mesh_plain.num_vertices, point_colors=colors,
                          generator=torch.Generator().manual_seed(0), device=dev)
        entries[stack, dtype] = _generic_kernel_checks(model, dev, route="layered")
        del model
        torch.cuda.empty_cache()
    runs = {}
    for stack in LAYERED_STACKS:
        cfg = tetranerf_preset(fused_mlps=True, **LAYERED_STACKS[stack])
        runs[stack] = _generic_train(cfg, colors, mesh_plain, dev, LAYERED_STEPS,
                                     f"layered bf16 train ({stack}: {LAYERED_STACKS[stack]})",
                                     stack == "wide", route="layered")
    out = []
    keys = ("widths", "max_abs_err", "ms", "plain_ms", "unfused_ms", "bound_ms", "bound_by",
            "bound_ops_ms", "bound_bytes_ms", "route_bytes", "route_bytes_ms", "launch_split")
    for name in _GENERIC_NAMES:
        e = entries["wide", "bfloat16"][name]
        f32 = entries["wide", "float32"][name]
        e["float32"] = {k: f32[k] for k in keys if k in f32}
        deep = entries["deep", "bfloat16"].get(name)
        e["deep_bf16"] = ({k: deep[k] for k in keys if k in deep} if deep
                          else "wgmma route (6 layers)")
        e["layers"] = {"wide": LAYERED_STACKS["wide"], "deep": LAYERED_STACKS["deep"]}
        e["train_median_step_ms"] = {stack: runs[stack][1] for stack in runs}
        out.append(e)
    print(f"layered: phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return out, runs["wide"][0], runs["deep"][0]


def _kernel_label(name):
    """A device kernel's short name from the profiler's demangled one:
    ``lay::wg_kernel<2>`` from ``void (anonymous namespace)::lay::wg_kernel<2>
    ((anonymous namespace)::lay::Prod)``."""
    import re

    m = re.search(r"(\w+::)?(\w+)(<[^()]*>)?\(", name)
    return (m.group(1) or "") + m.group(2) + (m.group(3) or "") if m else name[:60]


def _layered_launch_split(fn, n_layers, rows, widths, cot_bytes, act_bytes):
    """One call of ``fn`` (a layered kernel's wrapper) under torch.profiler:
    its device launches grouped by kernel and, for the products, by mode
    and matrix (the heads' products apart), each group's count, ms (the
    profiler's sum) and the activation, cotangent and input bytes its
    launches must move at this design's dtypes (``cot_bytes`` a cotangent
    element, ``act_bytes`` an activation's; the weights, workspaces and
    partial sums left out). ``widths`` = (d_in, hidden)."""
    events = _device_kernels(fn)
    d_in, hidden = widths
    in_dim = [d_in] + [hidden] * (n_layers - 1)
    groups, order = {}, []
    mat = {0: 0, 1: n_layers, 2: n_layers}
    after_top = False
    for e in sorted(events, key=lambda e: e.time_range.start):
        short = _kernel_label(e.name)
        mode = None
        for key in ("prod_kernel<true, ", "prod_kernel<false, ", "wg_kernel<", "prod_kernel<"):
            if key in short:
                mode = int(short.split(key)[1][0])
                break
        nbytes = 0
        if mode is None:
            label = short
            if "heads_" in short:  # heads_kernel, heads_bwd_kernel: a chunk's start
                after_top, mat[0], mat[1], mat[2] = False, 0, n_layers, n_layers
                nbytes = rows * (2 * hidden * act_bytes + 32)
            elif "top_" in short:
                after_top = True
                nbytes = rows * (16 + hidden * act_bytes + hidden * cot_bytes)
            elif "raysum" in short or "colsum" in short:
                nbytes = rows * hidden * cot_bytes
            elif "head_grad" in short:
                nbytes = rows * (16 + 2 * hidden * act_bytes)
        elif mode == 0:
            k = mat[0] % n_layers
            mat[0] += 1
            label = f"mode 0 (a layer), W_{k}"
            nbytes = rows * (in_dim[k] * (4 if k == 0 else act_bytes) + hidden * act_bytes)
        elif not after_top:
            label = "mode 2, the heads' dW"
            nbytes = rows * (16 + hidden * act_bytes)
        else:
            mat[mode] -= 1
            k = mat[mode]
            label = f"mode {mode}, W_{k}"
            if mode == 2:
                nbytes = rows * (hidden * cot_bytes + in_dim[k] * (4 if k == 0 else act_bytes))
            else:
                nbytes = rows * (hidden * cot_bytes + (in_dim[k] * (act_bytes + cot_bytes)
                                                       if k else d_in * 4))
        if label not in groups:
            groups[label] = {"launches": 0, "ms": 0.0, "bytes": 0}
            order.append(label)
        g = groups[label]
        g["launches"] += 1
        g["ms"] += e.time_range.elapsed_us() / 1e3
        g["bytes"] += nbytes  # the call's rows, once for each launch of a chunk
    chunks = max(groups.get("mode 0 (a layer), W_0", {"launches": 1})["launches"], 1)
    return [dict(kernel=label, **dict(groups[label], bytes=groups[label]["bytes"] // chunks))
            for label in order]


# --layered-split: the layered route's kernels alone at phase 25's shapes
# (and the wgmma and generic routes' at phase 8's and 24's), each timed by
# CUDA events, the backward's launches split by kernel; the same lines for
# any tree of the port, so that two trees are compared in turns on one card.
SPLIT_STACKS = (("wide", "bfloat16"), ("wide", "float32"), ("deep", "bfloat16"))


def layered_split(dev):
    """Each layered kernel of SPLIT_STACKS at phase 25's train shapes (4096
    rays x 257 samples; the density MLP's x 128) by CUDA events (median of
    5), and the bf16 backward's launches by kernel; then the
    preset's wgmma kernels (bf16) and generic ones (float32) at the same
    shapes. Returns ``{label: ms}``."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import mlp

    out = {}
    stacks = [(s, d, LAYERED_STACKS[s]) for s, d in SPLIT_STACKS]
    stacks += [("preset", "bfloat16", {}), ("preset", "float32", {})]
    for stack, dtype, extra in stacks:
        cfg = tetranerf_preset(fused_mlps=True, compute_dtype=dtype, **extra)
        dt = getattr(torch, dtype)
        model = TetraNerf(cfg, 8, generator=torch.Generator().manual_seed(0), device=dev)
        gen = torch.Generator(device=dev).manual_seed(24)
        n_base, n_head = len(model.mlp_base.layers), len(model.mlp_head.layers)
        n_fine = cfg.num_samples + cfg.num_fine_samples + 1
        with torch.no_grad():
            d = torch.nn.functional.normalize(
                torch.randn((TRAIN_RAYS, 3), generator=gen, device=dev), dim=1)
            head_dir, weights = (v.detach() if torch.is_tensor(v) else [w.detach() for w in v]
                                 for v in model.fused_field_inputs(d))
            w_dens = [w.detach() for w in model.density_weights()]
        x = torch.randn((TRAIN_RAYS, n_fine, cfg.field_dim), generator=gen, device=dev)
        g_rgb = torch.randn((TRAIN_RAYS, n_fine, 3), generator=gen, device=dev)
        g_dens = torch.randn((TRAIN_RAYS, n_fine, 1), generator=gen, device=dev)
        x_c = torch.randn((TRAIN_RAYS, cfg.num_samples, cfg.field_dim), generator=gen,
                          device=dev)
        g_c = torch.randn((TRAIN_RAYS, cfg.num_samples, 1), generator=gen, device=dev)
        calls = {
            "K4": (lambda: mlp.fused_field_mlps(x, head_dir, weights, n_base, n_head, dt),
                   n_head),
            "K4b": (lambda: mlp.fused_field_mlps_backward(x, head_dir, weights, g_rgb, g_dens,
                                                          n_base, n_head, dt), n_head),
            "K5": (lambda: mlp.fused_density_mlp(x_c, w_dens, n_base, dt), 0),
            "K5b": (lambda: mlp.fused_density_mlp_backward(x_c, w_dens, g_c, n_base, dt), 0),
        }
        for kernel, (fn, heads) in calls.items():
            plan = mlp.launch_plan(cfg.field_dim, cfg.hidden_size, n_base, heads,
                                   kernel.endswith("b"), dt)
            if stack != "preset" and plan.route != "layered":
                continue
            label = f"{stack} {dtype} {kernel} ({plan.route})"
            out[label] = _time_ms(fn, 5)
            torch.cuda.empty_cache()
            print(f"split: {label}: {out[label]:.3f} ms")
            if kernel.endswith("b") and stack != "preset" and dtype == "bfloat16":
                rows = TRAIN_RAYS * (n_fine if heads else cfg.num_samples)
                # PR 18's design keeps its cotangents f32; since PR 19 they
                # are bf16 operands (the plan's stages say which design runs).
                cot = 2 if plan.stages else 4
                parts = _layered_launch_split(fn, n_base + heads, rows,
                                              (cfg.field_dim, cfg.hidden_size), cot, 2)
                total = sum(p["ms"] for p in parts)
                print(f"split: {label} launches (profiler, {total:.3f} ms of device time): "
                      + json.dumps([dict(p, ms=round(p["ms"], 4)) for p in parts]))
                torch.cuda.empty_cache()
        del model, x, x_c, g_rgb, g_dens, g_c
        torch.cuda.empty_cache()
    return out


def _layered_split_main():
    """``chip_smoke.py --layered-split``: the build and layered_split alone;
    no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tetranerf_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    t = time.perf_counter()
    cuda.load()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    _mlp_build_report(cuda.build_log)
    dev = torch.device("cuda", 0)
    out = layered_split(dev)
    # Phase 25's train runs: 16 cold bf16 steps of each stack.
    from tetranerf_torch.geometry import build_mesh, triangulate
    from tetranerf_torch.models import tetranerf_preset
    from tetranerf_torch.utils.synthetic import make_sphere_scene

    points, colors = make_sphere_scene(NUM_POINTS, seed=0)
    mesh_plain = build_mesh(points, triangulate(points), device="cpu")
    for stack in LAYERED_STACKS:
        cfg = tetranerf_preset(fused_mlps=True, **LAYERED_STACKS[stack])
        out[f"{stack} bfloat16 train step"] = _generic_train(
            cfg, colors, mesh_plain, dev, LAYERED_STEPS, f"split: {stack} bfloat16 train", False,
            route="layered")[1]
    print("split: " + json.dumps(out))
    return 0


def native_geometry_check(points, cells, smi):
    """Phase 1's host geometry: the native library's adjacency and spacing
    against the numpy face-key sort and the KD-tree on this run's scene,
    each timed on the host clock."""
    from tetranerf_torch.geometry import delaunay, mesh, native

    _check(native.available(), "native: no C++ compiler on PATH")
    t = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t
    times = {}

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        times[label] = time.perf_counter() - t
        return out

    nb_native = timed("adjacency native", native.build_adjacency, cells)
    nb_numpy = timed("adjacency numpy", mesh.build_adjacency_numpy, cells)
    sp_native = timed("spacing native", native.average_spacing, points, 6)
    sp_tree = timed("spacing KD-tree", delaunay.average_spacing_kdtree, points, 6)
    _check(np.array_equal(nb_native, nb_numpy), "native: adjacency differs from numpy's")
    rel = abs(sp_native - sp_tree) / sp_tree
    _check(rel <= 1e-6, f"native: spacing {sp_native} vs KD-tree {sp_tree} (rel {rel})")
    print(f"native geometry on {len(points)} points, {len(cells)} cells (host of {smi}): "
          f"library built and loaded in {build_s:.2f} s; " + ", ".join(
              f"{k} {v:.3f} s" for k, v in times.items()) +
          f"; tables equal, spacing {sp_native:.9g} vs {sp_tree:.9g} (rel {rel:.3g})")
    return times


def _mlp_build_report(log):
    """``mlp.cu``'s kernels as ``-Xptxas -v`` reports them (registers,
    spills, stack), with the dynamic shared memory of the preset's launch
    plans."""
    import re
    from tetranerf_torch.ops.mlp import launch_plan

    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(mlp_fwd_kernel|mlp_aux_kernel|"
                      r"mlp_bwd_kernel|sum_rows_kernel)(?:ILi(\d+)ELi(\d+)E)?", line)
        g = re.search(r"Compiling entry function '\S*?gen\d+(fwd_kernel|bwd_kernel)ILb([01])E",
                      line)
        lay = re.search(r"Compiling entry function '\S*?lay\d+(\w+?_kernel)I?(?:Lb([01])E)?"
                        r"(?:Li(\d)E)?", line)
        if lay:
            args = ([("bf16" if lay.group(2) == "1" else "f32")] if lay.group(2) else []) + (
                [f"mode {lay.group(3)}"] if lay.group(3) else [])
            name = f"lay::{lay.group(1)}" + (f"<{', '.join(args)}>" if args else "")
            spill = ""
        elif m:
            name = m.group(1) + (f"<{m.group(2)}, {m.group(3)}>" if m.group(2) else "")
            spill = ""
        elif g:
            name = f"gen::{g.group(1)}<{'bf16' if g.group(2) == '1' else 'f32'}>"
            spill = ""
        elif "Compiling entry function" in line:
            name = None
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"mlp.cu {name}: {regs} registers; {spill}")
            name = None
    for n_head, what in ((1, "field (K4, K4b)"), (0, "density (K5, K5b)")):
        fwd, bwd = (launch_plan(64, 128, 3, n_head, b) for b in (False, True))
        print(f"mlp.cu launch plan, preset widths, {what}: forward {fwd.warpgroups} "
              f"warpgroups, {fwd.smem_bytes} bytes of shared memory; backward "
              f"{bwd.warpgroups} warpgroups, x prefetch {bool(bwd.stages)}, "
              f"{bwd.smem_bytes} bytes, workspace row {bwd.ws_floats} floats")
    fwd, bwd = (launch_plan(64, 128, 3, 1, b, "float32") for b in (False, True))
    print(f"mlp.cu launch plan, preset widths, float32 (generic route): forward "
          f"{fwd.warps} warps, {fwd.rows_per_tile} rows a block, weights "
          f"{'resident' if fwd.resident else 'streamed'}, {fwd.smem_bytes} bytes of shared "
          f"memory; backward {bwd.warps} warps, {bwd.phases} phases, {bwd.smem_bytes} bytes")


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--shard-rank"]:
        return _shard_rank_main(argv[1])
    if argv[:1] == ["--layered-split"]:
        return _layered_split_main()
    # --shard-ranks N [--model-shards M]: phase 18 alone with N ranks over
    # NCCL, one a card (a host with N cards), as N/M data shards by M model
    # shards; it prints phase 18's lines (and phase 20's with M > 1) and no
    # result line.
    shard_runs = None
    if argv[:1] == ["--shard-ranks"]:
        model = int(argv[3]) if argv[2:3] == ["--model-shards"] else 1
        shard_runs = ((f"nccl{argv[1]}x{model}", int(argv[1]), "cuda", "nccl", model),)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tetranerf_torch.geometry import build_mesh, triangulate
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
    chase_build = _start_chase_build()
    cuda.load()
    chase_lib = _load_chase(chase_build)
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    for line in cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    _mlp_build_report(cuda.build_log)

    t = time.perf_counter()
    points, colors = make_sphere_scene(NUM_POINTS, seed=0)
    cells = triangulate(points)
    mesh_plain = build_mesh(points, cells, device="cpu")
    mesh_cpu = mesh_plain.with_occupancy(synthetic_occupancy(mesh_plain))
    mesh = mesh_cpu.to(dev)
    print(f"scene: {NUM_POINTS} points, {mesh.num_cells} cells, "
          f"{len(mesh.hull_eqs)} hull facets, built in "
          f"{time.perf_counter() - t:.1f} s")
    native_geometry_check(points, cells, smi)

    chase_ns = dependent_load_ns(chase_lib, mesh.march_table)
    print(f"dependent loads over the {mesh.march_table.numel() * 4 / 1e6:.1f} MB march "
          f"table: {chase_ns[1]:.1f} ns a hop in 1 chain, {chase_ns[TRAIN_RAYS]:.1f} ns "
          f"in {TRAIN_RAYS} chains side by side (CUDA events, the hash included)")

    if shard_runs is not None:
        (ROOT / "build").mkdir(exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="shards_", dir=ROOT / "build"))
        try:
            if shard_runs[0][4] == 1:
                shard_phase(points, colors, cells, mesh_plain, dev, tmp, runs=shard_runs)
            else:
                _, ref = shard_phase(points, colors, cells, mesh_plain, dev, tmp, runs=())
                model_shard_phase(mesh_plain, dev, tmp, ref, runs=shard_runs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0

    cfg = tetranerf_preset(ray_buckets=1)
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)

    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(0), CHUNK)
        train_o, train_d = sample_sphere_rays(np.random.default_rng(2), TRAIN_RAYS)
        kernels = kernel_checks(
            mesh, model.tetrahedra_field.detach(),
            torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            (torch.from_numpy(train_o).to(dev), torch.from_numpy(train_d).to(dev)),
            chase_ns[TRAIN_RAYS],
        )
        golden_check(dev)

    paths = {"render": render_phase(model, mesh, mesh_cpu, dev)}

    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(2), TRAIN_RAYS)
        kernels += backward_checks(
            mesh_plain.to(dev), torch.from_numpy(o).to(dev),
            torch.from_numpy(d).to(dev),
            next(k for k in kernels if k["name"] == "stream_blend_gather"),
        )
    del model
    torch.cuda.empty_cache()

    paths["train"], _, plain_median = train_phase(colors, mesh_plain, dev)
    torch.cuda.empty_cache()

    # The fused-MLP configuration: the same seeded weights.
    model = TetraNerf(tetranerf_preset(ray_buckets=1, fused_mlps=True),
                      mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    kernels += mlp_checks(model, dev)
    torch.cuda.empty_cache()
    paths["render_fused"] = render_phase(model, mesh, mesh_cpu, dev, FUSED_RENDER_KERNELS)
    del model
    torch.cuda.empty_cache()
    paths["train_fused"], step_launches, _ = train_phase(colors, mesh_plain, dev,
                                                         fused=True)
    torch.cuda.empty_cache()

    # The preset as it ships: bucketed shading through K8, the retunes.
    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(2), TRAIN_RAYS)
        kernels.append(gather_checks(mesh_plain.to(dev), torch.from_numpy(o).to(dev),
                                     torch.from_numpy(d).to(dev)))
    march_kernels = next(k for k in kernels if k["name"] == "march")["march_kernels_per_call"]
    (trainer, paths["flagship_train"], flagship_step, flagship_ms,
     flagship_cold_ms) = flagship_train_phase(colors, mesh_plain, dev, plain_median,
                                              march_kernels)
    paths["flagship_render"] = flagship_render_phase(trainer, dev)
    del trainer
    torch.cuda.empty_cache()

    # Training from disk through the port's CLI, then serving its checkpoint.
    (ROOT / "build").mkdir(exist_ok=True)
    cli_dir = Path(tempfile.mkdtemp(prefix="cli_smoke_", dir=ROOT / "build"))
    try:
        paths["cli_train"], cli_final = cli_phase((points, colors, cells), dev, cli_dir)
        torch.cuda.empty_cache()
        paths["serve_render"], paths["serve_viewer"], paths["serve_viewer_cached"] = \
            serve_phase(cli_dir, dev, cli_final)
    finally:
        # Phase 22 trains on phase 14's dataset again: it stays until then.
        for sub in cli_dir.iterdir():
            if sub.name != "sphere":
                shutil.rmtree(sub, ignore_errors=True) if sub.is_dir() else sub.unlink()

    # The skip grid on a camera scene, then merged-MLP buckets.
    march_entry = next(k for k in kernels if k["name"] == "march")
    locate_entry, paths["skip_train"] = skip_phase(dev, march_entry, chase_ns[TRAIN_RAYS])
    kernels.append(locate_entry)
    torch.cuda.empty_cache()
    paths["merged_train"] = merged_phase(colors, mesh_plain, dev)
    torch.cuda.empty_cache()

    # Data shards over ranks, then the two stream levers, then the field
    # over model shards and the tracer.
    tmp = Path(tempfile.mkdtemp(prefix="shards_", dir=ROOT / "build"))
    try:
        shards, shard_ref = shard_phase(points, colors, cells, mesh_plain, dev, tmp,
                                        flagship_cold_ms)
        for label, run in shards.items():
            paths[f"shards_{label}"] = run["launches"]
        torch.cuda.empty_cache()
        lever_entries, lowp_paths, paths["budget_train"] = lever_phase(
            colors, mesh_plain, dev)
        paths.update(lowp_paths)
        torch.cuda.empty_cache()
        model_runs, model_width = model_shard_phase(
            mesh_plain, dev, tmp, shard_ref,
            one_rank_memory=shards[SHARD_RUNS[0][0]]["max_memory"][0])
        paths["model_shards"] = model_runs[MODEL_SHARD_RUNS[0][0]]["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    paths["tracer"], tracer_ms = tracer_phase(points, cells, dev)
    torch.cuda.empty_cache()

    # The serving API and the preprocessing CLI on phase 14's dataset, then
    # the live viewer over model shards.
    tmp = Path(tempfile.mkdtemp(prefix="api_", dir=ROOT / "build"))
    try:
        paths["api"] = api_phase(cli_dir / "sphere", dev, tmp)
        paths["viewer_shards"] = viewer_shard_phase(points, colors, cells, mesh_plain, dev,
                                                    tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(cli_dir, ignore_errors=True)

    # The fused MLPs' generic route: float32, and bf16 at other widths; then
    # the layered route: wider and deeper stacks.
    generic_entries, paths["generic_f32_train"], paths["generic_bf16_train"] = \
        generic_phase(colors, mesh_plain, dev)
    torch.cuda.empty_cache()
    layered_entries, paths["layered_wide_train"], paths["layered_deep_train"] = \
        layered_phase(colors, mesh_plain, dev)
    torch.cuda.empty_cache()

    chunks = REQUESTS * REQUEST_RAYS // CHUNK
    render_of = {"flagship_train": "flagship_render", "train_fused": "render_fused",
                 "skip_train": "flagship_render"}
    step_of = {"flagship_train": flagship_step, "train_fused": step_launches}
    for k in kernels:
        name = k["name"]
        # The train run of the configuration whose path runs the kernel: the
        # flagship (phase 12), else the fused-MLP run (phase 10), else the
        # skip grid's run (phase 16; K9 runs once per mesh, in no steady step).
        path = next((p for p in render_of if paths[p][name] > 0), "train_fused")
        k["launches"] = paths[path][name]
        k["launches_path"] = path
        k["launches_per_step"] = step_of.get(path, {}).get(name, 0)
        k["launches_per_chunk"] = paths[render_of[path]][name] / chunks
        k["launches_by_path"] = {path: counts[name] for path, counts in paths.items()}
        if name in flagship_ms:
            k["flagship_step_ms"] = flagship_ms[name]["ms"]
            k["flagship_step_bound_ms"] = flagship_ms[name]["bound_ms"]
        if name in model_width:
            k["model_shard_width"] = model_width[name]
        if name == "march":
            k["tracer_ms"] = {f: tracer_ms[f] for f in ("trace_rays", "trace_rays_triangles")}
        if name == "locate":
            k["tracer_ms"] = {"find_tetrahedra": tracer_ms["find_tetrahedra"]}
    for k in lever_entries:
        # Their own row type's flagship run (phase 19) is their main path.
        k["launches"] = paths[k["launches_path"]][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()}
    kernels += lever_entries
    for k in generic_entries:
        # The float32 preset's fused run (phase 24) is their main path.
        k["launches"] = paths["generic_f32_train"][k["name"]]
        k["launches_path"] = "generic_f32_train"
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()}
    kernels += generic_entries
    for k in layered_entries:
        # The 512-wide stack's bf16 run (phase 25) is their main path.
        k["launches"] = paths["layered_wide_train"][k["name"]]
        k["launches_path"] = "layered_wide_train"
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()}
    kernels += layered_entries
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
