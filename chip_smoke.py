#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tetranerf_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card's ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build of the CUDA kernels K1-K3 from ``tetranerf_torch/csrc`` (nvcc);
3. each kernel against its plain PyTorch twin on the card, at the render
   slice's shapes on the 100K-point sphere scene (8192 rays, T=512 march
   slots, S=257 fine samples): max abs error against the stated tolerance,
   median CUDA-event times of both;
4. K1 on ``tests/assets/golden_march.npz`` (exact cells, t within 1e-5);
5. the end-to-end render of the ``tetra-nerf`` preset (``ray_buckets=1``,
   seeded random weights with point colours, a synthetic occupancy column):
   4 requests of 65,536 rays through ``Renderer.render_rays`` at chunk 8192,
   with the kernels' launch counts, and the outputs checked: finite, rgb in
   [0, 1], and equal within tolerance to the same render on the CPU, where
   every kernel runs as its twin.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import copy
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
TOLERANCES = {"march": 1e-5, "stream_blend_gather": 1e-5, "sample_interp": 1e-5}
# bf16 MLP GEMMs round differently in cuBLAS and on the CPU.
RENDER_RGB_TOL = 2e-2


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


def synthetic_occupancy(mesh_cpu):
    """Density 200 in cells whose centroid lies outside radius 0.9 (the
    scene's surface shell), 0 inside: a ray entering the shell passes the
    depth cap -log(1e-4) within about 0.05 of travel and stops."""
    import torch

    centroids = mesh_cpu.vertices[mesh_cpu.cells.long()].mean(dim=1)
    return torch.where(centroids.norm(dim=1) > 0.9, 200.0, 0.0)


def kernel_checks(mesh, field, origins, directions):
    """Phase 3: each kernel against its twin on the card."""
    import torch
    from tetranerf_torch.ops import fused, interp
    from tetranerf_torch.ops.march import (
        march, march_intervals, march_intervals_twin,
    )
    from tetranerf_torch.ops.traversal import hull_intersect

    results = []
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
    results.append(dict(
        name="march", route="cuda", source="tetranerf_torch/csrc/march.cu",
        replaces="tetranerf_tpu/ops/fused.py:125", max_abs_err=err,
        ms=_time_ms(lambda: march_intervals(*args), 10),
        plain_ms=_time_ms(lambda: march_intervals_twin(*args), 3),
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
    results.append(dict(
        name="stream_blend_gather", route="cuda",
        source="tetranerf_torch/csrc/blend.cu",
        replaces="tetranerf_tpu/ops/pallas_interp.py:214", max_abs_err=err,
        ms=_time_ms(lambda: interp.stream_blend_gather(*blend_args), 10),
        plain_ms=_time_ms(lambda: interp.stream_blend_gather_twin(*blend_args), 3),
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
    results.append(dict(
        name="sample_interp", route="cuda", source="tetranerf_torch/csrc/interp.cu",
        replaces="tetranerf_tpu/ops/pallas_interp.py:104", max_abs_err=err,
        ms=_time_ms(lambda: interp.sample_interp(*interp_args), 10),
        plain_ms=_time_ms(lambda: interp.sample_interp_twin(*interp_args), 3),
    ))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import cuda
    from tetranerf_torch.render import Renderer
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
    mesh_cpu = build_mesh(points)
    mesh_cpu = mesh_cpu.with_occupancy(synthetic_occupancy(mesh_cpu))
    mesh = mesh_cpu.to(dev)
    print(f"scene: {NUM_POINTS} points, {mesh.num_cells} cells, "
          f"{len(mesh.hull_eqs)} hull facets, built in "
          f"{time.perf_counter() - t:.1f} s")

    cfg = tetranerf_preset(ray_buckets=1)
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0))

    with torch.inference_mode():
        o, d = sample_sphere_rays(np.random.default_rng(0), CHUNK)
        kernels = kernel_checks(
            mesh, model.tetrahedra_field.detach().to(dev),
            torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
        )
        golden_check(dev)

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
    print(f"render: {REQUESTS} x {REQUEST_RAYS} rays in {seconds:.3f} s = "
          f"{REQUESTS * REQUEST_RAYS / seconds:.0f} rays/s; "
          f"overflow {int(out['traversal_overflow'].sum())}, "
          f"hit {int(out['ray_mask'].sum())}, launches {launches}")
    _check(all(launches[k["name"]] > 0 for k in kernels),
           f"a kernel of the path did not launch: {launches}")
    for k in ("rgb", "depth", "accumulation"):
        _check(np.isfinite(out[k]).all(), f"render: non-finite {k}")
    _check(out["rgb"].shape == (REQUESTS * REQUEST_RAYS, 3), "render: rgb shape")
    _check(out["rgb"].min() >= 0.0 and out["rgb"].max() <= 1.0, "render: rgb range")

    # The same rays through the CPU twins.
    n_ref = 256
    ref = Renderer(model_cpu, mesh_cpu, "cpu").render_rays(
        origins[:n_ref], directions[:n_ref], chunk=n_ref
    )
    _check(np.array_equal(ref["ray_mask"], out["ray_mask"][:n_ref]), "ref: ray_mask")
    _check(np.array_equal(ref["traversal_overflow"],
                          out["traversal_overflow"][:n_ref]), "ref: overflow")
    rgb_err = float(np.abs(ref["rgb"] - out["rgb"][:n_ref]).max())
    _check(rgb_err <= RENDER_RGB_TOL, f"ref: rgb max abs err {rgb_err}")
    print(f"render vs CPU twins ({n_ref} rays): rgb max abs err {rgb_err:.3g}")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
