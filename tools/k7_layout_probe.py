#!/usr/bin/env python3
"""Layout probe of K7, the field-gradient scatter (``csrc/scatter.cu``).

    python3 tools/k7_layout_probe.py [--baseline DIR] [--types NAME,...]

Run from the root of a checkout, on a GPU. Captures the jobs K7 gets in
step 2 of the flagship preset (``tetranerf_preset()``, 4096 rays, the
100K-point sphere of ``chip_smoke.py``) with the f32 stream, each with its
rays' ``num_valid``. For each row type the captured f32 rows are rounded
to it (``stream_dtypes.round_to``; float8_e8m0fnu's zero rows round to
NaN), and once more every row of float8_e8m0fnu NaN (as a flagship step
gives it: its loss is NaN); every variant of K7 runs on the same jobs:

- this checkout's ``scatter.cu`` on the jobs without their ``num_valid``
  (every slot read), with it (each ray's padding slots not read: header
  item 7), and on the jobs with those rows taken out beforehand (what
  skipping them could save at most);
- ``--baseline DIR``: another ``scatter.cu`` whose C entry point takes 3
  fields a job (the directory holds it and its ``common.cuh``), before
  and after the others, so that two builds compare inside one call.

Each variant is held to the twin (NaN where the twin's, the rest within
``chip_smoke.TOLERANCES["scatter_add_rows"]``) and timed by CUDA events
(median of 20 calls, the table's memset included) and by the profiler (the
sum of the call's device events). The last line is one JSON object with
every figure.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the scene, timing helpers and tolerances)

CAPTURE_STEP = 2
CSRC = ROOT / "tetranerf_torch" / "csrc"
BUILD = ROOT / "build" / "k7_layout_probe"


def _build_all(builds):
    """Each ``(name, source_dir, flags)``: that directory's ``scatter.cu``
    built alone into a library, all side by side; their
    ``tetranerf_scatter_add_rows_batch`` entry points by name, argtypes
    set. Prints the registers and spills of each kernel (``-Xptxas -v``)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source_dir, flags in builds:
        out = BUILD / f"lib{name}.so"
        procs[name] = (out, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I",
             str(source_dir), *flags, str(source_dir / "scatter.cu"), "-o", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-5000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                usage = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                                   if "Used" in x or "spill" in x)
                print(f"ptxas {name} {line.split()[-1][-60:]}: {usage}")
        fn = ctypes.CDLL(str(out)).tetranerf_scatter_add_rows_batch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call(variant, jobs, num_rows, code):
    """One launch of a variant ``(entry point, fields a job, num_valid
    read)`` on ``jobs`` (``(ids, rows, num_valid)``)."""
    import torch

    fn, fields, stream = variant
    flat = []
    for idx, vals, nv in jobs:
        flat += [idx.data_ptr(), vals.data_ptr(), idx.shape[0]]
        if fields == 5:
            flat += [nv.data_ptr(), idx.shape[0] // nv.shape[0]] if stream else [0, 0]
    arr = (ctypes.c_longlong * len(flat))(*flat)
    out = torch.empty((num_rows, jobs[0][1].shape[1]), dtype=torch.float32, device="cuda")
    rc = fn(arr, len(jobs), out.data_ptr(), num_rows, out.shape[1], 1, code,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"probe launch failed: CUDA error {rc}")
    return out


def _capture(colors, mesh_plain, dev, batches):
    """K7's jobs in step CAPTURE_STEP of the f32 preset: ``(ids, rows,
    num_valid)``."""
    import torch
    from tetranerf_torch.models import TetraNerf, tetranerf_preset
    from tetranerf_torch.ops import interp
    from tetranerf_torch.training.trainer import TrainConfig, Trainer

    model = TetraNerf(tetranerf_preset(), mesh_plain.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(TrainConfig(), model, mesh_plain, device=dev)
    seen = []
    real = interp.scatter_add_rows_batch

    def spy(jobs, num_rows, row_type=None):
        seen.append(([tuple(x.clone() for x in job) for job in jobs], num_rows))
        return real(jobs, num_rows, row_type)

    interp.scatter_add_rows_batch = spy
    try:
        for step in range(CAPTURE_STEP + 1):
            seen.clear()
            trainer.train_step(batches[step % len(batches)])
    finally:
        interp.scatter_add_rows_batch = real
    return seen[-1]


def _checked(variant, jobs, num_rows, t):
    from tetranerf_torch.ops import scatter

    got = _call(variant, jobs, num_rows, t.code)
    want = scatter.scatter_add_rows_batch_twin([j[:2] for j in jobs], num_rows, t)
    err = chip_smoke._nan_aware_err(got, want, f"k7 probe ({t.name})")
    chip_smoke._check(err <= chip_smoke.TOLERANCES["scatter_add_rows"],
                      f"k7 probe ({t.name}): max abs err {err}")
    return err


def _timed(variant, jobs, num_rows, t):
    def call():
        return _call(variant, jobs, num_rows, t.code)

    return dict(ms=chip_smoke._time_ms(call, 20), device_ms=chip_smoke._device_ms(call))


def main(argv=None):
    import torch
    from tetranerf_torch.geometry import build_mesh, triangulate
    from tetranerf_torch.ops.scatter import used_rows
    from tetranerf_torch.ops.stream_dtypes import STREAM_TYPES, round_to
    from tetranerf_torch.utils.synthetic import make_sphere_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--types", default="", help="a comma-separated subset of the cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_layout_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    builds = [("k7", CSRC, [])]
    if args.baseline is not None:
        builds.append(("k7_baseline", args.baseline.resolve(), []))
    fns = _build_all(builds)
    variants = {"every_slot": (fns["k7"], 5, False), "num_valid": (fns["k7"], 5, True)}
    if args.baseline is not None:
        base = (fns["k7_baseline"], 3, False)
        variants = {"baseline": base, **variants, "baseline_again": base}
    print(f"build: {time.perf_counter() - t0:.1f} s")
    points, colors = make_sphere_scene(chip_smoke.NUM_POINTS, seed=0)
    mesh_plain = build_mesh(points, triangulate(points), device="cpu")
    rng = np.random.default_rng(1)
    batches = [chip_smoke._train_batch(rng, chip_smoke.TRAIN_RAYS)
               for _ in range(chip_smoke.TRAIN_BATCHES)]
    jobs_f32, num_rows = _capture(colors, mesh_plain, dev, batches)
    chip_smoke._check(all(len(job) == 3 for job in jobs_f32), "k7 probe: jobs without num_valid")
    kept = [used_rows(job) for job in jobs_f32]
    rows = sum(j[0].numel() for j in jobs_f32)
    kept_rows = sum(i.numel() for i, _ in kept)
    print(f"jobs: {len(jobs_f32)}, rows {rows}, padding rows {rows - kept_rows}, "
          f"(rays, slots) {[(nv.shape[0], i.shape[0] // nv.shape[0]) for i, _, nv in jobs_f32]}")
    result = dict(device=smi, rows=rows, padding_rows=rows - kept_rows, types={})
    cases = [(name, t, None) for name, t in STREAM_TYPES.items()]
    # float8_e8m0fnu as a flagship step gives it: every row NaN (0xFF).
    cases.append(("float8_e8m0fnu_all_nan", STREAM_TYPES["float8_e8m0fnu"], 0xFF))
    if args.types:
        cases = [case for case in cases if case[0] in args.types.split(",")]
    for name, t, fill in cases:
        def rows(v):
            return (round_to(v, t) if fill is None
                    else torch.full(v.shape, fill, dtype=torch.uint8, device=v.device))

        jobs = [(i, rows(v).contiguous(), nv) for i, v, nv in jobs_f32]
        unpadded = [(i, rows(v).contiguous(), i[:1]) for i, v in kept]
        bound = chip_smoke._scatter_batch_bound([j[:2] for j in jobs], num_rows)["bound_ms"]
        entry = dict(bound_ms=bound, variants={})
        for label, variant in variants.items():
            entry["variants"][label] = dict(max_abs_err=_checked(variant, jobs, num_rows, t),
                                            **_timed(variant, jobs, num_rows, t))
        no_stream = variants["every_slot"]
        entry["unpadded"] = dict(max_abs_err=_checked(no_stream, unpadded, num_rows, t),
                                 bound_ms=chip_smoke._scatter_batch_bound(
                                     [j[:2] for j in unpadded], num_rows)["bound_ms"],
                                 **_timed(no_stream, unpadded, num_rows, t))
        result["types"][name] = entry
        print(f"{name}: bound {bound:.4f} ms; " + "; ".join(
            f"{label} {v['ms']:.4f} / {v['device_ms']}" for label, v in entry["variants"].items())
              + f"; unpadded {entry['unpadded']['ms']:.4f} / {entry['unpadded']['device_ms']}"
              f" (bound {entry['unpadded']['bound_ms']:.4f})")
        del jobs, unpadded
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
