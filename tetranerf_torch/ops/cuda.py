"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links
them into one shared library with a plain C interface under
``build/tetranerf_torch/`` at the root of the checkout; ``ctypes`` loads it.
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and never mixed with a stale build.

Flags: no ``--use_fast_math`` anywhere (the march table bit-casts ids into
float columns as denormals, and flush-to-zero would erase them), and
``--fmad=false`` for ``march.cu`` so the march's distances round exactly as
its PyTorch twin's separate multiply and add do.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises on anything but 0 and counts the launch in
:data:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tetranerf_torch"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_SOURCES = {
    "march.cu": ["--fmad=false"],
    "blend.cu": [],
    "interp.cu": [],
    "scatter.cu": [],
    "mlp.cu": [],
    "gather.cu": [],
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each C entry point (the trailing pointer is the CUDA stream).
_SIGNATURES = {
    "tetranerf_march": [_P] * 8 + [_I] * 5 + [_F] + [_P, _P, _I] + [_P] * 11 + [_P],
    "tetranerf_locate": [_P] * 3 + [_I] * 2 + [_P] + [_P],
    "tetranerf_stream_blend_gather_batch": [_P, _P, _I, _I, _P],
    "tetranerf_stream_blend_max_jobs": [],
    "tetranerf_sample_interp": [_P] * 8 + [_I] * 4 + [_P],
    "tetranerf_stream_blend_backward": [_P] * 4 + [_I] * 4 + [_P],
    "tetranerf_sample_interp_backward": [_P] * 7 + [_I] * 4 + [_P],
    "tetranerf_scatter_add_rows_batch": [_P, _I, _P, _I, _I, _I, _P],
    "tetranerf_scatter_add_max_jobs": [],
    "tetranerf_fused_mlp_forward": [_P] * 6 + [_I] * 9 + [_P],
    "tetranerf_fused_mlp_backward": [_P] * 11 + [_I] * 10 + [_P],
    "tetranerf_row_gather_batch": [_P, _I, _P],
    "tetranerf_row_gather_max_jobs": [],
}

launch_counts = {
    "march": 0, "locate": 0, "stream_blend_gather": 0, "sample_interp": 0,
    "stream_blend_backward": 0, "sample_interp_backward": 0,
    "scatter_add_rows": 0, "fused_field_mlps": 0, "fused_field_mlps_backward": 0,
    "fused_density_mlp": 0, "fused_density_mlp_backward": 0, "row_gather": 0,
}
"""Kernel launches per wrapper since the last :func:`reset_launch_counts`."""

build_log = ""
"""nvcc's output (``-Xptxas -v``: registers, spills) of the last build."""

_lib = None
_fns = {}  # C entry point name -> its ctypes function, argtypes set
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(cmds) -> str:
    """Run the commands side by side; raise if any fails."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    logs, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(
                f"nvcc failed ({proc.returncode}): "
                f"{' '.join(map(str, cmd))}\n{out}"
            )
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def library_path() -> Path:
    digest = hashlib.sha256(repr((_COMMON, _SOURCES)).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libtetranerf_kernels_{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                objs = [Path(tmp) / (name + ".o") for name in _SOURCES]
                log = _run([
                    [nvcc, *_COMMON, *extra, "-c", _CSRC / name, "-o", obj]
                    for (name, extra), obj in zip(_SOURCES.items(), objs)
                ])
                staged = Path(tmp) / so.name
                log += _run([[nvcc, *_ARCH, "-shared", *objs, "-o", staged]])
                os.replace(staged, so)  # atomic: a concurrent loader sees all or nothing
            build_log = log
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _fns[fn] = f
        lib.tetranerf_error_string.argtypes = [ctypes.c_int]
        lib.tetranerf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptr(t: torch.Tensor) -> int:
    """A tensor's device address, as the ``c_void_p`` arguments take it."""
    return t.data_ptr()


def entry(fn: str):
    """C entry point ``fn`` of the kernel library (built and loaded at
    first use), its ``argtypes`` set."""
    if _lib is None:
        load()
    return _fns[fn]


def launch(counter: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` on ``device``'s current stream; raise on a
    CUDA error, count the launch under ``counter`` otherwise. The entry
    point is looked up once; a call costs the stream handle and the call."""
    f = _fns.get(fn) or entry(fn)
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):  # the runtime launches on the current device
            rc = f(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        rc = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = _lib.tetranerf_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} ({msg})")
    launch_counts[counter] += 1


@functools.cache
def max_jobs(query: str) -> int:
    """Jobs one launch of a batched kernel takes (its parameter space holds
    the job list), from the C entry point ``query``."""
    return entry(query)()


def job_chunks(cap: int, jobs):
    """``jobs`` (equal-length tuples of ints) cut into runs of at most
    ``cap`` (what one launch takes), each as ``(ctypes int64 array, job
    count)`` for a batched C entry point."""
    for start in range(0, len(jobs), cap):
        part = [v for job in jobs[start:start + cap] for v in job]
        yield (ctypes.c_longlong * len(part))(*part), len(jobs[start:start + cap])


def check_cuda_inputs(name: str, **tensors) -> None:
    """Refuse what the kernels do not take: non-CUDA, non-contiguous or
    mixed-device tensors."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices: {devices}")
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
