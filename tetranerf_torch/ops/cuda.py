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
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each C entry point (the trailing pointer is the CUDA stream).
_SIGNATURES = {
    "tetranerf_march": [_P] * 8 + [_I] * 5 + [_F] + [_P] * 11 + [_P],
    "tetranerf_stream_blend_gather": [_P] * 5 + [_I] * 4 + [_P],
    "tetranerf_sample_interp": [_P] * 8 + [_I] * 4 + [_P],
    "tetranerf_stream_blend_backward": [_P] * 4 + [_I] * 4 + [_P],
    "tetranerf_sample_interp_backward": [_P] * 7 + [_I] * 4 + [_P],
    "tetranerf_scatter_add_rows": [_P] * 3 + [_I] * 3 + [_P],
    "tetranerf_fused_mlp_forward": [_P] * 6 + [_I] * 7 + [_P],
    "tetranerf_fused_mlp_backward": [_P] * 10 + [_I] * 8 + [_P],
}

launch_counts = {
    "march": 0, "stream_blend_gather": 0, "sample_interp": 0,
    "stream_blend_backward": 0, "sample_interp_backward": 0,
    "scatter_add_rows": 0, "fused_field_mlps": 0, "fused_field_mlps_backward": 0,
    "fused_density_mlp": 0, "fused_density_mlp_backward": 0,
}
"""Kernel launches per wrapper since the last :func:`reset_launch_counts`."""

build_log = ""
"""nvcc's output (``-Xptxas -v``: registers, spills) of the last build."""

_lib = None
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
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tetranerf_error_string.argtypes = [ctypes.c_int]
        lib.tetranerf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def launch(counter: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` on ``device``'s current stream; raise on a
    CUDA error, count the launch under ``counter`` otherwise."""
    lib = load()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.tetranerf_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} ({msg})")
    launch_counts[counter] += 1


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
