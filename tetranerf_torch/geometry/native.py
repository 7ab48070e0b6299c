"""The native host geometry library (``csrc/tetra_geom.cpp``): the face
adjacency of a tetrahedral mesh and the grid k-NN average point spacing.

Counterpart of :mod:`tetranerf_tpu.geometry.native`, over the port's own
copy of the C++ source. At first use ``g++ -O3 -std=c++17 -fPIC -shared``
builds it into ``build/tetranerf_torch/`` at the root of the checkout, under
a name that carries a hash of the source and flags (as ``ops/cuda.py`` names
the kernel library), and ``ctypes`` loads it. A compiler that fails raises
with its output. :func:`..mesh.build_adjacency` and
:func:`..delaunay.find_average_spacing` take the library where
:func:`available` says so, else the numpy face-key sort and the KD-tree
(which stay callable as :func:`..mesh.build_adjacency_numpy` and
:func:`..delaunay.average_spacing_kdtree`).
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

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tetra_geom.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tetranerf_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lock = threading.Lock()


def _compiler():
    return shutil.which("g++")


def library_path() -> Path:
    digest = hashlib.sha256(repr(FLAGS).encode() + _SOURCE.read_bytes())
    return BUILD_DIR / f"libtetra_geom_{digest.hexdigest()[:16]}.so"


def available() -> bool:
    """True where the library is built or ``g++`` is on ``PATH``."""
    return _lib is not None or library_path().exists() or _compiler() is not None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; idempotent."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            cxx = _compiler()
            if cxx is None:
                raise RuntimeError("g++ not found: the native geometry library cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                staged = Path(tmp) / so.name
                cmd = [cxx, *FLAGS, str(_SOURCE), "-o", str(staged)]
                proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                       f"{proc.stdout}")
                os.replace(staged, so)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(so))
        lib.tetra_build_adjacency.restype = ctypes.c_int
        lib.tetra_build_adjacency.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.tetra_average_spacing.restype = ctypes.c_double
        lib.tetra_average_spacing.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        _lib = lib
        return lib


def build_adjacency(cells: np.ndarray) -> np.ndarray:
    """``neighbors int32[C, 4]``: the cell across the face opposite vertex
    k, -1 on the boundary. Raises ``ValueError`` if a face is shared by
    more than two cells or a vertex id is negative."""
    lib = load()
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    out = np.empty((cells.shape[0], 4), dtype=np.int32)
    rc = lib.tetra_build_adjacency(cells.ctypes.data, cells.shape[0], out.ctypes.data)
    if rc == 1:
        raise ValueError("a triangle face is shared by more than 2 tetrahedra")
    if rc:
        raise ValueError("cells hold a negative vertex id")
    return out


def average_spacing(points: np.ndarray, num_neighbors: int = 6) -> float:
    """Mean distance from each point to its ``num_neighbors`` nearest other
    points, averaged over the points (f32 coordinates)."""
    lib = load()
    points = np.ascontiguousarray(points, dtype=np.float32)
    return float(lib.tetra_average_spacing(points.ctypes.data, points.shape[0],
                                           num_neighbors))
