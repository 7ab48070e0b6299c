"""Minimal PLY point-cloud reader/writer (ascii + binary little/big endian).

The reference loads point clouds through ``trimesh``
(``tetranerf/scripts/triangulate.py:19-25``); this is a self-contained
numpy implementation covering the vertex element (positions + optional
uint8 colors), which is all the pipeline needs. The port's copy of
:mod:`tetranerf_tpu.geometry.ply`.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

_PLY_TO_NUMPY = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def read_ply(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PLY file; returns ``(positions f64[N,3], colors u8[N,3] | None)``."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.index(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype_str or ('list', ct, t))])
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1]))
    if fmt is None:
        raise ValueError(f"{path}: missing PLY format line")

    vertex_el = next((e for e in elements if e[0] == "vertex"), None)
    if vertex_el is None:
        raise ValueError(f"{path}: no vertex element")
    if elements and elements[0][0] != "vertex":
        raise ValueError(f"{path}: vertex must be the first element to read positions")
    _, count, props = vertex_el
    if any(isinstance(t, tuple) for _, t in props):
        raise ValueError(f"{path}: list properties on vertex element unsupported")

    if fmt == "ascii":
        text = body.decode("ascii")
        rows = []
        for line in text.splitlines():
            if line.strip():
                rows.append([float(x) for x in line.split()[: len(props)]])
            if len(rows) == count:
                break
        arr = np.asarray(rows, dtype=np.float64)
        table = {name: arr[:, i] for i, (name, _) in enumerate(props)}
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(name, endian + _PLY_TO_NUMPY[t]) for name, t in props])
        arr = np.frombuffer(body, dtype=dtype, count=count)
        table = {name: arr[name] for name, _ in props}

    positions = np.stack(
        [table["x"], table["y"], table["z"]], axis=-1
    ).astype(np.float64)
    colors = None
    if all(k in table for k in ("red", "green", "blue")):
        colors = np.stack(
            [table["red"], table["green"], table["blue"]], axis=-1
        )
        if colors.dtype != np.uint8:
            if colors.max() <= 1.0:
                colors = colors * 255.0
            colors = np.clip(colors, 0, 255).astype(np.uint8)
    return positions, colors


def write_ply(path, positions: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Write a binary little-endian PLY point cloud."""
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    n = len(positions)
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        colors = np.ascontiguousarray(colors, dtype=np.uint8)
        props += [("red", "<u1"), ("green", "<u1"), ("blue", "<u1")]
    arr = np.empty(n, dtype=np.dtype(props))
    arr["x"], arr["y"], arr["z"] = positions[:, 0], positions[:, 1], positions[:, 2]
    if colors is not None:
        arr["red"], arr["green"], arr["blue"] = (
            colors[:, 0],
            colors[:, 1],
            colors[:, 2],
        )
    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n".encode())
    for name, t in props:
        kind = {"<f4": "float", "<u1": "uchar"}[t]
        header.write(f"property {kind} {name}\n".encode())
    header.write(b"end_header\n")
    with open(path, "wb") as f:
        f.write(header.getvalue())
        f.write(arr.tobytes())
