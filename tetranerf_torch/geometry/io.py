"""Tetrahedra file IO.

The reference serializes tetrahedralizations with ``torch.save`` as
``{cells: int32[C,4], vertices: float32[V,3], colors: uint8[V,4]}``
(``tetranerf/scripts/triangulate.py:68-76``, consumed at
``tetranerf/nerfstudio/model.py:353-386``). We keep that contract: ``.th``
files are read/written via torch when available, and an equivalent ``.npz``
container is supported everywhere (keys ``cells``/``vertices``/``colors``).
The port's copy of :mod:`tetranerf_tpu.geometry.io`; ``.th`` files are read
with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def save_tetrahedra(
    path,
    *,
    vertices: np.ndarray,
    cells: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> None:
    path = str(path)
    vertices = np.ascontiguousarray(vertices, dtype=np.float32)
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    if colors is not None:
        colors = np.ascontiguousarray(colors, dtype=np.uint8)
        if colors.shape[1] == 3:  # reference stores RGBA (alpha=255)
            colors = np.concatenate(
                [colors, np.full_like(colors[:, :1], 255)], axis=1
            )
    if path.endswith(".npz"):
        data = {"vertices": vertices, "cells": cells}
        if colors is not None:
            data["colors"] = colors
        np.savez_compressed(path, **data)
    else:
        import torch

        data = {
            "cells": torch.from_numpy(cells),
            "vertices": torch.from_numpy(vertices),
        }
        if colors is not None:
            data["colors"] = torch.from_numpy(colors)
        torch.save(data, path)


def load_tetrahedra(path) -> Dict[str, np.ndarray]:
    """Load a tetrahedra file -> dict with vertices/cells (+ colors)."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            out = {k: np.asarray(data[k]) for k in data.files}
    else:
        import torch

        raw = torch.load(path, map_location="cpu", weights_only=True)
        out = {k: v.numpy() for k, v in raw.items()}
    out["vertices"] = np.ascontiguousarray(out["vertices"], dtype=np.float32)
    out["cells"] = np.ascontiguousarray(out["cells"], dtype=np.int32)
    if "colors" in out:
        out["colors"] = np.ascontiguousarray(out["colors"], dtype=np.uint8)
    return out
