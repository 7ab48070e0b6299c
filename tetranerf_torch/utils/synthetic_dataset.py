"""Write a Blender-format multi-view dataset of an analytic scene.

    python -m tetranerf_torch.utils.synthetic_dataset --out <dir> \
        [--side 256] [--train 40] [--test 8] [--points 100000] \
        [--scene {sphere,hard}]

``transforms_{train,test}.json``, PNG images rendered from the analytic
ground truth (:func:`.synthetic.sphere_ray_targets`, or with ``--scene
hard`` :func:`.synthetic.hard_ray_targets`: textured spheres, a thin
occluding plate and view-dependent shading) and ``tetra.npz`` from the
matching point cloud (:func:`.synthetic.make_sphere_scene` /
:func:`.synthetic.make_hard_scene`): a self-contained scene for training
from disk with ``tetranerf_torch.training.cli``. The port's copy of
``benchmarks/make_synthetic_dataset.py``, with the same arguments and
defaults, writing through :mod:`.png` (no Pillow).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from .png import write_png
from .synthetic import (
    hard_ray_targets,
    make_hard_scene,
    make_sphere_scene,
    sphere_ray_targets,
)

CAMERA_ANGLE_X = 0.8
SCENES = {
    "sphere": (make_sphere_scene, sphere_ray_targets),
    "hard": (make_hard_scene, hard_ray_targets),
}


def look_at(pos: np.ndarray) -> np.ndarray:
    """Camera-to-world ``[4, 4]`` (OpenGL axes) at ``pos`` facing the origin."""
    forward = -pos / np.linalg.norm(pos)
    upw = np.array([0.0, 0.0, 1.0])
    if abs(forward @ upw) > 0.98:
        upw = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, upw)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, pos
    return c2w


def camera_rays(c2w: np.ndarray, side: int, camera_angle_x: float):
    """Pixel-centre rays ``[side * side, 3]`` of a square pinhole camera."""
    focal = 0.5 * side / np.tan(0.5 * camera_angle_x)
    j, i = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    dirs = np.stack([(i - side / 2 + 0.5) / focal, -(j - side / 2 + 0.5) / focal,
                     -np.ones_like(i, np.float64)], axis=-1)
    d = dirs @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def write_sphere_dataset(out, side: int = 256, train: int = 40, test: int = 8,
                         points: int = 100_000, radius: float = 2.5,
                         scene: Optional[tuple] = None, kind: str = "sphere") -> dict:
    """Write the dataset of scene ``kind`` (a key of :data:`SCENES`) into
    ``out``. ``scene`` = ``(points, colors, cells)`` reuses a triangulated
    ``make_*_scene(points, seed=0)`` of that kind. Returns ``{"points",
    "cells"}`` counts."""
    from ..geometry import save_tetrahedra, triangulate

    make_scene, ray_targets = SCENES[kind]
    os.makedirs(out, exist_ok=True)

    def make_split(split, count, offset):
        frames = []
        for k in range(count):
            # Fibonacci-ish shell placement, jittered per split.
            z = 1 - 2 * (k + 0.5) / count
            phi = (k + offset) * 2.399963 + offset
            r = np.sqrt(max(1 - z * z, 1e-6))
            pos = radius * np.array([r * np.cos(phi), r * np.sin(phi), z * 0.8])
            c2w = look_at(pos)
            o, d = camera_rays(c2w, side, CAMERA_ANGLE_X)
            rgb = ray_targets(o, d).reshape(side, side, 3)
            name = f"{split}_{k:03d}"
            write_png(os.path.join(out, f"{name}.png"),
                      (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": f"./{name}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)

    make_split("train", train, 0.0)
    make_split("test", test, 0.37)

    if scene is None:
        pts, colors = make_scene(points, seed=0)
        cells = triangulate(pts)
    else:
        pts, colors, cells = scene
    save_tetrahedra(os.path.join(out, "tetra.npz"), vertices=pts, cells=cells,
                    colors=colors)
    return {"points": len(pts), "cells": len(cells)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--side", type=int, default=256)
    p.add_argument("--train", type=int, default=40)
    p.add_argument("--test", type=int, default=8)
    p.add_argument("--points", type=int, default=100_000)
    p.add_argument("--radius", type=float, default=2.5)
    p.add_argument("--scene", default="sphere", choices=list(SCENES),
                   help="'hard' = textured spheres + thin occluder + view-dependent "
                   "shading")
    args = p.parse_args(argv)
    n = write_sphere_dataset(args.out, args.side, args.train, args.test, args.points,
                             args.radius, kind=args.scene)
    print(f"dataset at {args.out}: {args.train} train / {args.test} test @ "
          f"{args.side}^2, {n['points']} points / {n['cells']} cells")


if __name__ == "__main__":
    main()
