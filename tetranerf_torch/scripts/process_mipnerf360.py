"""Mip-NeRF 360 preprocessing CLI.

Counterpart of :mod:`tetranerf_tpu.scripts.process_mipnerf360` (the
reference's ``python -m tetranerf.scripts.process_mipnerf360``): the scenes
ship with a COLMAP model; convert it to the minimal ``{train,val,test}.npz``
splits (every 8th image held out) and export ``sparse.ply``; ``--dense``
also runs COLMAP's dense stereo.

Usage::

    tetranerf-torch-process-mipnerf360 --data garden/ --output out/ [--downscale 4]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..training.datasets import normalize_poses
from ..utils import colmap as cm
from . import common


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tetranerf-torch-process-mipnerf360")
    parser.add_argument("--data", required=True,
                        help="scene dir (images/ + sparse/0 COLMAP model)")
    parser.add_argument("--output", required=True)
    parser.add_argument("--downscale", type=int, default=4,
                        help="use images_{downscale}/ when present")
    parser.add_argument("--dense", action="store_true")
    parser.add_argument("--eval-interval", type=int, default=8)
    args = parser.parse_args(argv)

    data_dir = Path(args.data)
    output = Path(args.output)
    output.mkdir(parents=True, exist_ok=True)

    model_dir = data_dir / "sparse" / "0"
    if not model_dir.exists():
        model_dir = data_dir / "sparse"
    cameras, images_meta, points = cm.read_model(model_dir)

    images_dir = data_dir / "images"
    downscale = 1
    if args.downscale > 1 and (data_dir / f"images_{args.downscale}").exists():
        images_dir = data_dir / f"images_{args.downscale}"
        downscale = args.downscale

    ordered = sorted(images_meta.values(), key=lambda im: im.name)
    c2ws, names = [], []
    for im in ordered:
        c2w = im.camera_to_world()
        c2w[:3, 1:3] *= -1
        c2ws.append(c2w)
        names.append(str(images_dir / im.name))
    poses, transform, scale = normalize_poses(np.stack(c2ws))

    cam = cameras[ordered[0].camera_id]
    intr = {
        k: v / downscale
        for k, v in cm.camera_intrinsics(cam).items()
        if k in ("fx", "fy", "cx", "cy")
    }
    common.export_minimal_npz(
        output,
        names,
        poses[:, :3, :4],
        intr,
        cam.width // downscale,
        cam.height // downscale,
        eval_interval=args.eval_interval,
        applied_transform=transform,
        applied_scale=scale,
    )
    common.export_points_ply(points, output / "sparse.ply")
    if args.dense:
        fused = common.colmap_dense(
            data_dir / "images", model_dir, output / "dense"
        )
        print(f"dense cloud at {fused}", file=sys.stderr)


def entrypoint():
    main()


if __name__ == "__main__":
    main()
