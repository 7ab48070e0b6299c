"""Blender-synthetic preprocessing CLI.

Counterpart of :mod:`tetranerf_tpu.scripts.process_blender` (the
reference's ``python -m tetranerf.scripts.process_blender``): convert a
NeRF-synthetic scene (``transforms_train.json``) into a known-pose COLMAP
model, triangulate a sparse point cloud with ``colmap point_triangulator``,
and export ``sparse.ply`` for ``tetranerf-torch-triangulate``. Training
reads ``transforms_*.json`` itself; this script makes the point cloud. The
image size comes from the first frame's header (:func:`..utils.png.
image_size`), so no Pillow is needed.

Usage::

    tetranerf-torch-process-blender --data scene/ --output out/
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from ..utils import colmap as cm
from ..utils.png import image_size
from . import common


def blender_to_colmap(data_dir: Path, split: str = "train"):
    """transforms_{split}.json → COLMAP cameras/images (OpenCV w2c)."""
    with open(data_dir / f"transforms_{split}.json") as f:
        meta = json.load(f)
    frames = meta["frames"]
    first = frames[0]["file_path"]
    if not Path(first).suffix:
        first += ".png"
    w, h = image_size(data_dir / first)
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    cameras = {
        1: cm.Camera(
            1, "PINHOLE", w, h, np.array([focal, focal, w / 2.0, h / 2.0])
        )
    }
    images = {}
    for i, frame in enumerate(frames, start=1):
        c2w = np.asarray(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL -> OpenCV camera axes
        w2c = np.linalg.inv(c2w)
        name = frame["file_path"]
        if not Path(name).suffix:
            name += ".png"
        name = Path(name).name
        images[i] = cm.Image(
            i,
            cm.rotmat_to_qvec(w2c[:3, :3]),
            w2c[:3, 3],
            1,
            name,
            np.zeros((0, 2)),
            np.zeros((0,), np.int64),
        )
    return cameras, images


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tetranerf-torch-process-blender")
    parser.add_argument("--data", required=True,
                        help="scene dir with transforms_train.json")
    parser.add_argument("--output", required=True)
    parser.add_argument("--split", default="train")
    args = parser.parse_args(argv)

    data_dir = Path(args.data)
    output = Path(args.output)
    output.mkdir(parents=True, exist_ok=True)

    cameras, images = blender_to_colmap(data_dir, args.split)
    cm.write_model(cameras, images, {}, output / "known_poses", binary=False)
    print(
        f"wrote known-pose model: {len(images)} images", file=sys.stderr
    )
    images_dir = data_dir / args.split
    model = common.known_pose_triangulation(
        images_dir, output / "colmap", cameras, images
    )
    _, _, points = cm.read_model(model)
    common.export_points_ply(points, output / "sparse.ply")


def entrypoint():
    main()


if __name__ == "__main__":
    main()
