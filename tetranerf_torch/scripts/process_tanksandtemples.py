"""Tanks & Temples (NSVF split) preprocessing CLI.

Counterpart of :mod:`tetranerf_tpu.scripts.process_tanksandtemples` (the
reference's ``python -m tetranerf.scripts.process_tanksandtemples``): read
the NSVF layout (``intrinsics.txt``, per-image ``pose/*.txt`` 4x4
camera-to-world in OpenCV axes, ``rgb/`` images whose ``0_``/``1_`` name
prefixes mark the train/test split), export the minimal npz splits and,
with ``--run-colmap``, a known-pose COLMAP sparse point cloud. The image
size comes from the first image's header (:func:`..utils.png.image_size`).

Usage::

    tetranerf-torch-process-tanksandtemples --data scene/ --output out/ [--run-colmap]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..training.datasets import normalize_poses
from ..utils import colmap as cm
from ..utils.png import image_size
from . import common


def read_nsvf(data_dir: Path):
    """``(intrinsics {fx, fy, cx, cy}, [(image path, c2w [4, 4], split)])``
    of an NSVF scene directory, images in name order."""
    intr = np.loadtxt(data_dir / "intrinsics.txt")
    if intr.ndim == 2:  # 4x4 intrinsic matrix form
        fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    else:  # "fx cx cy ..." single-line form
        fx = fy = intr[0]
        cx, cy = intr[1], intr[2]
    rgb_dir = data_dir / "rgb"
    pose_dir = data_dir / "pose"
    entries = []
    for img_path in sorted(rgb_dir.iterdir()):
        stem = img_path.stem
        pose_path = pose_dir / f"{stem}.txt"
        if not pose_path.exists():
            continue
        c2w = np.loadtxt(pose_path).reshape(4, 4)
        split = "train" if stem.startswith("0_") else "test"
        entries.append((str(img_path), c2w, split))
    return {"fx": fx, "fy": fy, "cx": cx, "cy": cy}, entries


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tetranerf-torch-process-tanksandtemples")
    parser.add_argument("--data", required=True, help="NSVF scene dir")
    parser.add_argument("--output", required=True)
    parser.add_argument("--run-colmap", action="store_true",
                        help="triangulate a sparse cloud with known poses")
    args = parser.parse_args(argv)

    data_dir = Path(args.data)
    output = Path(args.output)
    output.mkdir(parents=True, exist_ok=True)

    intr, entries = read_nsvf(data_dir)
    if not entries:
        raise SystemExit(f"no pose/rgb pairs found in {data_dir}")
    w, h = image_size(entries[0][0])

    # NSVF poses are OpenCV camera-to-world; convert to OpenGL.
    names, c2ws, splits = [], [], []
    for path, c2w, split in entries:
        c2w = np.array(c2w, np.float64)
        c2w[:3, 1:3] *= -1
        names.append(path)
        c2ws.append(c2w)
        splits.append(split)
    poses, transform, scale = normalize_poses(np.stack(c2ws))

    # Explicit split export (prefix-based, not every-8th).
    dtype = np.float32
    cameras_common = {
        "fx": np.array(intr["fx"], dtype),
        "fy": np.array(intr["fy"], dtype),
        "cx": np.array(intr["cx"], dtype),
        "cy": np.array(intr["cy"], dtype),
        "width": np.array(w, np.int32),
        "height": np.array(h, np.int32),
        "camera_type": np.array(1, np.int32),
    }
    for split in ("train", "val", "test"):
        want = "train" if split == "train" else "test"
        idx = [i for i, s in enumerate(splits) if s == want]
        np.savez(
            output / f"{split}.npz",
            image_filenames=[names[i] for i in idx],
            cameras=np.array(
                dict(camera_to_worlds=poses[idx, :3, :4].astype(dtype),
                     **cameras_common)
            ),
            scene_box=np.array([[-1, -1, -1], [1, 1, 1]], dtype),
            applied_transform=transform,
            applied_scale=np.float64(scale),
        )
        print(f"split {split}: {len(idx)} images", file=sys.stderr)

    if args.run_colmap:
        cameras = {
            1: cm.Camera(
                1, "PINHOLE", w, h,
                np.array([intr["fx"], intr["fy"], intr["cx"], intr["cy"]]),
            )
        }
        images = {}
        for i, (path, c2w, _) in enumerate(entries, start=1):
            cv = np.array(c2w, np.float64)
            w2c = np.linalg.inv(cv)
            images[i] = cm.Image(
                i,
                cm.rotmat_to_qvec(w2c[:3, :3]),
                w2c[:3, 3],
                1,
                Path(path).name,
                np.zeros((0, 2)),
                np.zeros((0,), np.int64),
            )
        model = common.known_pose_triangulation(
            data_dir / "rgb", output / "colmap", cameras, images
        )
        _, _, points = cm.read_model(model)
        common.export_points_ply(points, output / "sparse.ply")


def entrypoint():
    main()


if __name__ == "__main__":
    main()
