"""COLMAP-from-images preprocessing CLI.

Counterpart of :mod:`tetranerf_tpu.scripts.process_images` (the
reference's ``python -m tetranerf.scripts.process_images``): run COLMAP's
SfM on a directory of images (or a video's frames, extracted by ffmpeg),
normalize the poses, export the minimal ``{train,val,test}.npz`` splits
(every 8th image held out) and ``sparse.ply`` (optionally dense), ready for
``tetranerf-torch-triangulate``.

Usage::

    tetranerf-torch-process-images --images photos/ --output out/ [--dense]
    tetranerf-torch-process-images --video clip.mp4 --fps 2 --output out/
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
    parser = argparse.ArgumentParser(prog="tetranerf-torch-process-images")
    parser.add_argument("--images", default=None, help="input image dir")
    parser.add_argument("--video", default=None,
                        help="input video (frames extracted with ffmpeg)")
    parser.add_argument("--fps", type=float, default=None,
                        help="frame extraction rate for --video")
    parser.add_argument("--downscale", type=int, default=1)
    parser.add_argument("--output", required=True)
    parser.add_argument("--dense", action="store_true",
                        help="also build a dense point cloud (slow)")
    parser.add_argument("--eval-interval", type=int, default=8)
    parser.add_argument(
        "--train-pointcloud", action="store_true",
        help="also triangulate a point cloud from TRAIN images only, so "
             "eval views contribute no geometry (reference "
             "process_images.py:239-276)",
    )
    args = parser.parse_args(argv)

    if (args.images is None) == (args.video is None):
        raise SystemExit("pass exactly one of --images / --video")
    output = Path(args.output)
    output.mkdir(parents=True, exist_ok=True)
    if args.video is not None:
        images_dir = common.extract_video_frames(
            Path(args.video), output / "frames", args.fps
        )
    else:
        images_dir = Path(args.images)
    if args.downscale > 1:
        images_dir = common.downscale_images(
            images_dir, output / f"images_{args.downscale}", args.downscale
        )

    sparse_model = common.colmap_sfm(
        images_dir, output / "colmap", dense=args.dense
    )
    cameras, images_meta, points = cm.read_model(sparse_model)

    ordered = sorted(images_meta.values(), key=lambda im: im.name)
    c2ws, names = [], []
    for im in ordered:
        c2w = im.camera_to_world()
        c2w[:3, 1:3] *= -1  # OpenCV -> OpenGL
        c2ws.append(c2w)
        names.append(str(images_dir / im.name))
    poses, transform, scale = normalize_poses(np.stack(c2ws))

    cam = cameras[ordered[0].camera_id]
    intr = cm.camera_intrinsics(cam)
    common.export_minimal_npz(
        output,
        names,
        poses[:, :3, :4],
        intr,
        cam.width,
        cam.height,
        eval_interval=args.eval_interval,
        applied_transform=transform,
        applied_scale=scale,
    )
    common.export_points_ply(points, output / "sparse.ply")
    if args.train_pointcloud:
        # Re-triangulate against the existing database using only the
        # training images' registrations: eval views then contribute no
        # 3D points (the reference's separate training point cloud,
        # process_images.py:239-276).
        eval_idx = set(range(0, len(ordered), args.eval_interval))
        train_meta = {
            im.image_id: im
            for i, im in enumerate(ordered)
            if i not in eval_idx
        }
        prior = output / "colmap" / "sparse_train_prior"
        cm.write_model(cameras, train_meta, {}, prior, binary=False)
        tri_out = output / "colmap" / "sparse_train"
        tri_out.mkdir(parents=True, exist_ok=True)
        colmap_bin = common.require_binary("colmap")
        common.run_command(
            [
                colmap_bin, "point_triangulator",
                "--database_path", output / "colmap" / "database.db",
                "--image_path", images_dir,
                "--input_path", prior,
                "--output_path", tri_out,
            ]
        )
        _, _, train_points = cm.read_model(tri_out)
        common.export_points_ply(train_points, output / "sparse_train.ply")
    if args.dense:
        fused = output / "colmap" / "dense" / "fused.ply"
        if fused.exists():
            print(f"dense cloud at {fused}", file=sys.stderr)
    print("done", file=sys.stderr)


def entrypoint():
    main()


if __name__ == "__main__":
    main()
