"""Shared helpers of the dataset preprocessing CLIs.

The port's copy of :mod:`tetranerf_tpu.scripts.common` (the reference's
``tetranerf/scripts/utils.py`` and ``process_images.py`` support code):
COLMAP and ffmpeg driven as subprocesses (each step exits naming the binary
when it is not on ``PATH``), the minimal-``.npz`` split export, and the
known-pose COLMAP database of ``point_triangulator`` workflows, over the
port's :mod:`..utils.colmap`.
"""

from __future__ import annotations

import shutil
import sqlite3
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import colmap as cm


def require_binary(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise SystemExit(
            f"`{name}` binary not found on PATH — this preprocessing step "
            f"shells out to {name} (same requirement as the reference "
            "pipeline). Install it or run this step on a machine that has it."
        )
    return path


def run_command(cmd: Sequence[str], verbose: bool = True) -> None:
    if verbose:
        print("+ " + " ".join(str(c) for c in cmd), file=sys.stderr)
    subprocess.run([str(c) for c in cmd], check=True)


def downscale_images(
    src_dir: Path, dst_dir: Path, factor: int, verbose: bool = True
) -> Path:
    """Downscale all images by an integer factor (the reference shells out
    to ffmpeg, ``process_images.py:111-135``; Pillow is the fallback when
    ffmpeg is unavailable, and without either the step exits naming
    both)."""
    src_dir, dst_dir = Path(src_dir), Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(
        p for p in src_dir.iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    ffmpeg = shutil.which("ffmpeg")
    for p in files:
        out = dst_dir / p.name
        if ffmpeg:
            run_command(
                [
                    ffmpeg, "-y", "-loglevel", "error", "-i", p,
                    "-vf", f"scale=iw/{factor}:ih/{factor}", out,
                ],
                verbose=verbose,
            )
        else:
            try:
                from PIL import Image
            except ImportError:
                raise SystemExit(
                    "downscaling images needs the `ffmpeg` binary on PATH or "
                    "Pillow, and neither is available. Install one, or run "
                    "this step on a machine that has it."
                ) from None
            img = Image.open(p)
            img.resize(
                (img.width // factor, img.height // factor), Image.LANCZOS
            ).save(out)
    return dst_dir


def extract_video_frames(
    video: Path, dst_dir: Path, fps: Optional[float] = None
) -> Path:
    """Extract frames from a video with ffmpeg (gated on availability)."""
    ffmpeg = require_binary("ffmpeg")
    dst_dir = Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    cmd = [ffmpeg, "-y", "-loglevel", "error", "-i", video]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += [dst_dir / "frame_%05d.png"]
    run_command(cmd)
    return dst_dir


# ----------------------------------------------------------- npz split export
def export_minimal_npz(
    output: Path,
    image_paths: List[str],
    c2ws: np.ndarray,
    intrinsics: Dict[str, float],
    width: int,
    height: int,
    eval_interval: int = 8,
    applied_transform: Optional[np.ndarray] = None,
    applied_scale: float = 1.0,
) -> None:
    """Write ``{train,val,test}.npz`` in the reference's minimal-parser
    format (``process_images.py:84-94``): eval split = every
    ``eval_interval``-th image (``:222-224``)."""
    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    dtype = np.float32
    cameras_common = {
        "fx": np.array(intrinsics["fx"], dtype),
        "fy": np.array(intrinsics["fy"], dtype),
        "cx": np.array(intrinsics["cx"], dtype),
        "cy": np.array(intrinsics["cy"], dtype),
        "width": np.array(width, np.int32),
        "height": np.array(height, np.int32),
        "camera_type": np.array(1, np.int32),
    }
    n = len(image_paths)
    eval_idx = set(range(0, n, eval_interval))
    train_idx = [i for i in range(n) if i not in eval_idx]
    splits = {
        "train": train_idx,
        "val": sorted(eval_idx),
        "test": sorted(eval_idx),
    }
    extra = {}
    if applied_transform is not None:
        extra["applied_transform"] = np.asarray(applied_transform, np.float64)
        extra["applied_scale"] = np.float64(applied_scale)
    for split, idx in splits.items():
        np.savez(
            output / f"{split}.npz",
            image_filenames=[image_paths[i] for i in idx],
            cameras=np.array(
                dict(
                    camera_to_worlds=c2ws[idx].astype(dtype),
                    **cameras_common,
                )
            ),
            scene_box=np.array([[-1, -1, -1], [1, 1, 1]], dtype),
            **extra,
        )
        print(f"split {split}: {len(idx)} images -> {split}.npz", file=sys.stderr)


# ----------------------------------------------- known-pose COLMAP database
def create_colmap_database(
    db_path: Path, cameras: Dict[int, cm.Camera], image_names: Dict[int, str]
) -> None:
    """Create a COLMAP sqlite database pre-filled with cameras and images
    (known-pose reconstruction workflows; schema per the COLMAP docs)."""
    db_path = Path(db_path)
    if db_path.exists():
        db_path.unlink()
    db = sqlite3.connect(str(db_path))
    db.executescript(
        """
        CREATE TABLE cameras (
            camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
            model INTEGER NOT NULL, width INTEGER NOT NULL,
            height INTEGER NOT NULL, params BLOB,
            prior_focal_length INTEGER NOT NULL);
        CREATE TABLE images (
            image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
            name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
            prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
            prior_tx REAL, prior_ty REAL, prior_tz REAL);
        CREATE TABLE keypoints (
            image_id INTEGER PRIMARY KEY NOT NULL,
            rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
        CREATE TABLE descriptors (
            image_id INTEGER PRIMARY KEY NOT NULL,
            rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
        CREATE TABLE matches (
            pair_id INTEGER PRIMARY KEY NOT NULL,
            rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
        CREATE TABLE two_view_geometries (
            pair_id INTEGER PRIMARY KEY NOT NULL,
            rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
            config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB,
            qvec BLOB, tvec BLOB);
        """
    )
    for cam in cameras.values():
        db.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                cam.camera_id,
                cm.CAMERA_MODEL_IDS[cam.model],
                cam.width,
                cam.height,
                np.asarray(cam.params, np.float64).tobytes(),
                1,
            ),
        )
    for image_id, name in image_names.items():
        db.execute(
            "INSERT INTO images VALUES (?, ?, ?, NULL, NULL, NULL, NULL, "
            "NULL, NULL, NULL)",
            (image_id, name, 1),
        )
    db.commit()
    db.close()


def export_points_ply(points: Dict[int, cm.Point3D], path: Path) -> None:
    from ..geometry import write_ply

    xyz = np.stack([p.xyz for p in points.values()])
    rgb = np.stack([p.rgb for p in points.values()]).astype(np.uint8)
    write_ply(path, xyz, rgb)
    print(f"wrote {len(xyz)} points to {path}", file=sys.stderr)


def colmap_sfm(
    images_dir: Path,
    workspace: Path,
    camera_model: str = "OPENCV",
    dense: bool = False,
) -> Path:
    """Run feature extraction + matching + mapping; returns the sparse
    model directory (``process_images.py:159-211`` equivalent)."""
    colmap = require_binary("colmap")
    workspace = Path(workspace)
    workspace.mkdir(parents=True, exist_ok=True)
    db = workspace / "database.db"
    run_command(
        [
            colmap, "feature_extractor",
            "--database_path", db,
            "--image_path", images_dir,
            "--ImageReader.camera_model", camera_model,
            "--ImageReader.single_camera", "1",
        ]
    )
    run_command(
        [colmap, "exhaustive_matcher", "--database_path", db]
    )
    sparse = workspace / "sparse"
    sparse.mkdir(exist_ok=True)
    run_command(
        [
            colmap, "mapper",
            "--database_path", db,
            "--image_path", images_dir,
            "--output_path", sparse,
        ]
    )
    if dense:
        colmap_dense(images_dir, sparse / "0", workspace / "dense")
    return sparse / "0"


def colmap_dense(images_dir: Path, sparse_model: Path, out_dir: Path) -> Path:
    """Undistort + patch-match stereo + fusion → dense point cloud .ply."""
    colmap = require_binary("colmap")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run_command(
        [
            colmap, "image_undistorter",
            "--image_path", images_dir,
            "--input_path", sparse_model,
            "--output_path", out_dir,
        ]
    )
    run_command(
        [colmap, "patch_match_stereo", "--workspace_path", out_dir]
    )
    fused = out_dir / "fused.ply"
    run_command(
        [
            colmap, "stereo_fusion",
            "--workspace_path", out_dir,
            "--output_path", fused,
        ]
    )
    return fused


def known_pose_triangulation(
    images_dir: Path,
    workspace: Path,
    cameras: Dict[int, cm.Camera],
    images_meta: Dict[int, cm.Image],
) -> Path:
    """COLMAP triangulation with fixed known poses: build the database and
    an empty-points model, run feature extraction/matching, then
    ``point_triangulator`` (``process_blender.py:89-174`` equivalent)."""
    colmap = require_binary("colmap")
    workspace = Path(workspace)
    workspace.mkdir(parents=True, exist_ok=True)
    db = workspace / "database.db"
    create_colmap_database(
        db, cameras, {i: im.name for i, im in images_meta.items()}
    )
    prior = workspace / "prior"
    cm.write_model(cameras, images_meta, {}, prior, binary=False)
    run_command(
        [
            colmap, "feature_extractor",
            "--database_path", db,
            "--image_path", images_dir,
        ]
    )
    run_command([colmap, "exhaustive_matcher", "--database_path", db])
    out = workspace / "triangulated"
    out.mkdir(exist_ok=True)
    run_command(
        [
            colmap, "point_triangulator",
            "--database_path", db,
            "--image_path", images_dir,
            "--input_path", prior,
            "--output_path", out,
        ]
    )
    return out
