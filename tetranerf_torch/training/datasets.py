"""Datasets and ray generation: the port's copy of
:mod:`tetranerf_tpu.training.datasets` (numpy only), with images read by
:mod:`..utils.png` instead of Pillow.

- :func:`load_blender` — ``transforms_{split}.json`` synthetic scenes.
- :func:`load_minimal_npz` — the reference's preprocessed ``{split}.npz``
  format (written by ``tetranerf/scripts/process_images.py:84-94``).
- :func:`load_colmap` — a COLMAP sparse model + images directory with the
  nerfstudio-style normalization, reported as ``dataparser_transform`` /
  ``dataparser_scale`` so ``.th`` tetrahedra built in raw COLMAP space can
  be mapped into the training space (reference ``model.py:349-392``).

Arrays, rays and ray batches are bit-equal to the JAX package's for the
same files and the same ``np.random.Generator``. Cameras use the
OpenGL/nerfstudio convention: ``camera_to_worlds`` with +x right, +y up,
-z forward.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils import cameras as cameras_mod
from ..utils import png
from ..utils.cameras import Distortion


@dataclasses.dataclass
class SceneDataset:
    """Loaded split: images + cameras (+ optional sparse points)."""

    images: np.ndarray  # f32[N, H, W, 3] in [0, 1]
    camera_to_worlds: np.ndarray  # f32[N, 3, 4] (OpenGL convention)
    fx: np.ndarray  # f32[N]
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int
    dataparser_transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4)[:3].astype(np.float64)
    )
    dataparser_scale: float = 1.0
    points3d_xyz: Optional[np.ndarray] = None  # in *normalized* space
    points3d_rgb: Optional[np.ndarray] = None
    alpha_color: Optional[np.ndarray] = None  # background used to composite
    # Lens distortion (None = ideal pinhole). Ray generation undistorts
    # pixel coordinates through it — the reference gets this from
    # nerfstudio's camera undistortion; pinhole-only rays on an
    # OPENCV-calibrated scene would train on wrong geometry.
    distortion: Optional["Distortion"] = None

    @property
    def num_images(self) -> int:
        return len(self.images)

    def camera_rays(self, image_idx: int):
        """All pixel rays of one image -> (origins, directions) [H*W, 3]."""
        ys, xs = np.mgrid[0 : self.height, 0 : self.width].astype(np.float32)
        return self._pixel_rays(
            np.full(xs.size, image_idx, np.int32),
            xs.reshape(-1),
            ys.reshape(-1),
        )

    def _pixel_rays(self, img_idx, xs, ys):
        fx = self.fx[img_idx]
        fy = self.fy[img_idx]
        cx = self.cx[img_idx]
        cy = self.cy[img_idx]
        # Pixel centers in normalized (distorted) camera coordinates.
        xn = (xs + 0.5 - cx) / fx
        yn = (ys + 0.5 - cy) / fy
        if self.distortion is not None and not self.distortion.is_identity:
            xn, yn = self.distortion.undistort(xn, yn, img_idx)
        # OpenGL camera: +x right, +y up, -z forward.
        dirs = np.stack(
            [xn, -yn, -np.ones_like(xn)],
            axis=-1,
        )
        c2w = self.camera_to_worlds[img_idx]  # [..., 3, 4]
        world_dirs = np.einsum("...ij,...j->...i", c2w[..., :3, :3], dirs)
        world_dirs /= np.linalg.norm(world_dirs, axis=-1, keepdims=True)
        origins = np.broadcast_to(c2w[..., :3, 3], world_dirs.shape)
        return (
            np.ascontiguousarray(origins, np.float32),
            np.ascontiguousarray(world_dirs, np.float32),
        )

    def sample_ray_batch(self, rng: np.random.Generator, num_rays: int):
        """Random-pixel training batch across all images."""
        img_idx = rng.integers(0, self.num_images, num_rays).astype(np.int32)
        xs = rng.integers(0, self.width, num_rays).astype(np.float32)
        ys = rng.integers(0, self.height, num_rays).astype(np.float32)
        origins, dirs = self._pixel_rays(img_idx, xs, ys)
        rgb = self.images[
            img_idx, ys.astype(np.int64), xs.astype(np.int64)
        ].astype(np.float32)
        return {
            "origins": origins,
            "directions": dirs,
            "rgb": rgb,
            "camera_indices": img_idx,
        }


def _composite(img: np.ndarray, background: Optional[np.ndarray] = None) -> np.ndarray:
    """``uint8`` gray / gray+alpha / RGB / RGBA -> f32 RGB in [0, 1], alpha
    composited over ``background`` (white by default)."""
    img = np.asarray(img, dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:  # gray + alpha
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    if img.shape[-1] == 4:
        alpha = img[..., 3:4]
        bg = background if background is not None else np.ones(3, np.float32)
        img = img[..., :3] * alpha + bg * (1.0 - alpha)
    return img[..., :3]


def _load_image(path, background: Optional[np.ndarray] = None) -> np.ndarray:
    return _composite(png.read_image(path), background)


def _load_images(paths, background: Optional[np.ndarray] = None) -> list:
    """Several images; the PNGs among them decoded together."""
    paths = [Path(p) for p in paths]
    pngs = [i for i, p in enumerate(paths) if png.is_png(p)]
    raw = dict(zip(pngs, png.read_pngs([paths[i] for i in pngs])))
    return [_composite(raw[i] if i in raw else png.read_image(p), background)
            for i, p in enumerate(paths)]


# ------------------------------------------------------------------- blender
def load_blender(
    data_dir, split: str = "train", background_color=(1.0, 1.0, 1.0)
) -> SceneDataset:
    """NeRF-synthetic ``transforms_{split}.json`` scenes (RGBA composited
    over white, matching the reference's white-background default)."""
    data_dir = Path(data_dir)
    with open(data_dir / f"transforms_{split}.json") as f:
        meta = json.load(f)
    bg = np.asarray(background_color, np.float32)
    files, poses = [], []
    for frame in meta["frames"]:
        fname = frame["file_path"]
        if not os.path.splitext(fname)[1]:
            fname += ".png"
        files.append(data_dir / fname)
        poses.append(np.asarray(frame["transform_matrix"], np.float64))
    images = np.stack(_load_images(files, bg))
    poses = np.stack(poses)  # [N, 4, 4], OpenGL c2w already
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    n = len(images)
    return SceneDataset(
        images=images,
        camera_to_worlds=poses[:, :3, :4].astype(np.float32),
        fx=np.full(n, focal, np.float32),
        fy=np.full(n, focal, np.float32),
        cx=np.full(n, w / 2.0, np.float32),
        cy=np.full(n, h / 2.0, np.float32),
        width=w,
        height=h,
        alpha_color=bg,
    )


# --------------------------------------------------------------- minimal npz
def load_minimal_npz(path, data_dir=None) -> SceneDataset:
    """The reference's preprocessed split format (``{split}.npz``)."""
    path = Path(path)
    data_dir = Path(data_dir) if data_dir is not None else path.parent
    with np.load(path, allow_pickle=True) as data:
        cameras = data["cameras"].item()
        filenames = [str(f) for f in data["image_filenames"]]
        transform = (
            np.asarray(data["applied_transform"], np.float64)
            if "applied_transform" in data
            else np.eye(4)[:3]
        )
        scale = (
            float(data["applied_scale"]) if "applied_scale" in data else 1.0
        )
    images = np.stack(_load_images(
        [f if os.path.isabs(f) else str(data_dir / f) for f in filenames]
    ))
    c2w = np.asarray(cameras["camera_to_worlds"], np.float32)
    n = len(images)

    def per_image(key):
        v = np.asarray(cameras[key], np.float32).reshape(-1)
        return np.broadcast_to(v, (n,)).copy() if v.size == 1 else v

    return SceneDataset(
        images=images,
        camera_to_worlds=c2w[:, :3, :4],
        fx=per_image("fx"),
        fy=per_image("fy"),
        cx=per_image("cx"),
        cy=per_image("cy"),
        width=int(np.asarray(cameras["width"]).reshape(-1)[0]),
        height=int(np.asarray(cameras["height"]).reshape(-1)[0]),
        dataparser_transform=transform,
        dataparser_scale=scale,
    )


# -------------------------------------------------------------------- colmap
def normalize_poses(poses: np.ndarray):
    """Orient mean-up to +z, recenter, scale to unit max translation —
    the reference's ``transform_poses`` normalization
    (``tetranerf/scripts/utils.py:33-50``) / nerfstudio's
    auto_orient_and_center_poses.

    Returns ``(normalized_poses [N,4,4], transform [3,4], scale)``.
    """
    poses = np.asarray(poses, np.float64)
    translation = poses[:, :3, 3].mean(axis=0)
    up = poses[:, :3, 1].mean(axis=0)
    up /= np.linalg.norm(up)
    rotation = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
    transform = np.concatenate(
        [rotation, rotation @ -translation[:, None]], axis=-1
    )  # [3, 4]
    oriented = np.einsum("ij,njk->nik", transform[:, :3], poses[:, :3])
    oriented = np.concatenate(
        [oriented[:, :, :3], oriented[:, :, 3:] + 0.0], axis=-1
    )
    new = np.tile(np.eye(4), (len(poses), 1, 1))
    new[:, :3, :3] = oriented[:, :, :3]
    new[:, :3, 3] = (
        np.einsum("ij,nj->ni", transform[:, :3], poses[:, :3, 3])
        + transform[:, 3]
    )
    scale = 1.0 / float(np.max(np.abs(new[:, :3, 3])) + 1e-12)
    new[:, :3, 3] *= scale
    return new, transform, scale


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b."""
    v = np.cross(a, b)
    c = float(a @ b)
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
    )
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s * s))


def apply_transform(points: np.ndarray, transform: np.ndarray, scale: float):
    """Map raw-space points into the normalized training space — the
    vertex mapping the reference applies when loading ``.th`` tetrahedra
    (``model.py:363-373``)."""
    points = np.asarray(points, np.float64)
    out = points @ transform[:, :3].T + transform[:, 3]
    return out * scale


def load_colmap(
    data_dir,
    images_dir: Optional[str] = None,
    split: Optional[str] = None,
    eval_interval: int = 8,
    downscale: int = 1,
) -> SceneDataset:
    """COLMAP model + images with nerfstudio-style normalization.

    ``split``: None = all images, "train"/"test" = every-``eval_interval``
    holdout (the reference's split policy,
    ``tetranerf/scripts/process_images.py:222-224``).
    """
    from ..utils import colmap as cm

    data_dir = Path(data_dir)
    model_dir = data_dir
    for cand in ["sparse/0", "sparse", "colmap/sparse/0", "."]:
        if (data_dir / cand / "cameras.bin").exists() or (
            data_dir / cand / "cameras.txt"
        ).exists():
            model_dir = data_dir / cand
            break
    cameras, images_meta, points = cm.read_model(model_dir)
    if images_dir is None:
        for cand in ["images", "rgb", "."]:
            if (data_dir / cand).is_dir():
                images_dir = data_dir / cand
                break
    images_dir = Path(images_dir)

    ordered = sorted(images_meta.values(), key=lambda im: im.name)
    if split is not None:
        train = [
            im for i, im in enumerate(ordered) if i % eval_interval != 0
        ]
        test = [im for i, im in enumerate(ordered) if i % eval_interval == 0]
        ordered = train if split == "train" else test

    imgs, c2ws, fx, fy, cx, cy = [], [], [], [], [], []
    dist_rows, cam_types = [], set()
    for im in ordered:
        cam = cameras[im.camera_id]
        intr = cm.camera_intrinsics(cam)
        img = _load_image(images_dir / im.name)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        imgs.append(img)
        c2w = im.camera_to_world()
        c2w[:3, 1:3] *= -1  # OpenCV -> OpenGL camera axes
        c2ws.append(c2w)
        fx.append(intr["fx"] / downscale)
        fy.append(intr["fy"] / downscale)
        cx.append(intr["cx"] / downscale)
        cy.append(intr["cy"] / downscale)
        dist_rows.append(cameras_mod.distortion_from_intrinsics(intr))
        cam_types.add(intr["camera_type"])
    if len(cam_types) > 1:
        raise ValueError(
            f"mixed camera distortion families in one scene: {cam_types}"
        )
    dist_rows = np.stack(dist_rows)
    distortion = (
        None
        if not np.any(dist_rows)
        and next(iter(cam_types), "perspective") == "perspective"
        else cameras_mod.Distortion(next(iter(cam_types)), dist_rows)
    )

    poses, transform, scale = normalize_poses(np.stack(c2ws))
    xyz = np.stack([p.xyz for p in points.values()]) if points else None
    rgb = (
        np.stack([p.rgb for p in points.values()]).astype(np.uint8)
        if points
        else None
    )
    if xyz is not None:
        xyz = apply_transform(xyz, transform, scale)
    images_arr = np.stack(imgs)
    return SceneDataset(
        images=images_arr,
        camera_to_worlds=poses[:, :3, :4].astype(np.float32),
        fx=np.asarray(fx, np.float32),
        fy=np.asarray(fy, np.float32),
        cx=np.asarray(cx, np.float32),
        cy=np.asarray(cy, np.float32),
        width=images_arr.shape[2],
        height=images_arr.shape[1],
        dataparser_transform=transform,
        dataparser_scale=scale,
        points3d_xyz=xyz,
        points3d_rgb=rgb,
        distortion=distortion,
    )


def load_dataset(data_dir, split: str = "train", **kwargs) -> SceneDataset:
    """Auto-detect the dataset format in ``data_dir``. Only COLMAP scenes
    take ``downscale``, as in the JAX package."""
    data_dir = Path(data_dir)
    blender = (data_dir / f"transforms_{split}.json").exists()
    npz = data_dir / f"{split}.npz"
    if "downscale" in kwargs and (blender or npz.exists()):
        raise ValueError(
            f"{data_dir}: downscale is supported for COLMAP scenes only, not "
            f"for {'Blender' if blender else 'minimal-npz'} scenes"
        )
    if blender:
        return load_blender(data_dir, split, **kwargs)
    if npz.exists():
        return load_minimal_npz(npz, data_dir, **kwargs)
    return load_colmap(data_dir, split=split, **kwargs)
