"""COLMAP sparse-model IO (binary and text), implemented from the public
format specification (https://colmap.github.io/format.html).

The port's copy of :mod:`tetranerf_tpu.utils.colmap` (numpy only); a test
reads the files each package writes with the other.

Covers what the pipeline needs: reading/writing ``cameras``, ``images``,
``points3D`` in both encodings plus quaternion helpers. The reference
vendors COLMAP's own scripts for this (``tetranerf/utils/colmap_utils.py``);
this is an independent numpy implementation of the same file formats.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

# camera model id -> (name, num_params), from the COLMAP documentation.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # [4] w,x,y,z
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [N, 2]
    point3D_ids: np.ndarray  # [N]

    def world_to_camera(self) -> np.ndarray:
        """4x4 world-to-camera matrix (OpenCV convention)."""
        m = np.eye(4)
        m[:3, :3] = qvec_to_rotmat(self.qvec)
        m[:3, 3] = self.tvec
        return m

    def camera_to_world(self) -> np.ndarray:
        return np.linalg.inv(self.world_to_camera())


@dataclasses.dataclass
class Point3D:
    point3D_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    # Shepperd's method via the symmetric 4x4 eigen problem.
    k = (
        np.array(
            [
                [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
                [r[0, 1] + r[1, 0], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
                [r[0, 2] + r[2, 0], r[1, 2] + r[2, 1], r[2, 2] - r[0, 0] - r[1, 1], 0],
                [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1], r[0, 0] + r[1, 1] + r[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ------------------------------------------------------------------ binary IO
def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cid, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cameras[cid] = Camera(cid, name, int(width), int(height), params)
    return cameras


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cid = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * npts), dtype=[("xy", "<f8", 2), ("id", "<i8")]
            )
            images[iid] = Image(
                iid,
                qvec,
                tvec,
                cid,
                name.decode("utf-8"),
                data["xy"].copy(),
                data["id"].copy(),
            )
    return images


def read_points3d_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"), dtype=np.uint8)
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(
                f.read(8 * track_len), dtype=[("img", "<i4"), ("idx", "<i4")]
            )
            points[pid] = Point3D(
                pid, xyz, rgb, error, track["img"].copy(), track["idx"].copy()
            )
    return points


def write_cameras_binary(cameras: Dict[int, Camera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, Image], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_points3d_binary(points: Dict[int, Point3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", int(p.point3D_id)))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", float(p.error)))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for img, idx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(img), int(idx)))


# -------------------------------------------------------------------- text IO
def read_cameras_text(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cameras[cid] = Camera(
                cid,
                parts[1],
                int(parts[2]),
                int(parts[3]),
                np.array([float(x) for x in parts[4:]]),
            )
    return cameras


def read_images_text(path) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        # Keep BLANK lines: an image with zero observations has an empty
        # points2D line (COLMAP writes one), and dropping it would shift
        # the image/points pairing for every following image.
        lines = [
            ln.strip()
            for ln in f
            if not ln.strip().startswith("#")
        ]
    while lines and not lines[0]:
        lines.pop(0)
    if len(lines) % 2:
        # Final image's empty points2D line lost to a missing trailing
        # newline.
        lines.append("")
    for head, pts in zip(lines[0::2], lines[1::2]):
        parts = head.split()
        iid = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cid = int(parts[8])
        name = parts[9]
        elems = pts.split()
        xys = np.array(
            [[float(x), float(y)] for x, y in zip(elems[0::3], elems[1::3])]
        ).reshape(-1, 2)
        ids = np.array([int(i) for i in elems[2::3]], dtype=np.int64)
        images[iid] = Image(iid, qvec, tvec, cid, name, xys, ids)
    return images


def read_points3d_text(path) -> Dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array([float(x) for x in parts[1:4]])
            rgb = np.array([int(x) for x in parts[4:7]], dtype=np.uint8)
            error = float(parts[7])
            track = np.array([int(x) for x in parts[8:]], dtype=np.int64)
            points[pid] = Point3D(
                pid, xyz, rgb, error, track[0::2].astype(np.int32), track[1::2].astype(np.int32)
            )
    return points


def write_images_text(images: Dict[int, Image], path) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for im in images.values():
            q, t = im.qvec, im.tvec
            f.write(
                f"{im.image_id} {q[0]} {q[1]} {q[2]} {q[3]} "
                f"{t[0]} {t[1]} {t[2]} {im.camera_id} {im.name}\n"
            )
            f.write(
                " ".join(
                    f"{xy[0]} {xy[1]} {int(pid)}"
                    for xy, pid in zip(im.xys, im.point3D_ids)
                )
                + "\n"
            )


def write_cameras_text(cameras: Dict[int, Camera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera\n")
        for cam in cameras.values():
            params = " ".join(str(p) for p in cam.params)
            f.write(
                f"{cam.camera_id} {cam.model} {cam.width} {cam.height} {params}\n"
            )


def write_points3d_text(points: Dict[int, Point3D], path) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point\n")
        for p in points.values():
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            xyz = " ".join(str(v) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            f.write(f"{int(p.point3D_id)} {xyz} {rgb} {p.error} {track}\n")


# ----------------------------------------------------------------- model-level
def read_model(path) -> Tuple[Dict[int, Camera], Dict[int, Image], Dict[int, Point3D]]:
    """Read a COLMAP model directory (auto-detects binary vs text)."""
    path = str(path)
    if os.path.exists(os.path.join(path, "cameras.bin")):
        return (
            read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")),
        )
    if os.path.exists(os.path.join(path, "cameras.txt")):
        return (
            read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3d_text(os.path.join(path, "points3D.txt")),
        )
    raise FileNotFoundError(f"no COLMAP model found in {path}")


def write_model(cameras, images, points, path, binary: bool = True) -> None:
    os.makedirs(path, exist_ok=True)
    if binary:
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3d_binary(points, os.path.join(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3d_text(points, os.path.join(path, "points3D.txt"))


def camera_intrinsics(cam: Camera) -> Dict[str, float]:
    """fx/fy/cx/cy + distortion + ``camera_type`` for all COLMAP camera
    models the reference handles (``tetranerf/scripts/utils.py:54-252``
    covers 10 of 11; THIN_PRISM_FISHEYE is unsupported there too).

    ``camera_type`` is one of ``perspective``/``fisheye``/``fov`` and
    selects the distortion family in :mod:`.cameras`.
    Parameter orders follow COLMAP's ``camera_models.h``.
    """
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE":
        return {"fx": p[0], "fy": p[0], "cx": p[1], "cy": p[2],
                "camera_type": "perspective"}
    if cam.model == "PINHOLE":
        return {"fx": p[0], "fy": p[1], "cx": p[2], "cy": p[3],
                "camera_type": "perspective"}
    if cam.model == "SIMPLE_RADIAL":
        return {"fx": p[0], "fy": p[0], "cx": p[1], "cy": p[2],
                "k1": p[3], "camera_type": "perspective"}
    if cam.model == "RADIAL":
        return {"fx": p[0], "fy": p[0], "cx": p[1], "cy": p[2],
                "k1": p[3], "k2": p[4], "camera_type": "perspective"}
    if cam.model == "OPENCV":
        return {"fx": p[0], "fy": p[1], "cx": p[2], "cy": p[3],
                "k1": p[4], "k2": p[5], "p1": p[6], "p2": p[7],
                "camera_type": "perspective"}
    if cam.model == "FULL_OPENCV":
        return {"fx": p[0], "fy": p[1], "cx": p[2], "cy": p[3],
                "k1": p[4], "k2": p[5], "p1": p[6], "p2": p[7],
                "k3": p[8], "k4": p[9], "k5": p[10], "k6": p[11],
                "camera_type": "perspective"}
    if cam.model == "OPENCV_FISHEYE":
        return {"fx": p[0], "fy": p[1], "cx": p[2], "cy": p[3],
                "k1": p[4], "k2": p[5], "k3": p[6], "k4": p[7],
                "camera_type": "fisheye"}
    if cam.model == "SIMPLE_RADIAL_FISHEYE":
        return {"fx": p[0], "fy": p[0], "cx": p[1], "cy": p[2],
                "k1": p[3], "camera_type": "fisheye"}
    if cam.model == "RADIAL_FISHEYE":
        return {"fx": p[0], "fy": p[0], "cx": p[1], "cy": p[2],
                "k1": p[3], "k2": p[4], "camera_type": "fisheye"}
    if cam.model == "FOV":
        return {"fx": p[0], "fy": p[1], "cx": p[2], "cy": p[3],
                "omega": p[4], "camera_type": "fov"}
    raise NotImplementedError(f"camera model {cam.model}")
