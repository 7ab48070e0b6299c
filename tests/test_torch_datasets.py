"""The port's host data path against the JAX package and Pillow: the PNG
codec, the dataset loaders (every array bit-equal), rays and ray batches,
the camera distortions, and COLMAP, PLY and tetrahedra files written by one
package and read by the other."""

import dataclasses
import json
import runpy
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tetranerf_torch.geometry import io as port_io
from tetranerf_torch.geometry import ply as port_ply
from tetranerf_torch.training import datasets as port_ds
from tetranerf_torch.utils import cameras as port_cam
from tetranerf_torch.utils import colmap as port_colmap
from tetranerf_torch.utils import png
from tetranerf_torch.utils.synthetic_dataset import write_sphere_dataset
from tetranerf_tpu.geometry import io as jax_io
from tetranerf_tpu.geometry import ply as jax_ply
from tetranerf_tpu.training import datasets as jax_ds
from tetranerf_tpu.utils import cameras as jax_cam
from tetranerf_tpu.utils import colmap as jax_colmap


MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(rng, h, w, ch, smooth=True):
    """Smooth gradients with noise: PIL's adaptive filtering then picks
    several filter types."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 5.0 + k) * 60 + np.cos(yy / 3.0) * 50 + 128
                     for k in range(ch)], axis=-1) if smooth else np.zeros((h, w, ch))
    img = (base + rng.integers(0, 256 if not smooth else 30, base.shape)).clip(0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if ch == 1 else img


# ---------------------------------------------------------------- PNG codec


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _encode_png(path, img, row_filters, interlace=0, depth=8):
    """A reference encoder that writes row ``y`` with filter
    ``row_filters[y]`` (all five PNG filters, written out one byte at a
    time as the specification states them)."""
    img = img[..., None] if img.ndim == 2 else img
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    for y in range(h):
        ft = row_filters[y]
        out.append(ft)
        for x in range(w * ch):
            raw = rows[y, x]
            a = rows[y, x - ch] if x >= ch else 0
            b = rows[y - 1, x] if y > 0 else 0
            c = rows[y - 1, x - ch] if (y > 0 and x >= ch) else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out.append((raw - pred) & 255)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                interlace)))
        f.write(_png_chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(_png_chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_what_pil_writes(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    img = _image(rng, 37, 53, MODES[mode])
    path = tmp_path / "a.png"
    Image.fromarray(img, mode).save(path)
    assert len(set(png._parse(path)[3].tolist())) >= 2  # several filters in use
    got = png.read_png(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_all_five_filters(tmp_path, mode):
    """Rows cycling through filters 0-4, in two images decoded together and
    alone (the wavefront batches images of one shape): what PIL reads."""
    rng = np.random.default_rng(5)
    paths, imgs = [], []
    for k, smooth in enumerate((True, False)):
        img = _image(rng, 23, 19, MODES[mode], smooth)
        path = tmp_path / f"f{k}.png"
        _encode_png(path, img, [(y + k) % 5 for y in range(23)])
        assert sorted(set(png._parse(path)[3].tolist())) == [0, 1, 2, 3, 4]
        paths.append(path)
        imgs.append(img)
    together = png.read_pngs(paths)
    for path, img, got in zip(paths, imgs, together):
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("filter_type", [0, 1])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_writer_read_by_pil(tmp_path, mode, filter_type):
    img = _image(np.random.default_rng(1), 31, 45, MODES[mode], smooth=False)
    path = tmp_path / "w.png"
    png.write_png(path, img, filter_type=filter_type)
    assert set(png._parse(path)[3].tolist()) == {filter_type}
    opened = Image.open(path)
    assert opened.mode == mode
    np.testing.assert_array_equal(np.asarray(opened), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_refuses_what_it_does_not_decode(tmp_path):
    rng = np.random.default_rng(2)
    cases = {}
    pal = tmp_path / "palette.png"
    Image.fromarray(_image(rng, 8, 8, 3)).convert("P").save(pal)
    cases[pal] = "palette"
    deep = tmp_path / "deep.png"
    Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.uint16)).save(deep)
    cases[deep] = "16-bit"
    inter = tmp_path / "interlaced.png"
    _encode_png(inter, _image(rng, 8, 8, 3), [0] * 8, interlace=1)
    cases[inter] = "interlaced"
    for path, what in cases.items():
        with pytest.raises(ValueError, match=what) as exc:
            png.read_png(path)
        assert str(path) in str(exc.value)


def test_jpeg_needs_pillow(tmp_path, monkeypatch):
    img = _image(np.random.default_rng(3), 16, 16, 3)
    path = tmp_path / "a.jpg"
    Image.fromarray(img).save(path, quality=95)
    np.testing.assert_array_equal(png.read_image(path), np.asarray(Image.open(path)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow") as exc:
        png.read_image(path)
    assert str(path) in str(exc.value)


# ------------------------------------------------------------------ loaders


def _assert_same_dataset(ours, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "distortion":
            assert (a is None) == (b is None)
            if b is not None:
                assert a.camera_type == b.camera_type
                np.testing.assert_array_equal(a.coeffs, b.coeffs)
            continue
        if b is None:
            assert a is None, f.name
            continue
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def _assert_same_rays(ours, ref):
    for i in range(ref.num_images):
        for a, b in zip(ours.camera_rays(i), ref.camera_rays(i)):
            np.testing.assert_array_equal(a, b)
    got = ours.sample_ray_batch(np.random.default_rng(3), 512)
    want = ref.sample_ray_batch(np.random.default_rng(3), 512)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _c2w(pos):
    forward = -pos / np.linalg.norm(pos)
    right = np.cross(forward, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, pos
    return c2w


@pytest.fixture()
def blender_dir(tmp_path):
    """``tests/test_datasets.py``'s scene, with real alpha and PIL's files."""
    rng = np.random.default_rng(42)
    frames = []
    for i in range(3):
        ang = i * 2.0
        img = rng.integers(0, 255, size=(16, 16, 4), dtype=np.uint8)
        Image.fromarray(img).save(tmp_path / f"r_{i}.png")
        frames.append({"file_path": f"./r_{i}", "transform_matrix":
                       _c2w(np.array([4 * np.cos(ang), 4 * np.sin(ang), 1.0])).tolist()})
    for split in ("train", "test"):
        with open(tmp_path / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    return tmp_path


def test_load_blender_bit_equal(blender_dir):
    for bg in ((1.0, 1.0, 1.0), (0.2, 0.5, 0.0)):
        ours = port_ds.load_blender(blender_dir, "train", background_color=bg)
        ref = jax_ds.load_blender(blender_dir, "train", background_color=bg)
        _assert_same_dataset(ours, ref)
        _assert_same_rays(ours, ref)
    _assert_same_dataset(port_ds.load_dataset(blender_dir, "test"),
                         jax_ds.load_dataset(blender_dir, "test"))


def test_blender_downscale_refused(blender_dir):
    """The JAX loader takes no ``downscale`` for Blender scenes; nor does the
    port's."""
    with pytest.raises(TypeError):
        jax_ds.load_dataset(blender_dir, "train", downscale=2)
    with pytest.raises(ValueError, match="COLMAP scenes only"):
        port_ds.load_dataset(blender_dir, "train", downscale=2)


def test_load_minimal_npz_bit_equal(tmp_path, blender_dir):
    ds = jax_ds.load_blender(blender_dir, "train")
    cameras = dict(camera_to_worlds=ds.camera_to_worlds, fx=ds.fx, fy=ds.fy,
                   cx=np.float32(8.5), cy=ds.cy, width=np.int32(ds.width),
                   height=np.int32(ds.height), camera_type=np.int32(1))
    transform = np.random.default_rng(4).normal(size=(3, 4))
    np.savez(tmp_path / "train.npz",
             image_filenames=[str(blender_dir / f"r_{i}.png") for i in range(2)] + ["r_2.png"],
             cameras=np.array(cameras), applied_transform=transform,
             applied_scale=np.float64(0.37),
             scene_box=np.array([[-1, -1, -1], [1, 1, 1]], np.float32))
    (tmp_path / "r_2.png").write_bytes((blender_dir / "r_2.png").read_bytes())
    ours = port_ds.load_minimal_npz(tmp_path / "train.npz")
    ref = jax_ds.load_minimal_npz(tmp_path / "train.npz")
    assert ours.dataparser_scale == ref.dataparser_scale == 0.37
    _assert_same_dataset(ours, ref)
    _assert_same_rays(ours, ref)
    _assert_same_dataset(port_ds.load_dataset(tmp_path, "train"),
                         jax_ds.load_dataset(tmp_path, "train"))


def _colmap_model(rng, model="OPENCV"):
    params = {"OPENCV": [30.0, 31.0, 16.0, 12.0, 0.05, -0.01, 0.001, -0.002],
              "OPENCV_FISHEYE": [30.0, 31.0, 16.0, 12.0, 0.03, -0.01, 0.002, 0.0],
              "PINHOLE": [30.0, 31.0, 16.0, 12.0]}[model]
    cameras = {1: jax_colmap.Camera(1, model, 32, 24, np.array(params))}
    images = {}
    for i in range(1, 10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i] = jax_colmap.Image(i, q * np.sign(q[0]), rng.normal(size=3), 1,
                                     f"im_{i}.png", rng.uniform(0, 30, size=(3, 2)),
                                     np.array([1, -1, 2], np.int64))
    points = {j: jax_colmap.Point3D(j, rng.normal(size=3),
                                    rng.integers(0, 255, 3).astype(np.uint8), 0.5,
                                    np.array([1, 2], np.int32), np.array([0, 1], np.int32))
              for j in range(1, 20)}
    return cameras, images, points


@pytest.mark.parametrize("model", ["OPENCV", "OPENCV_FISHEYE", "PINHOLE"])
def test_load_colmap_bit_equal(tmp_path, model):
    rng = np.random.default_rng(6)
    cameras, images, points = _colmap_model(rng, model)
    jax_colmap.write_model(cameras, images, points, tmp_path / "sparse" / "0")
    (tmp_path / "images").mkdir()
    for i in range(1, 10):
        Image.fromarray(_image(rng, 24, 32, 3)).save(tmp_path / "images" / f"im_{i}.png")
    for split in (None, "train", "test"):
        ours = port_ds.load_colmap(tmp_path, split=split)
        ref = jax_ds.load_colmap(tmp_path, split=split)
        assert (ref.distortion is None) == (model == "PINHOLE")
        _assert_same_dataset(ours, ref)
        _assert_same_rays(ours, ref)
    _assert_same_dataset(port_ds.load_colmap(tmp_path, split="train", downscale=2),
                         jax_ds.load_colmap(tmp_path, split="train", downscale=2))


def test_normalize_poses_and_transform_equal():
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    poses[:, :3, 3] = rng.normal(scale=2.0, size=(5, 3))
    for a, b in zip(port_ds.normalize_poses(poses), jax_ds.normalize_poses(poses)):
        np.testing.assert_array_equal(a, b)
    _, t, s = jax_ds.normalize_poses(poses)
    pts = rng.normal(size=(7, 3))
    np.testing.assert_array_equal(port_ds.apply_transform(pts, t, s),
                                  jax_ds.apply_transform(pts, t, s))


# ------------------------------------------------------------------ cameras


@pytest.mark.parametrize("ctype,coeffs", [
    ("perspective", [0.1, -0.05, 0.001, -0.002, 0.01, 0, 0, 0]),
    ("perspective", [-0.2, 0.08, 0, 0, 0, 0.01, -0.004, 0.002]),
    ("fisheye", [0.05, -0.01, 0.002, -0.0005, 0, 0, 0, 0]),
    ("fov", [0.9, 0, 0, 0, 0, 0, 0, 0]),
])
def test_distortion_matches_jax(ctype, coeffs):
    xs = np.linspace(-0.6, 0.6, 21)
    x, y = (a.ravel() for a in np.meshgrid(xs, xs))
    rows = np.asarray([coeffs, np.asarray(coeffs) * 0.5])
    idx = np.arange(x.size) % 2
    ours, ref = port_cam.Distortion(ctype, rows), jax_cam.Distortion(ctype, rows)
    assert ours.is_identity == ref.is_identity
    for fn in ("distort", "undistort"):
        for a, b in zip(getattr(ours, fn)(x, y, idx), getattr(ref, fn)(x, y, idx)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_PINHOLE", [100, 50, 40]), ("SIMPLE_RADIAL", [100, 50, 40, 0.1]),
    ("RADIAL", [100, 50, 40, 0.1, -0.02]),
    ("FULL_OPENCV", [100, 110, 50, 40, 0.1, -0.02, 0.001, 0.002, 0.01, 0.0, 0.0, 0.0]),
    ("SIMPLE_RADIAL_FISHEYE", [100, 50, 40, 0.05]),
    ("RADIAL_FISHEYE", [100, 50, 40, 0.05, -0.01]), ("FOV", [100, 110, 50, 40, 0.9]),
])
def test_camera_intrinsics_match_jax(model, params):
    params = np.asarray(params, np.float64)
    ours = port_colmap.camera_intrinsics(port_colmap.Camera(0, model, 100, 80, params))
    ref = jax_colmap.camera_intrinsics(jax_colmap.Camera(0, model, 100, 80, params))
    assert ours == ref
    np.testing.assert_array_equal(port_cam.distortion_from_intrinsics(ours),
                                  jax_cam.distortion_from_intrinsics(ref))


# ------------------------------------------------------- files across packages


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_files_across_packages(tmp_path, writer, binary):
    cameras, images, points = _colmap_model(np.random.default_rng(7))
    write, read = ((port_colmap.write_model, jax_colmap.read_model) if writer == "port"
                   else (jax_colmap.write_model, port_colmap.read_model))
    write(cameras, images, points, tmp_path, binary=binary)
    c2, i2, p2 = read(tmp_path)
    assert c2[1].model == "OPENCV" and (c2[1].width, c2[1].height) == (32, 24)
    np.testing.assert_array_equal(c2[1].params, cameras[1].params)
    for k, im in images.items():
        np.testing.assert_allclose(i2[k].qvec, im.qvec, rtol=1e-15)
        np.testing.assert_allclose(i2[k].tvec, im.tvec, rtol=1e-15)
        assert i2[k].name == im.name
        np.testing.assert_array_equal(i2[k].point3D_ids, im.point3D_ids)
        np.testing.assert_allclose(i2[k].xys, im.xys, rtol=1e-15)
    for k, p in points.items():
        np.testing.assert_allclose(p2[k].xyz, p.xyz, rtol=1e-15)
        np.testing.assert_array_equal(p2[k].rgb, p.rgb)
        np.testing.assert_array_equal(p2[k].image_ids, p.image_ids)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_and_tetrahedra_files_across_packages(tmp_path, writer):
    rng = np.random.default_rng(8)
    pos = rng.normal(size=(50, 3))
    colors = rng.integers(0, 255, (50, 3)).astype(np.uint8)
    cells = rng.integers(0, 50, (30, 4)).astype(np.int32)
    w_ply, r_ply = ((port_ply.write_ply, jax_ply.read_ply) if writer == "port"
                    else (jax_ply.write_ply, port_ply.read_ply))
    w_ply(tmp_path / "a.ply", pos, colors)
    got_pos, got_col = r_ply(tmp_path / "a.ply")
    np.testing.assert_array_equal(got_pos, pos.astype(np.float32).astype(np.float64))
    np.testing.assert_array_equal(got_col, colors)
    for a, b in zip(port_ply.read_ply(tmp_path / "a.ply"), jax_ply.read_ply(tmp_path / "a.ply")):
        np.testing.assert_array_equal(a, b)
    save, load = ((port_io.save_tetrahedra, jax_io.load_tetrahedra) if writer == "port"
                  else (jax_io.save_tetrahedra, port_io.load_tetrahedra))
    for name in ("t.npz", "t.th"):
        save(tmp_path / name, vertices=pos, cells=cells, colors=colors)
        got = load(tmp_path / name)
        want = port_io.load_tetrahedra(tmp_path / name)
        assert got.keys() == want.keys() == {"vertices", "cells", "colors"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["colors"][:, 3], 255)


def test_ascii_ply_read_equal(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                    "property float y\nproperty float z\nproperty uchar red\n"
                    "property uchar green\nproperty uchar blue\nend_header\n"
                    "0 1 2 10 20 30\n3.5 -1 0.25 0 0 255\n1e-3 2 3 1 2 3\n")
    for a, b in zip(port_ply.read_ply(path), jax_ply.read_ply(path)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------- the sphere dataset


def test_sphere_dataset_matches_the_jax_generator(tmp_path, monkeypatch):
    """``utils/synthetic_dataset.py`` against ``benchmarks/make_synthetic_dataset.py``
    at a small size: the same cameras, pixels and tetrahedra."""
    args = dict(side=24, train=3, test=2, points=300)
    write_sphere_dataset(tmp_path / "port", **args)
    script = Path(__file__).resolve().parents[1] / "benchmarks" / "make_synthetic_dataset.py"
    monkeypatch.setattr(sys, "argv", [str(script), "--out", str(tmp_path / "jax")]
                        + [f"--{k}={v}" for k, v in args.items()])
    runpy.run_path(str(script), run_name="__main__")
    for split in ("train", "test"):
        name = f"transforms_{split}.json"
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text())
        _assert_same_dataset(port_ds.load_blender(tmp_path / "port", split),
                             jax_ds.load_blender(tmp_path / "jax", split))
    ours = port_io.load_tetrahedra(tmp_path / "port" / "tetra.npz")
    ref = jax_io.load_tetrahedra(tmp_path / "jax" / "tetra.npz")
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
