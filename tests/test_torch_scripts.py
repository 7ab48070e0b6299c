"""The port's preprocessing CLIs and helpers against the JAX package's:
``triangulate_pointcloud`` and ``tetranerf-torch-triangulate`` (files equal
to JAX's, array for array), ``find_average_spacing`` (JAX's KD-tree path),
the Blender, NSVF and Mip-NeRF 360 converters, the minimal-npz export, the
COLMAP database, the binary gating and the header image-size reader, each
on inputs made from a seed."""

import json
import sqlite3
import sys

import numpy as np
import pytest
from PIL import Image

from tetranerf_torch.geometry import find_average_spacing, load_tetrahedra, write_ply
from tetranerf_torch.scripts import common
from tetranerf_torch.scripts.process_blender import blender_to_colmap
from tetranerf_torch.scripts.process_tanksandtemples import read_nsvf
from tetranerf_torch.scripts.triangulate import main as triangulate_main
from tetranerf_torch.scripts.triangulate import triangulate_pointcloud
from tetranerf_torch.training.datasets import load_minimal_npz
from tetranerf_torch.utils import colmap as cm
from tetranerf_torch.utils.png import image_size


@pytest.fixture(autouse=True)
def _kd_tree_spacing(monkeypatch):
    """Both packages' spacing takes their native library where it is
    available, whose f32 distances are not the KD-tree's bits: hold both
    to their KD-tree paths, so the files compare bit for bit."""
    monkeypatch.setattr("tetranerf_tpu.geometry.native.available", lambda: False)
    monkeypatch.setattr("tetranerf_torch.geometry.native.available", lambda: False)


def _cloud(n=300, seed=5):
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(n, 3)) * 0.5
    colors = rng.integers(0, 256, size=(n, 3), dtype=np.uint8)
    return points, colors


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kwargs", [
    {}, {"random_points_ratio": 0.5}, {"random_points_ratio": 0.5, "use_gaussian": True},
    {"max_pointcloud_size": 200, "random_points_ratio": 0.25}, {"colorless": True},
], ids=["plain", "shell", "gaussian", "subsample", "colorless"])
def test_triangulate_pointcloud_matches_jax(kwargs):
    from tetranerf_tpu.scripts.triangulate import triangulate_pointcloud as jax_tri

    kwargs = dict(kwargs)
    points, colors = _cloud()
    if kwargs.pop("colorless", False):
        colors = None
    ours = triangulate_pointcloud(points, colors, seed=3, **kwargs)
    ref = jax_tri(points, colors, seed=3, **kwargs)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ratio = kwargs.get("random_points_ratio", 0.0)
    num = min(len(points), kwargs.get("max_pointcloud_size", len(points)))
    assert len(ours[0]) == num + int(num * ratio) and ours[2].shape == (len(ours[0]), 4)


@pytest.mark.parametrize("suffix, flags", [
    (".th", []), (".npz", ["--random-points-ratio", "0.5"]),
    (".th", ["--max-pointcloud-size", "200", "--random-points-ratio", "1.0",
             "--use-gaussian", "--seed", "9"]),
], ids=["th", "npz-random", "th-subsample"])
def test_triangulate_cli_writes_the_jax_file(tmp_path, suffix, flags):
    from tetranerf_tpu.geometry import load_tetrahedra as jax_load
    from tetranerf_tpu.scripts.triangulate import main as jax_main

    points, colors = _cloud()
    ply = tmp_path / "cloud.ply"
    write_ply(ply, points, colors)
    outs = {}
    for name, run in (("port", triangulate_main), ("jax", jax_main)):
        outs[name] = tmp_path / name / f"tetra{suffix}"
        outs[name].parent.mkdir()
        run(["--pointcloud", str(ply), "--output", str(outs[name])] + flags)
    ours = load_tetrahedra(outs["port"])
    _assert_same(ours, jax_load(outs["jax"]))
    _assert_same(ours, load_tetrahedra(outs["jax"]))
    assert ours["cells"].max() == len(ours["vertices"]) - 1


@pytest.mark.parametrize("num_neighbors", [1, 6])
def test_find_average_spacing_matches_jax(num_neighbors):
    from tetranerf_tpu.geometry import find_average_spacing as jax_spacing

    points, _ = _cloud(500, seed=11)
    ours = find_average_spacing(points, num_neighbors)
    assert ours == jax_spacing(points, num_neighbors) and ours > 0


def _blender_dir(root, ext):
    rng = np.random.default_rng(2)
    (root / "train").mkdir()
    frames = []
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        c2w[:3, 3] = rng.normal(size=3)
        Image.fromarray(rng.integers(0, 255, (10, 14, 3), dtype=np.uint8)).save(
            root / "train" / f"r_{i}{ext}")
        frames.append({"file_path": f"./train/r_{i}" + ("" if ext == ".png" else ext),
                       "transform_matrix": c2w.tolist()})
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


def _same_fields(a, b):
    for k in a.__dataclass_fields__:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_blender_to_colmap_matches_jax(tmp_path, ext):
    from tetranerf_tpu.scripts.process_blender import blender_to_colmap as jax_b2c

    _blender_dir(tmp_path, ext)
    cams, ims = blender_to_colmap(tmp_path)
    jcams, jims = jax_b2c(tmp_path)
    assert cams.keys() == jcams.keys() and ims.keys() == jims.keys()
    for k in cams:
        _same_fields(cams[k], jcams[k])
    for k in ims:
        _same_fields(ims[k], jims[k])
    assert (cams[1].width, cams[1].height) == (14, 10)


def _nsvf_dir(root, rng):
    (root / "rgb").mkdir()
    (root / "pose").mkdir()
    np.savetxt(root / "intrinsics.txt",
               np.array([[100.0, 0, 4, 0], [0, 90.0, 5, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    for i, prefix in enumerate(["0_a", "0_b", "1_c", "0_d", "1_e"]):
        Image.fromarray(rng.integers(0, 255, (8, 12, 3), dtype=np.uint8)).save(
            root / "rgb" / f"{prefix}.png")
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3) + [0, 0, 3 + i]
        np.savetxt(root / "pose" / f"{prefix}.txt", pose)


def _npz_equal(a, b):
    with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
        assert x.files == y.files
        for k in x.files:
            u, v = x[k], y[k]
            if u.dtype == object:  # the cameras dict
                u, v = u.item(), v.item()
                assert u.keys() == v.keys()
                for c in u:
                    assert np.array_equal(u[c], v[c]) and u[c].dtype == v[c].dtype, c
            else:
                assert np.array_equal(u, v) and u.dtype == v.dtype, k


def test_read_nsvf_and_the_tanksandtemples_cli_match_jax(tmp_path):
    from tetranerf_tpu.scripts import process_tanksandtemples as jax_tt

    from tetranerf_torch.scripts import process_tanksandtemples as tt

    data = tmp_path / "scene"
    data.mkdir()
    _nsvf_dir(data, np.random.default_rng(4))
    intr, entries = read_nsvf(data)
    jintr, jentries = jax_tt.read_nsvf(data)
    assert intr == jintr and len(entries) == len(jentries) == 5
    for (p, c, s), (jp, jc, js) in zip(entries, jentries):
        assert (p, s) == (jp, js) and np.array_equal(c, jc)
    tt.main(["--data", str(data), "--output", str(tmp_path / "port")])
    jax_tt.main(["--data", str(data), "--output", str(tmp_path / "jax")])
    for split in ("train", "val", "test"):
        _npz_equal(tmp_path / "port" / f"{split}.npz", tmp_path / "jax" / f"{split}.npz")
    train = load_minimal_npz(tmp_path / "port" / "train.npz")
    assert (train.num_images, train.width, train.height) == (3, 12, 8)


def test_export_minimal_npz_matches_jax(tmp_path):
    from tetranerf_tpu.scripts import common as jax_common

    rng = np.random.default_rng(6)
    names = []
    for i in range(9):
        p = tmp_path / f"im_{i}.png"
        Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(p)
        names.append(str(p))
    c2ws = rng.normal(size=(9, 3, 4))
    transform = rng.normal(size=(3, 4))
    args = (names, c2ws, {"fx": 10.0, "fy": 11.0, "cx": 4.0, "cy": 3.5}, 8, 8)
    kw = dict(eval_interval=4, applied_transform=transform, applied_scale=0.5)
    common.export_minimal_npz(tmp_path / "port", *args, **kw)
    jax_common.export_minimal_npz(tmp_path / "jax", *args, **kw)
    for split in ("train", "val", "test"):
        _npz_equal(tmp_path / "port" / f"{split}.npz", tmp_path / "jax" / f"{split}.npz")
    train = load_minimal_npz(tmp_path / "port" / "train.npz")
    test = load_minimal_npz(tmp_path / "port" / "test.npz")
    assert (train.num_images, test.num_images, train.dataparser_scale) == (6, 3, 0.5)
    np.testing.assert_array_equal(train.images[0],
                                  np.asarray(Image.open(names[1]), np.float32) / 255.0)


def _rows(path):
    db = sqlite3.connect(str(path))
    try:
        return {t: db.execute(f"SELECT * FROM {t}").fetchall()
                for t in ("cameras", "images", "keypoints", "matches")}
    finally:
        db.close()


def test_colmap_database_rows_match_jax(tmp_path):
    from tetranerf_tpu.scripts import common as jax_common
    from tetranerf_tpu.utils import colmap as jax_cm

    params = np.array([10.0, 11, 4, 3.5])
    names = {1: "a.png", 2: "b.png", 5: "c.png"}
    common.create_colmap_database(
        tmp_path / "port.db", {1: cm.Camera(1, "PINHOLE", 8, 7, params)}, names)
    jax_common.create_colmap_database(
        tmp_path / "jax.db", {1: jax_cm.Camera(1, "PINHOLE", 8, 7, params)}, names)
    ours = _rows(tmp_path / "port.db")
    assert ours == _rows(tmp_path / "jax.db")
    assert ours["cameras"][0][:4] == (1, 1, 8, 7) and len(ours["images"]) == 3


def test_mipnerf360_cli_matches_jax(tmp_path):
    """A Mip-NeRF 360 scene's COLMAP model (written here) through both CLIs:
    the npz splits and ``sparse.ply`` equal."""
    from tetranerf_tpu.geometry import read_ply as jax_read_ply
    from tetranerf_tpu.scripts.process_mipnerf360 import main as jax_main

    from tetranerf_torch.geometry import read_ply
    from tetranerf_torch.scripts.process_mipnerf360 import main

    rng = np.random.default_rng(8)
    data = tmp_path / "garden"
    (data / "images_2").mkdir(parents=True)
    cameras = {1: cm.Camera(1, "PINHOLE", 16, 12, np.array([20.0, 21, 8, 6]))}
    images, points = {}, {}
    for i in range(10):
        q = rng.normal(size=4)
        images[i + 1] = cm.Image(i + 1, q / np.linalg.norm(q), rng.normal(size=3), 1,
                                 f"im_{i:02d}.png", np.zeros((0, 2)),
                                 np.zeros((0,), np.int64))
    for j in range(20):
        points[j + 1] = cm.Point3D(j + 1, rng.normal(size=3),
                                   rng.integers(0, 256, 3).astype(np.uint8), 0.5,
                                   np.zeros(0, np.int32), np.zeros(0, np.int32))
    cm.write_model(cameras, images, points, data / "sparse" / "0")
    for name, run in (("port", main), ("jax", jax_main)):
        run(["--data", str(data), "--output", str(tmp_path / name), "--downscale", "2"])
    for split in ("train", "val", "test"):
        _npz_equal(tmp_path / "port" / f"{split}.npz", tmp_path / "jax" / f"{split}.npz")
    ours, ref = read_ply(tmp_path / "port" / "sparse.ply"), jax_read_ply(
        tmp_path / "jax" / "sparse.ply")
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)
    assert len(ours[0]) == 20


def test_binaries_are_required_as_jax_requires_them(monkeypatch, tmp_path):
    """Without colmap on PATH each COLMAP step exits naming it, as JAX's;
    downscaling without ffmpeg exits naming both ffmpeg and Pillow when
    Pillow does not import either."""
    from tetranerf_tpu.scripts import common as jax_common

    monkeypatch.setattr("shutil.which", lambda name: None)
    for mod in (common, jax_common):
        with pytest.raises(SystemExit, match="`colmap` binary not found"):
            mod.require_binary("colmap")
        with pytest.raises(SystemExit, match="`ffmpeg` binary not found"):
            mod.extract_video_frames(tmp_path / "v.mp4", tmp_path / "frames")
        with pytest.raises(SystemExit, match="colmap"):
            mod.colmap_sfm(tmp_path / "images", tmp_path / "ws")
    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(np.zeros((16, 24, 3), np.uint8)).save(src / "im.png")
    # Pillow present: both resample the same way.
    common.downscale_images(src, tmp_path / "port", 2, verbose=False)
    jax_common.downscale_images(src, tmp_path / "jax", 2, verbose=False)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / "im.png")),
                          np.asarray(Image.open(tmp_path / "jax" / "im.png")))
    assert image_size(tmp_path / "port" / "im.png") == (12, 8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="ffmpeg.*Pillow"):
        common.downscale_images(src, tmp_path / "none", 2)


@pytest.mark.parametrize("argv, match", [
    ([], "exactly one"), (["--images", "a", "--video", "b"], "exactly one"),
])
def test_process_images_checks_its_arguments(tmp_path, argv, match):
    from tetranerf_tpu.scripts.process_images import main as jax_main

    from tetranerf_torch.scripts.process_images import main

    for run in (main, jax_main):
        with pytest.raises(SystemExit, match=match):
            run(["--output", str(tmp_path / "out")] + argv)


@pytest.mark.parametrize("fmt, options", [
    ("PNG", {}), ("PNG", {"mode": "RGBA"}), ("PNG", {"mode": "L"}),
    ("JPEG", {}), ("JPEG", {"progressive": True}), ("JPEG", {"mode": "L"}),
], ids=["png", "png-rgba", "png-gray", "jpeg", "jpeg-progressive", "jpeg-gray"])
def test_image_size_reads_the_header_as_pillow_does(tmp_path, fmt, options):
    options = dict(options)
    mode = options.pop("mode", "RGB")
    rng = np.random.default_rng(1)
    for h, w in ((1, 1), (37, 53), (300, 17)):
        path = tmp_path / f"im_{h}_{w}.{fmt.lower()}"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).convert(mode).save(
            path, fmt, **options)
        assert image_size(path) == Image.open(path).size == (w, h)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image_size(bad)
