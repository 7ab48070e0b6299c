"""The port's training CLI against the JAX CLI on the tiny scene of
``tests/test_cli.py``: the same cadence of log and eval lines, the same
final metrics and checkpoint; resume; the flag semantics (alias conflicts,
zero-valued aliases, the missing test split); the flags of code the port
does not have; and the device default. Then the serving entry points on the
run's checkpoint: the render script's files against the JAX script's names
and keys, and the live viewer during ``fit``."""

import json
import re

import numpy as np
import pytest
import torch
from PIL import Image

from tetranerf_torch.geometry import save_tetrahedra, triangulate
from tetranerf_torch.training.cli import _config_from_args, build_parser
from tetranerf_torch.training.cli import main as port_main
from tetranerf_torch.utils.synthetic import make_sphere_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_tiny_scene(root, test_views=4):
    """``tests/test_cli.py``'s scene: 4 cameras, 16x16 random PNGs written by
    Pillow, a 400-point sphere; the test split holds the first
    ``test_views`` of the 4 views."""
    rng = np.random.default_rng(42)
    frames = []
    for i in range(4):
        ang = i * np.pi / 2
        pos = np.array([2.5 * np.cos(ang), 2.5 * np.sin(ang), 0.8])
        forward = -pos / np.linalg.norm(pos)
        right = np.cross(forward, [0.0, 0, 1])
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, pos
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            root / f"r_{i}.png")
        frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
    for split, views in (("train", frames), ("test", frames[:test_views])):
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": views}, f)
    points, colors = make_sphere_scene(400, seed=2)
    save_tetrahedra(root / "tetra.npz", vertices=points, cells=triangulate(points),
                    colors=colors)
    return root


@pytest.fixture()
def tiny_scene_dir(tmp_path):
    return _write_tiny_scene(tmp_path)


def _flags(scene, out, iterations=20):
    """``test_train_cli_end_to_end``'s flags, with cadences that fire."""
    return ["--data", str(scene), "--tetrahedra-path", str(scene / "tetra.npz"),
            "--output-dir", str(out), "--max-num-iterations", str(iterations),
            "--rays-per-batch", "128", "--num-samples", "8", "--num-fine-samples", "8",
            "--max-intersected-triangles", "48", "--field-dim", "8"]


_CADENCE = ["--log-every", "5", "--steps-per-eval-batch", "5",
            "--steps-per-eval-image", "10", "--steps-per-eval-all-images", "20"]
_LINE = re.compile(r"^(step|eval step|eval-image step|eval-all-images step) (\d+)")


def _events(err):
    return [(m.group(1), int(m.group(2)))
            for m in map(_LINE.match, err.splitlines()) if m]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """One port CLI run of 20 steps on the tiny scene with 2 test views (each
    held-out render costs the JAX CLI a second on the CPU), its output
    captured."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("cli")
    scene = _write_tiny_scene(root, test_views=2)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        trainer = port_main(_flags(scene, root / "port") + _CADENCE + ["--device", "cpu"])
    return dict(scene=scene, root=root, trainer=trainer, out=out.getvalue(),
                err=err.getvalue())


def test_cli_matches_the_jax_cli(port_run, tmp_path, capsys):
    from tetranerf_tpu.training.cli import main as jax_main

    jax_main(_flags(port_run["scene"], tmp_path / "jax") + _CADENCE)
    jax_out = capsys.readouterr()
    trainer, root = port_run["trainer"], port_run["root"]
    assert trainer.step == 20 and trainer.device.type == "cpu"
    events = _events(port_run["err"])
    assert events == _events(jax_out.err)
    assert ("eval-image step", 10) in events and ("eval-all-images step", 20) in events
    assert [e for e in events if e[0] == "step"] == [("step", s) for s in (5, 10, 15, 20)]
    assert "LPIPS disabled:" in port_run["err"]
    ours = json.loads(port_run["out"].strip().splitlines()[-1])
    ref = json.loads(jax_out.out.strip().splitlines()[-1])
    assert list(ours) == list(ref) and ours["eval_split"] == ref["eval_split"] == "test"
    assert all(np.isfinite(ours[k]) for k in ("psnr", "mipnerf_ssim", "skimage_ssim"))
    with open(root / "port" / "eval_metrics.json") as f:
        assert json.load(f) == ours
    assert (root / "port" / "final" / "train_config.json").exists()
    assert (tmp_path / "jax" / "final" / "train_config.json").exists()
    with open(root / "port" / "final" / "train_config.json") as f:
        saved = json.load(f)
    assert saved["max_num_iterations"] == 20 and saved["model"]["field_dim"] == 8


def test_cli_resumes_from_a_checkpoint(port_run, tmp_path, capsys):
    """--load-checkpoint restores ``final/``: the step goes on from 20."""
    final = port_run["root"] / "port" / "final"
    resumed = port_main(_flags(port_run["scene"], tmp_path / "b", 2)
                        + ["--device", "cpu", "--load-checkpoint", str(final)])
    assert resumed.step == 22
    assert (tmp_path / "b" / "final" / "state.pt").exists()
    capsys.readouterr()


def test_cli_config_flags(tiny_scene_dir, tmp_path, capsys):
    """The named aliases and the generic --model.* surface reach the model
    config, as ``test_train_cli_config_flags`` holds the JAX CLI."""
    trainer = port_main([
        "--data", str(tiny_scene_dir), "--tetrahedra-path", str(tiny_scene_dir / "tetra.npz"),
        "--output-dir", str(tmp_path / "out"), "--max-num-iterations", "4",
        "--rays-per-batch", "64", "--num-samples", "8", "--num-fine-samples", "0",
        "--max-intersected-triangles", "48", "--field-dim", "8", "--device", "cpu",
        "--ray-buckets", "2", "--occupancy-threshold", "0.001", "--interp-mode", "matmul",
        "--retune-percentile", "95", "--model.hidden-size", "16",
        "--model.occupancy-decay", "0.9", "--model.bucket-adaptive-samples", "false",
        "--model.depth-method", "expected"])
    cfg = trainer.model.config
    assert (cfg.ray_buckets, cfg.occupancy_threshold, cfg.interp_mode) == (2, 0.001, "matmul")
    assert cfg.occupancy_retune_percentile == 95.0 and cfg.hidden_size == 16
    assert cfg.occupancy_decay == 0.9 and cfg.bucket_adaptive_samples is False
    assert cfg.depth_method == "expected" and cfg.num_fine_samples == 0
    with open(tmp_path / "out" / "eval_metrics.json") as f:
        assert json.load(f)["eval_split"] == "test"
    capsys.readouterr()


@pytest.mark.parametrize("flags", [
    ["--ray-buckets", "2", "--model.ray-buckets", "4"],
    ["--num-fine-samples", "0", "--model.num-fine-samples", "8"],  # a zero alias is set
    ["--skip-grid", "0", "--model.skip-grid-resolution", "0"],
    ["--no-occupancy", "--model.use-occupancy-field", "false"],
], ids=["value", "zero", "zero-skip-grid", "store-true"])
def test_alias_conflicts_exit_as_in_jax(tmp_path, flags):
    from tetranerf_tpu.training.cli import main as jax_main

    base = ["--data", str(tmp_path / "nowhere"), "--output-dir", str(tmp_path / "o")]
    with pytest.raises(SystemExit, match="conflicting flags") as ref:
        jax_main(base + flags)
    with pytest.raises(SystemExit, match="conflicting flags") as ours:
        port_main(base + flags + ["--device", "cpu"])
    assert str(ours.value) == str(ref.value)


def test_zero_valued_aliases_and_model_flags_apply():
    parser = build_parser()
    for flags in (["--num-fine-samples", "0"], ["--model.num-fine-samples", "0"]):
        config = _config_from_args(parser.parse_args(["--data", "d"] + flags))
        assert config.model.num_fine_samples == 0
    config = _config_from_args(parser.parse_args(["--data", "d", "--skip-grid", "0"]))
    assert config.model.skip_grid_resolution == 0
    assert config.model.ray_buckets == 8 and config.method_name == "tetra-nerf"
    original = _config_from_args(parser.parse_args(["--data", "d", "--method",
                                                    "tetra-nerf-original"]))
    assert original.model.num_samples == 256 and not original.model.use_occupancy_field


def test_missing_test_split(tiny_scene_dir, tmp_path, capsys):
    """Aborts unless --allow-eval-on-train, which tags the metrics."""
    (tiny_scene_dir / "transforms_test.json").unlink()

    def flags(out):
        return ["--data", str(tiny_scene_dir), "--tetrahedra-path",
                str(tiny_scene_dir / "tetra.npz"), "--output-dir", str(tmp_path / out),
                "--max-num-iterations", "2", "--rays-per-batch", "64", "--num-samples", "8",
                "--num-fine-samples", "0", "--max-intersected-triangles", "48",
                "--field-dim", "8", "--device", "cpu"]

    with pytest.raises(SystemExit, match="allow-eval-on-train"):
        port_main(flags("out3"))
    port_main(flags("out4") + ["--allow-eval-on-train"])
    with open(tmp_path / "out4" / "eval_metrics.json") as f:
        assert json.load(f)["eval_split"] == "train"
    assert "NOT held-out" in capsys.readouterr().err


@pytest.mark.parametrize("flags, item", [
    (["--num-model-shards", "2"], "A9b"),
    (["--skip-grid", "16"], "A8"),
    (["--model.skip-grid-resolution", "16"], "A8"),
])
def test_unported_flags_are_refused(tmp_path, monkeypatch, flags, item):
    """A flag of code the port does not have exits naming its ROADMAP item;
    the skip grid's flags (A8, now ported) train a few CPU steps, and the
    grid attaches at the occupancy refresh of step 4. Model shards (A9b,
    now ported) pass the checks under a world of 4 ranks, exit where the
    ranks or the field's width do not divide by them, and with the live
    viewer exit naming A9c."""
    if item == "A9b":
        from tetranerf_torch.training import cli

        def check(extra, world):
            monkeypatch.setenv("RANK", "0")
            monkeypatch.setenv("WORLD_SIZE", str(world))
            args = build_parser().parse_args(["--data", str(tmp_path)] + flags + extra)
            cli._refuse_unported(args, _config_from_args(args))

        check(["--field-dim", "8"], 4)
        assert _config_from_args(build_parser().parse_args(
            ["--data", "d"] + flags)).num_model_shards == 2
        with pytest.raises(SystemExit, match="3 ranks not divisible by model_shards=2"):
            check([], 3)
        with pytest.raises(SystemExit, match="field_dim=9 not divisible by model_shards=2"):
            check(["--field-dim", "9"], 4)
        with pytest.raises(SystemExit, match="ROADMAP A9c"):
            check(["--viewer-port", "0"], 4)
        return
    if item == "A8":
        scene = _write_tiny_scene(tmp_path)
        trainer = port_main(_flags(scene, tmp_path / "out", iterations=6) + flags + [
            "--model.occupancy-refresh-every", "4", "--device", "cpu"])
        assert trainer.step == 6 and trainer.model.config.skip_grid_resolution == 16
        assert tuple(trainer.mesh.skip_table.shape) == (16, 16, 16, 8)
        return
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        port_main(["--data", str(tmp_path), "--device", "cpu"] + flags)


def test_device_defaults_to_the_card(tmp_path):
    import torch

    assert build_parser().parse_args(["--data", "d"]).device == "cuda"
    if not torch.cuda.is_available():
        # No card: exit, never train on the CPU instead.
        with pytest.raises(SystemExit, match="no CUDA device"):
            port_main(["--data", str(tmp_path)])


def test_render_script_writes_the_jax_outputs(port_run, tmp_path, capsys):
    """``scripts.render.main`` on ``final/``: JAX's file names and
    ``metrics.json`` keys; the rgb PNG is ``render_rays`` of a trainer
    restored the same way, to within one 8-bit level."""
    from tetranerf_torch.scripts import render
    from tetranerf_torch.utils.png import read_png
    from tetranerf_tpu.training.metrics import compute_image_metrics

    scene, final = port_run["scene"], port_run["root"] / "port" / "final"
    out = tmp_path / "renders"
    args = ["--checkpoint", str(final), "--data", str(scene), "--tetrahedra-path",
            str(scene / "tetra.npz"), "--output", str(out), "--device", "cpu"]
    mean = render.main(args + ["--max-images", "2"])
    assert sorted(p.name for p in out.iterdir()) == [
        "metrics.json", "test_0000.png", "test_0000_depth.png", "test_0001.png",
        "test_0001_depth.png"]
    img = np.zeros((16, 16, 3), np.float32)
    keys = list(compute_image_metrics(img, img + 0.5)) + ["render_rays_per_sec"]
    with open(out / "metrics.json") as f:
        saved = json.load(f)
    assert list(saved) == keys and saved == mean
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == mean
    assert all(np.isfinite(v) for v in saved.values())
    trainer, dataset = render.load_trainer(final, scene, "test", scene / "tetra.npz",
                                           device="cpu")
    assert trainer.step == 20 and trainer.tuned_max_steps is None
    o, d = dataset.camera_rays(1)
    want = np.clip(trainer.render_rays(o, d, chunk=16384)["rgb"], 0, 1).reshape(16, 16, 3)
    got = read_png(out / "test_0001.png")
    assert np.abs(got.astype(np.float32) - want * 255).max() <= 1.0
    assert read_png(out / "test_0001_depth.png").shape == (16, 16)


def test_viewer_port_serves_during_fit(port_run, tmp_path, monkeypatch, capsys):
    """``--viewer-port 0`` starts the viewer before ``fit``, answers a fast
    frame between two steps, and stops after ``fit``."""
    import urllib.request

    from tetranerf_torch import viewer
    from tetranerf_torch.training.trainer import Trainer

    servers, frames = [], []
    start, train_step = viewer.ViewerServer.start, Trainer.train_step

    def recording_start(self, background=True):
        servers.append(self)
        return start(self, background)

    def step_then_frame(self, batch, uniforms=None):
        metrics = train_step(self, batch, uniforms)
        if self.step == 2:
            req = urllib.request.Request(
                f"http://127.0.0.1:{servers[0].port}/render", method="POST",
                data=json.dumps({"position": [0, 2.5, 0.5], "side": 16}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                frames.append(r.read())
        return metrics

    monkeypatch.setattr(viewer.ViewerServer, "start", recording_start)
    monkeypatch.setattr(Trainer, "train_step", step_then_frame)
    trainer = port_main(_flags(port_run["scene"], tmp_path / "v", 3)
                        + ["--device", "cpu", "--viewer-port", "0"])
    assert trainer.step == 3 and len(servers) == 1 and servers[0]._httpd is None
    assert len(frames) == 1 and frames[0][:4] == b"\x89PNG"
    assert f"live viewer at http://localhost:{servers[0].port}" in capsys.readouterr().err
