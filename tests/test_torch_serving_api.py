"""The port's torch serving API: :class:`TorchRenderAdapter` (bit-equal to
``Trainer.render_rays``, tensors on the input's device, the reference's
state-dict names and layouts against the JAX package's export of the same
numpy parameters), :class:`TetraNerfAdapterModel` (chunk-size independence
and the metric hook, as ``tests/test_nerfstudio_model.py`` holds JAX's),
the nerfstudio entry points' redirect, and :mod:`utils.profiling`."""

import time
import types

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import build_mesh
from tetranerf_torch.models import TetraNerf, tetranerf_preset
from tetranerf_torch.nerfstudio_model import HAVE_NERFSTUDIO, TetraNerfAdapterModel
from tetranerf_torch.torch_adapter import TorchRenderAdapter
from tetranerf_torch.training.checkpoints import params_from_jax
from tetranerf_torch.training.trainer import TrainConfig, Trainer
from tetranerf_torch.utils import profiling
from tetranerf_torch.utils.synthetic import (
    make_sphere_scene,
    sample_sphere_rays,
    sphere_ray_targets,
)

# The flagship preset (8 quantile buckets) narrowed to a 16-wide field.
SMALL = dict(field_dim=16, hidden_size=32, num_samples=12, num_fine_samples=8,
             max_intersected_triangles=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(points, colors, seed=0, **extra):
    mesh = build_mesh(points, device="cpu")
    model = TetraNerf(tetranerf_preset(**SMALL, **extra), mesh.num_vertices, num_train_images=4,
                      point_colors=colors, generator=torch.Generator().manual_seed(seed),
                      device="cpu")
    return Trainer(TrainConfig(), model, mesh, device="cpu")


@pytest.fixture(scope="module")
def scene():
    points, colors = make_sphere_scene(500, seed=3)
    trainer = _trainer(points, colors)
    o, d = sample_sphere_rays(np.random.default_rng(0), 128)
    trainer.train_step({"origins": o, "directions": d, "rgb": sphere_ray_targets(o, d)})
    return types.SimpleNamespace(points=points, colors=colors, trainer=trainer)


def _camera_grid(h=8, w=12):
    """A small pinhole looking at the sphere from +z (``[H, W, 3]`` tensors)."""
    ys, xs = np.meshgrid(np.linspace(-0.4, 0.4, h), np.linspace(-0.55, 0.55, w),
                         indexing="ij")
    dirs = np.stack([xs, ys, -np.ones_like(xs)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(np.array([0.0, 0.0, 2.5]), dirs.shape)
    return (torch.from_numpy(np.ascontiguousarray(origins, np.float32)),
            torch.from_numpy(np.ascontiguousarray(dirs, np.float32)))


def _bit_equal(ours, want):
    assert ours.keys() == want.keys()
    for k in want:
        assert isinstance(ours[k], torch.Tensor)
        assert np.array_equal(ours[k].numpy(), want[k]) and ours[k].numpy().dtype == want[k].dtype, k


@pytest.mark.parametrize("chunk", [48, 8192])
def test_adapter_equals_render_rays(scene, chunk):
    """Every key of ``render_rays``, bit for bit, with a padded tail chunk
    (150 rays in chunks of 48) and in one chunk; tensors and arrays in."""
    o, d = sample_sphere_rays(np.random.default_rng(5), 150)
    want = scene.trainer.render_rays(o, d, chunk=chunk)
    adapter = TorchRenderAdapter(scene.trainer, chunk=chunk)
    _bit_equal(adapter.get_outputs(torch.from_numpy(o), torch.from_numpy(d)), want)
    _bit_equal(adapter.get_outputs(o, d), want)
    assert want["ray_mask"].sum() > 100
    fast = scene.trainer.render_rays(o, d, chunk=chunk, num_samples=16, num_fine_samples=0)
    _bit_equal(adapter.get_outputs(o, d, num_samples=16, num_fine_samples=0), fast)


@pytest.mark.cuda
def test_adapter_cuda_in_cuda_out(scene):
    """CUDA rays give CUDA outputs, bit-equal to ``render_rays`` of a
    trainer on the card; CPU rays into that trainer come back on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trainer's forward runs the port's kernels")
    from tetranerf_torch.ops import cuda

    trainer = _trainer(scene.points, scene.colors)
    trainer.model.load_state_dict(scene.trainer.model.state_dict())
    card = Trainer(TrainConfig(), trainer.model, trainer.mesh, device="cuda")
    card.tuned_max_steps = scene.trainer.tuned_max_steps
    card.tuned_bucket_steps = scene.trainer.tuned_bucket_steps
    o, d = (torch.from_numpy(x) for x in sample_sphere_rays(np.random.default_rng(5), 150))
    adapter = TorchRenderAdapter(card, chunk=64)
    cuda.reset_launch_counts()
    out = adapter.get_outputs(o.cuda(), d.cuda())
    assert cuda.launch_counts["march"] > 0
    want = card.render_rays(o, d, chunk=64)
    for k in want:
        assert out[k].device.type == "cuda"
        assert np.array_equal(out[k].cpu().numpy(), want[k]), k
    assert all(v.device.type == "cpu" for v in adapter.get_outputs(o, d).values())


def test_render_image_shapes_and_bad_shapes(scene):
    o, d = _camera_grid()
    adapter = TorchRenderAdapter(scene.trainer, chunk=40)
    img = adapter.render_image(o, d)
    assert img["rgb"].shape == (8, 12, 3) and img["depth"].shape == (8, 12, 1)
    assert img["accumulation"].shape == (8, 12, 1) and img["ray_mask"].shape == (8, 12)
    flat = scene.trainer.render_rays(o.reshape(-1, 3), d.reshape(-1, 3), chunk=40)
    assert np.array_equal(img["rgb"].reshape(-1, 3).numpy(), flat["rgb"])
    for bad_o, bad_d in ((o.reshape(-1, 3), d.reshape(-1, 3)),
                         (o[..., :2], d[..., :2]), (o, d[:4])):
        with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
            adapter.render_image(bad_o, bad_d)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        adapter.get_outputs(o, d)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        adapter.get_outputs(o.reshape(-1, 3), d.reshape(-1, 3)[:5])


def _numpy_params(model, seed):
    """A JAX-layout parameter tree (``[in, out]`` kernels, ``[V, F]`` field)
    of ``model``'s shapes, drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        return rng.normal(size=shape).astype(np.float32)

    def dense(layer):
        return {"kernel": draw(tuple(layer.weight.shape[::-1])),
                "bias": draw(tuple(layer.bias.shape))}

    return {
        "tetrahedra_field": draw(tuple(model.tetrahedra_field.shape)),
        "mlp_base": [dense(layer) for layer in model.mlp_base.layers],
        "mlp_head": [dense(layer) for layer in model.mlp_head.layers],
        "field_output_color": dense(model.field_output_color),
        "field_output_density": dense(model.field_output_density),
        "appearance_embedding": draw(tuple(model.appearance_embedding.shape)),
    }


def test_state_dict_is_the_jax_export_and_round_trips(scene):
    """``state_dict`` of numpy parameters loaded with ``params_from_jax`` is
    JAX's ``reference_state_dict`` of the same parameters, name for name and
    bit for bit; loaded into a second trainer (and into JAX's tree) it
    renders, and exports, the same."""
    from tetranerf_tpu.training.checkpoints import load_reference_state_dict as jax_load
    from tetranerf_tpu.training.checkpoints import reference_state_dict as jax_export

    source = _trainer(scene.points, scene.colors, seed=1, appearance_embed_dim=4)
    params = _numpy_params(source.model, seed=7)
    params_from_jax(source.model, params)
    state = TorchRenderAdapter(source).state_dict()
    want = jax_export(params)
    assert list(state) == list(want)
    for k in want:
        assert state[k].dtype == torch.float32 and state[k].device.type == "cpu"
        assert np.array_equal(state[k].numpy(), want[k]), k
    assert tuple(state["tetrahedra_field"].shape) == (16, len(scene.points))
    assert tuple(state["appearance_embedding.weight"].shape) == (4, 4)

    copy = _trainer(scene.points, scene.colors, seed=2, appearance_embed_dim=4)
    TorchRenderAdapter(copy).load_state_dict(state)
    o, d = sample_sphere_rays(np.random.default_rng(6), 64)
    a, b = source.render_rays(o, d, chunk=64), copy.render_rays(o, d, chunk=64)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    back = jax_load({k: v for k, v in params.items()},
                    {k: v.numpy() for k, v in TorchRenderAdapter(copy).state_dict().items()})
    for k, v in jax_export(back).items():
        assert np.array_equal(np.asarray(v), want[k]), k


def test_adapter_model_is_independent_of_its_chunk(scene):
    """nerfstudio's chunk loop adds nothing: at chunks of 7 and 4096 the
    image is ``render_rays`` at that chunk, bit for bit, shaped like the
    bundle. With ``ray_buckets=1`` (one bound, one sample budget for every
    ray) the two chunks give the same image to 1e-5 (another chunk size
    changes the padded GEMMs). Quantile buckets rank the rays within a
    chunk, so there a ray's budget can depend on the chunk."""
    o, d = _camera_grid()
    bundle = types.SimpleNamespace(origins=o, directions=d)
    plain = _trainer(scene.points, scene.colors, ray_buckets=1)
    plain.model.load_state_dict(scene.trainer.model.state_dict())
    for trainer in (scene.trainer, plain):
        outs = []
        for chunk in (7, 4096):
            out = TetraNerfAdapterModel(trainer, chunk=chunk).get_outputs_for_camera_ray_bundle(
                bundle)
            assert out["rgb"].shape == (8, 12, 3) and out["depth"].shape == (8, 12, 1)
            flat = {k: v.reshape(96, *v.shape[2:]) for k, v in out.items()}
            _bit_equal(flat, trainer.render_rays(o.reshape(-1, 3), d.reshape(-1, 3),
                                                 chunk=chunk))
            outs.append(out)
    for k in outs[0]:
        np.testing.assert_allclose(outs[0][k].numpy().astype(np.float64),
                                   outs[1][k].numpy().astype(np.float64), atol=1e-5,
                                   rtol=0, err_msg=k)
    one = TetraNerfAdapterModel(plain, chunk=4096).get_outputs(bundle)
    assert np.array_equal(one["rgb"].numpy(), outs[1]["rgb"].numpy())


def test_adapter_model_metrics_hook_matches_jax_metrics(scene):
    """``get_image_metrics_and_images``: the port's metrics of the render
    against a noisy target, within 1e-5 of JAX's ``compute_image_metrics``
    on the same arrays, ``nerfstudio_ssim`` = ``mipnerf_ssim``, the images
    side by side; the training hooks refused."""
    from tetranerf_tpu.training.metrics import compute_image_metrics as jax_metrics

    model = TetraNerfAdapterModel(scene.trainer, chunk=64)
    o, d = _camera_grid(40, 40)
    out = model.get_outputs_for_camera_ray_bundle(types.SimpleNamespace(origins=o,
                                                                        directions=d))
    noise = np.random.default_rng(2).normal(scale=0.05, size=out["rgb"].shape)
    target = torch.from_numpy(np.clip(out["rgb"].numpy() + noise, 0, 1).astype(np.float32))
    metrics, images = model.get_image_metrics_and_images(out, {"image": target})
    want = jax_metrics(out["rgb"].numpy(), target.numpy())
    for k in ("psnr", "mipnerf_ssim", "skimage_ssim"):
        assert abs(metrics[k] - float(want[k])) <= 1e-5, k
    assert metrics["nerfstudio_ssim"] == metrics["mipnerf_ssim"]
    assert 10.0 < metrics["psnr"] < 60.0
    same, _ = model.get_image_metrics_and_images(out, {"image": out["rgb"].clone()})
    assert same["psnr"] > 100.0 and abs(same["mipnerf_ssim"] - 1.0) < 1e-9
    assert images["img"].shape == (40, 80, 3)
    assert model.get_param_groups() == {}
    with pytest.raises(RuntimeError, match="render-only"):
        model.get_loss_dict(out, {})
    assert HAVE_NERFSTUDIO in (True, False)


@pytest.mark.parametrize("factory", ["tetranerf", "tetranerf_original"])
def test_nerfstudio_entry_points_send_to_the_port_trainer(factory):
    """Without nerfstudio each factory raises ``ImportError`` whose message
    is the redirect to ``tetranerf-torch-train`` with the port's preset
    name, where JAX's names ``tetranerf-train``."""
    from tetranerf_tpu import nerfstudio_compat as jax_compat

    from tetranerf_torch import nerfstudio_compat

    name = {"tetranerf": "tetra-nerf", "tetranerf_original": "tetra-nerf-original"}[factory]
    if HAVE_NERFSTUDIO:
        spec = getattr(nerfstudio_compat, factory)()
        assert spec.config.method_name == name
        with pytest.raises(RuntimeError, match="tetranerf-torch-train"):
            spec.config.setup()
        return
    with pytest.raises(ImportError, match=f"tetranerf-torch-train --method {name} ") as ours:
        getattr(nerfstudio_compat, factory)()
    with pytest.raises(ImportError, match=f"tetranerf-train --method {name} ") as ref:
        getattr(jax_compat, factory)()
    assert "nerfstudio import failed" in str(ours.value)
    assert "tetranerf_torch" not in str(ref.value)


def test_benchmark_and_trace_on_the_cpu(tmp_path):
    """``benchmark``: steady-state seconds per call, the best of the repeats
    over ``min_dispatches`` calls cycled through the arguments; ``trace``
    writes a Chrome trace of the block."""
    calls = []

    def fn(ms):
        calls.append(ms)
        time.sleep(ms / 1e3)

    sec = profiling.benchmark(fn, [(2.0,), (4.0,)], warmup=1, repeats=2, min_dispatches=4)
    assert len(calls) == 2 + 2 * 4
    assert 3e-3 <= sec < 3e-3 + 5e-3  # the mean of 2 and 4 ms, plus the host's overhead
    assert profiling.benchmark(fn, [(1.0,)], host_overhead=1.0, repeats=1,
                               min_dispatches=1) < 0
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "prof" / profiling.TRACE_FILE).read_text()
    assert "traceEvents" in text and "aten::mm" in text
