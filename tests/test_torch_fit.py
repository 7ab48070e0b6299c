"""The port's training loop against the JAX package's: ``Trainer.fit`` over
20 steps of a narrowed preset fed the port's dataset (the losses, and the
steps of the log lines, evals and checkpoints), the producer thread, and
checkpoints: save and restore, and a resumed run against an unbroken one."""

import os

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh, build_mesh
from tetranerf_torch.models import TetraNerf
from tetranerf_torch.training.checkpoints import params_from_jax, reference_state_dict
from tetranerf_torch.training.datasets import load_blender
from tetranerf_torch.training.trainer import TrainConfig, Trainer
from tetranerf_torch.utils.synthetic import make_sphere_scene
from tetranerf_torch.utils.synthetic_dataset import write_sphere_dataset
from test_torch_train import SMALL, _configs, _step_uniforms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NUM_RAYS = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The 800-point sphere of ``tests/test_torch_train.py`` as a 4 + 2 view
    Blender-format dataset at 24^2, loaded by the port."""
    from tetranerf_torch.geometry import triangulate

    points, colors = make_sphere_scene(800, seed=0)
    cells = triangulate(points)
    root = tmp_path_factory.mktemp("sphere")
    write_sphere_dataset(root, side=24, train=4, test=2, scene=(points, colors, cells))
    return dict(points=points, colors=colors, cells=cells,
                dataset=load_blender(root, "train"))


def _batches(dataset, seed=0):
    rng = np.random.default_rng(seed)
    return lambda _: dataset.sample_ray_batch(rng, NUM_RAYS)


def test_fit_matches_jax_fit(scene, tmp_path):
    """Both ``fit``s from the same weights, on the same batches, with the JAX
    step's random numbers injected into the port's ``train_step`` (drawn
    at the bounds the JAX step shaded at): losses within rtol 1e-4, and the
    log lines, ``eval_fn`` calls and checkpoint directories at the same
    steps."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    loop = dict(steps_per_save=10, output_dir=None)
    jcfg, cfg = _configs("float32", ray_buckets=2)
    jcfg.steps_per_save = 10
    jcfg.output_dir = str(tmp_path / "jax")
    jmesh = jax_build_mesh(scene["points"], scene["cells"])
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh),
                          point_colors=scene["colors"], mesh_devices=1)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)

    bounds, ref_losses = [], []
    jax_step = jtrainer.train_step

    def recorded(batch):
        out = jax_step(batch)
        bounds.append((jtrainer.tuned_max_steps or cfg.max_intersected_triangles,
                       jtrainer.tuned_bucket_steps))
        ref_losses.append(out["loss"])
        return out

    jtrainer.train_step = recorded
    ref_logs, ref_evals = [], []
    jtrainer.fit(_batches(scene["dataset"]), num_iterations=20, log_every=5,
                 log_fn=ref_logs.append, eval_fn=lambda s, tr: ref_evals.append(s),
                 eval_every=10, prefetch=2)

    model = TetraNerf(cfg, jmesh.num_vertices, device="cpu")
    params_from_jax(model, params)
    loop["output_dir"] = str(tmp_path / "port")
    trainer = Trainer(TrainConfig(**loop), model,
                      TorchMesh.from_tables(jmesh, device="cpu"), device="cpu")
    losses = []
    port_step = trainer.train_step

    def injected(batch):
        step = trainer.step
        u = _step_uniforms(jax.random.fold_in(jtrainer.train_key, step), model,
                           NUM_RAYS, *bounds[step])
        out = port_step(batch, uniforms=u)
        assert (trainer.max_steps, trainer.tuned_bucket_steps) == bounds[step]
        losses.append(out["loss"])
        return out

    trainer.train_step = injected
    logs, evals = [], []
    trainer.fit(_batches(scene["dataset"]), num_iterations=20, log_every=5,
                log_fn=logs.append, eval_fn=lambda s, tr: evals.append(s),
                eval_every=10, prefetch=2)

    assert bounds[0][1] is not None  # the two buckets shade at their own bounds
    np.testing.assert_allclose([float(v) for v in losses],
                               [float(v) for v in ref_losses], rtol=1e-4, atol=0)

    def steps(lines):
        return [int(line.split()[1].split("/")[0]) for line in lines]

    assert steps(logs) == steps(ref_logs) == [5, 10, 15, 20]
    assert all(" loss=" in line and " rays/s=" in line for line in logs)
    assert evals == ref_evals == [10, 20]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["step-000000010", "step-000000020"]


def _small_trainer(scene, seed=0, auto_tune_steps=True, **train):
    mesh = build_mesh(scene["points"], scene["cells"], device="cpu")
    cfg = dict(SMALL, ray_buckets=2)
    from tetranerf_torch.models import tetranerf_preset

    model = TetraNerf(tetranerf_preset(**cfg), mesh.num_vertices,
                      point_colors=scene["colors"],
                      generator=torch.Generator().manual_seed(seed), device="cpu")
    return Trainer(TrainConfig(**train), model, mesh, device="cpu",
                   auto_tune_steps=auto_tune_steps)


def test_prefetch_keeps_the_synchronous_loop(scene):
    """``prefetch=0`` and ``prefetch=2`` take the same batches in the same
    order: the same parameters bit for bit."""
    out = []
    for prefetch in (0, 2):
        trainer = _small_trainer(scene)
        calls = []
        draw = _batches(scene["dataset"])

        def next_batch(i):
            calls.append(i)
            return draw(i)

        trainer.fit(next_batch, num_iterations=6, log_every=0, prefetch=prefetch)
        assert calls == list(range(6)) and trainer.step == 6
        out.append(reference_state_dict(trainer.model))
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_raises_what_next_batch_raises(scene, prefetch):
    trainer = _small_trainer(scene)
    draw = _batches(scene["dataset"])

    def next_batch(i):
        if i == 3:
            raise KeyError("no batch 3")
        return draw(i)

    with pytest.raises(KeyError, match="no batch 3"):
        trainer.fit(next_batch, num_iterations=6, log_every=0, prefetch=prefetch)
    assert trainer.step == 3


def _assert_same_state(a: Trainer, b: Trainer):
    ra, rb = reference_state_dict(a.model), reference_state_dict(b.model)
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k, state in sa["state"].items():
        for name, v in state.items():
            np.testing.assert_array_equal(v.numpy(), sb["state"][k][name].numpy())
    assert a.step == b.step
    np.testing.assert_array_equal(a.occupancy.numpy(), b.occupancy.numpy())
    np.testing.assert_array_equal(a.mesh.march_table[:, 24].numpy(),
                                  b.mesh.march_table[:, 24].numpy())


def test_save_and_restore(scene, tmp_path):
    trainer = _small_trainer(scene)
    trainer.fit(_batches(scene["dataset"]), num_iterations=5, log_every=0)
    assert trainer.occupancy is not None and float(trainer.occupancy.max()) > 0
    trainer.save_checkpoint(tmp_path / "ckpt")
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "occupancy.npy", "state.pt", "train_config.json"]
    fresh = _small_trainer(scene, seed=1)
    fresh.restore_checkpoint(tmp_path / "ckpt")
    _assert_same_state(fresh, trainer)
    # As in JAX, the bounds are not saved: the restored trainer tunes anew.
    assert fresh.tuned_max_steps is None and not fresh._tuned


def test_resume_equals_an_unbroken_run(scene, tmp_path):
    """24 steps in one run against 12, save, restore into a fresh trainer,
    12 more (no tune, so that no retune falls in the window; the occupancy
    update at step 16 runs in both)."""
    n = 12
    whole = _small_trainer(scene, auto_tune_steps=False)
    whole.fit(_batches(scene["dataset"]), num_iterations=2 * n, log_every=0)

    first = _small_trainer(scene, auto_tune_steps=False)
    draw = _batches(scene["dataset"])
    first.fit(draw, num_iterations=n, log_every=0)
    first.save_checkpoint(tmp_path / "mid")
    second = _small_trainer(scene, seed=7, auto_tune_steps=False)
    second.restore_checkpoint(tmp_path / "mid")
    assert second.step == n
    second.fit(draw, num_iterations=n, log_every=0)
    assert second.step == whole.step == 2 * n
    assert whole.max_steps == second.max_steps == SMALL["max_intersected_triangles"]
    ours, ref = reference_state_dict(second.model), reference_state_dict(whole.model)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(second.occupancy.numpy(), whole.occupancy.numpy(),
                               atol=1e-6, rtol=0)
