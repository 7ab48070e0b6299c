"""The port's training loop against the JAX package's: ``Trainer.fit`` over
20 steps of a narrowed preset fed the port's dataset (the losses, and the
steps of the log lines, evals and checkpoints), the producer thread, and
checkpoints: save and restore, and a resumed run's occupancy cadence
against JAX's."""

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


def test_resume_times_occupancy_work_as_jax(scene, tmp_path):
    """A port trainer and a JAX trainer, each restored at step 12 from the
    same parameters, optimizer moments and occupancy EMA, step through
    steps 12-18 with the JAX step's random numbers. JAX times the occupancy
    update by the steps the trainer has taken since it was built, so both
    update at step 12 (the port's ``self.step`` would have put it at step
    16, on another batch): losses within rtol 1e-4, and the EMA after, as
    ``test_eight_train_steps_match_jax_trainer`` holds it."""
    import jax
    import jax.numpy as jnp
    import optax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.checkpoints import save_checkpoint as jax_save
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    start, num_steps = 12, 7
    jcfg, cfg = _configs("float32", ray_buckets=2)
    assert cfg.occupancy_update_every == 16
    jmesh = jax_build_mesh(scene["points"], scene["cells"])
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh),
                          point_colors=scene["colors"], mesh_devices=1)
    centroids = np.asarray(jmesh.vertices)[np.asarray(jmesh.cells)].mean(axis=1)
    occ = np.where(np.linalg.norm(centroids, axis=1) > 0.85, 30.0, 0.0).astype(np.float32)
    # Step 12 with the moments still zero: optax's count and the step agree.
    state = jtrainer.state.replace(
        step=jnp.asarray(start, jtrainer.state.step.dtype),
        opt_state=optax.tree_utils.tree_set(jtrainer.state.opt_state,
                                            count=jnp.asarray(start, jnp.int32)))
    jax_save(str(tmp_path / "jax"), state)
    np.save(tmp_path / "jax" / "occupancy.npy", occ)
    jtrainer.restore_checkpoint(str(tmp_path / "jax"))
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)

    src = Trainer(TrainConfig(), TetraNerf(cfg, jmesh.num_vertices, device="cpu"),
                  TorchMesh.from_tables(jmesh, device="cpu"), device="cpu")
    params_from_jax(src.model, params)
    src.step = start
    for p in src.model.parameters():
        src.optimizer.state[p] = {"step": torch.tensor(float(start)),
                                  "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": torch.zeros_like(p)}
    src.occupancy = torch.from_numpy(occ)
    src.save_checkpoint(tmp_path / "port")
    trainer = Trainer(TrainConfig(), TetraNerf(cfg, jmesh.num_vertices, device="cpu"),
                      TorchMesh.from_tables(jmesh, device="cpu"), device="cpu")
    trainer.restore_checkpoint(tmp_path / "port")
    assert (trainer.step, trainer._step_count) == (start, 0)

    updates, ref_updates = [], []
    for tr, log, get_step in ((trainer, updates, lambda: trainer.step),
                              (jtrainer, ref_updates, lambda: int(jtrainer.state.step))):
        update = tr.update_occupancy
        tr.update_occupancy = (lambda b, update=update, log=log, get_step=get_step:
                               log.append(get_step()) or update(b))
    draw = _batches(scene["dataset"], seed=5)
    losses, ref_losses = [], []
    for i in range(num_steps):
        batch = draw(i)
        ref_losses.append(float(jtrainer.train_step(batch)["loss"]))
        bounds = (jtrainer.tuned_max_steps or cfg.max_intersected_triangles,
                  jtrainer.tuned_bucket_steps)
        u = _step_uniforms(jax.random.fold_in(jtrainer.train_key, start + i),
                           trainer.model, NUM_RAYS, *bounds)
        losses.append(float(trainer.train_step(batch, uniforms=u)["loss"]))
        assert (trainer.max_steps, trainer.tuned_bucket_steps) == bounds
    assert updates == ref_updates == [start]
    assert trainer.step == int(jtrainer.state.step) == start + num_steps
    assert trainer._step_count == jtrainer._step_count == num_steps
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=0)
    ema, ema_ref = trainer.occupancy.numpy(), np.asarray(jtrainer._occ)
    np.testing.assert_array_equal(ema > 0, ema_ref > 0)
    assert float(np.abs(ema - ema_ref).max() / np.abs(ema_ref).max()) <= 1e-3


def test_restore_leaves_the_step_count_at_zero(scene, tmp_path):
    """The port alone, at the file's cheap size: a trainer restored at step
    12 has taken no step, so its occupancy updates fall on steps 12 and 28;
    the learning rate and random stream keep reading the restored step."""
    first = _small_trainer(scene, auto_tune_steps=False)
    first.fit(_batches(scene["dataset"]), num_iterations=1, log_every=0)
    first.step = 12
    first.save_checkpoint(tmp_path / "mid")
    trainer = _small_trainer(scene, seed=7, auto_tune_steps=False)
    trainer.restore_checkpoint(tmp_path / "mid")
    assert (trainer.step, trainer._step_count) == (12, 0)
    steps = []
    update = trainer.update_occupancy
    trainer.update_occupancy = lambda b: steps.append(trainer.step) or update(b)
    trainer.fit(_batches(scene["dataset"], seed=3), num_iterations=17, log_every=0)
    assert steps == [12, 28]
    assert (trainer.step, trainer._step_count) == (29, 17)
