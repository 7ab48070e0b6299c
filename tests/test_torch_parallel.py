"""Training over ranks (``tetranerf_torch.parallel``) on the CPU: ranks
spawned with ``torch.multiprocessing`` over gloo, against the one-process
port trainer and the JAX trainer on the same global batches.

A D-rank step is the one-rank step on the concatenation of the ranks' rows
in rank order (the JAX package's GSPMD contract): the buckets cut the
global sort, the probes gather their statistics, the occupancy update maxes
every rank's rays into one EMA, and the gradients are averaged so that the
ranks' parameters stay bit-equal. With model shards (JAX's ``data x model``
mesh) each rank holds its columns of the field and of RAdam's moments, and
a ``D x M`` step is the same one-rank step."""

import contextlib
import io
import os
import socket

import numpy as np
import pytest
import torch

from tetranerf_torch.geometry import TorchMesh
from tetranerf_torch.models import TetraNerf
from tetranerf_torch.models.tetra_nerf import split_buckets
from tetranerf_torch.parallel import host_batch_slice
from tetranerf_torch.training.checkpoints import params_from_jax
from tetranerf_torch.training.presets import TrainConfig, check_shards
from tetranerf_torch.training.trainer import Trainer
from tetranerf_torch.utils.synthetic import make_sphere_scene
from tetranerf_torch.utils.synthetic import sample_sphere_rays
from test_torch_train import _batch, _configs, _step_uniforms

NUM_RAYS = 64
STEPS = 9
CAP = float(-np.log(1e-4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_steps(job, group=None):
    """The steps of ``job`` on the port's trainer, on this rank's rows of
    every global batch (all of them without a group): losses, the bounds
    and cap after each step, the EMA after each step, the ``# retune@``
    lines and the final parameters and RAdam moments of the field.

    With ``job["save"]`` the trainer then writes a checkpoint there; with
    ``job["restore"]`` it restores one and returns its parameters and
    moments as restored, and the render of ``job["render"]`` rays by the
    ranks that evaluate (all ranks wait for them at a barrier)."""
    model = TetraNerf(job["cfg"], job["mesh"].num_vertices, device="cpu")
    model.load_state_dict(job["state"])
    config = TrainConfig(num_model_shards=job.get("model_shards", 1))
    trainer = Trainer(config, model, job["mesh"], device="cpu", group=group)
    out = {"losses": [], "bounds": [], "occupancy": [], "psnr": [], "overflow": []}
    log = io.StringIO()
    for batch, uniforms in zip(job["batches"], job["uniforms"]):
        if group is not None:
            rows = group.batch_slice(len(batch["origins"]))
            batch = {k: v[rows] for k, v in batch.items()}
        with contextlib.redirect_stderr(log):
            m = trainer.train_step(batch, uniforms=uniforms)
        out["losses"].append(float(m["loss"]))
        out["psnr"].append(float(m["psnr"]))
        out["overflow"].append(int(m["overflow_rays"]))
        out["bounds"].append((trainer.tuned_max_steps, trainer.tuned_bucket_steps,
                              trainer.occ_depth_cap))
        out["occupancy"].append(trainer.occupancy.clone())
    out["retunes"] = [line for line in log.getvalue().splitlines()
                      if line.startswith("# retune@")]
    out["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out["moments"] = _field_moments(trainer)
    if "save" in job:
        trainer.save_checkpoint(job["save"])
    if "restore" in job:
        trainer.restore_checkpoint(job["restore"])
        out["restored"] = (model.tetrahedra_field.detach().clone(), _field_moments(trainer))
        if trainer.evaluates:
            o, d = job["render"]
            out["render"] = trainer.render_rays(o, d, chunk=32)
        if group is not None:
            group.barrier()
    return out


def _field_moments(trainer):
    """RAdam's two moments of the field parameter, as the trainer holds them."""
    state = trainer.optimizer.state[trainer.model.tetrahedra_field]
    return {k: state[k].clone() for k in ("exp_avg", "exp_avg_sq")}


def _rank_main(rank, world, port, job_path, out_dir):
    """A spawned rank: joins the gloo group from torchrun's environment,
    runs :func:`_run_steps` and saves its result."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      GLOO_SOCKET_IFNAME="lo")
    from tetranerf_torch.parallel import destroy, init_distributed

    job = torch.load(job_path, weights_only=False)
    model_shards = job.get("model_shards", 1)
    group = init_distributed("cpu", model_shards=model_shards)
    try:
        assert (group.rank, group.world, group.device.type) == (rank, world, "cpu")
        assert (group.data_index, group.model_index) == divmod(rank, model_shards)
        result = _run_steps(job, group)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy(group)


def _spawn(job, world, tmp_path):
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    torch.multiprocessing.spawn(_rank_main, args=(world, _free_port(), str(job_path),
                                                  str(tmp_path)), nprocs=world)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _reference(widths, steps=STEPS):
    """The set-up of ``tests/test_torch_retune.py``'s nine steps (the
    800-point sphere, four buckets at bound 96, occupancy updated and
    refreshed every 4 steps, the transmittance retune at steps 4 and 8,
    the JAX trainer's parameters with a density bias of 8), at ``widths``
    over ``_configs``' small ones: the JAX trainer's losses, bounds and
    cap, its random numbers per step in the global batch's layout, and the
    job of the port's runs."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    points, colors = make_sphere_scene(800, seed=0)
    jmesh = jax_build_mesh(points)
    jcfg, cfg = _configs("float32", **{
        **dict(ray_buckets=4, max_intersected_triangles=96, occupancy_update_every=4,
               occupancy_refresh_every=4, occupancy_retune_every=4), **widths})
    jtrainer = JaxTrainer(jcfg, JaxTetraNerf(jcfg.model, jmesh), point_colors=colors,
                          mesh_devices=1)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    params["field_output_density"]["bias"] = np.full_like(
        params["field_output_density"]["bias"], 8.0)
    jtrainer.state = jtrainer.state.replace(
        params=jax.device_put(params, jtrainer._params_sharding))
    model = TetraNerf(cfg, jmesh.num_vertices, device="cpu")
    params_from_jax(model, params)
    rng = np.random.default_rng(13)
    batches, uniforms, jax_out = [], [], {"losses": [], "bounds": []}
    for step in range(steps):
        batch = _batch(rng)
        jax_out["losses"].append(float(jtrainer.train_step(batch)["loss"]))
        jax_out["bounds"].append((jtrainer.tuned_max_steps, jtrainer.tuned_bucket_steps,
                                  float(jtrainer._occ_cap)))
        batches.append(batch)
        uniforms.append(_step_uniforms(
            jax.random.fold_in(jtrainer.train_key, step), model, NUM_RAYS,
            jtrainer.tuned_max_steps or cfg.max_intersected_triangles,
            jtrainer.tuned_bucket_steps))
    job = dict(cfg=cfg, mesh=TorchMesh.from_tables(jmesh, device="cpu"),
               state=model.state_dict(), batches=batches, uniforms=uniforms)
    return dict(job=job, jax=jax_out)


@pytest.fixture(scope="module")
def reference():
    """:func:`_reference` at ``_configs``' widths, and the one-process port
    run."""
    ref = _reference({})
    ref["port"] = _run_steps(ref["job"])
    return ref


# JAX's ``test_model_parallel_matches_single_device`` (``tests/
# test_parallel.py``): field 8, hidden 16, 8 samples, no fine round, bound 48,
# f32; here on the trainer of :func:`_reference` (buckets and retunes).
MODEL_SHARD_WIDTHS = dict(field_dim=8, hidden_size=16, num_samples=8, num_fine_samples=0,
                          max_intersected_triangles=48)
MODEL_SHARD_STEPS = 6  # the occupancy update, refresh and retune of step 4 included


@pytest.fixture(scope="module")
def model_reference(tmp_path_factory):
    """:func:`_reference` at JAX's model-parallel test's widths: the
    one-process port run, which writes a checkpoint after its steps, then
    restores it and renders 64 rays."""
    ref = _reference(MODEL_SHARD_WIDTHS, steps=MODEL_SHARD_STEPS)
    ckpt = tmp_path_factory.mktemp("one_process") / "ckpt"
    o, d = sample_sphere_rays(np.random.default_rng(21), 64)
    ref["job"]["render"] = (o, d)
    ref["port"] = _run_steps(dict(ref["job"], save=str(ckpt), restore=str(ckpt)))
    ref["ckpt"] = ckpt
    return ref


# ------------------------------------------------------------ the tests


@pytest.mark.parametrize("size, world", [(4096, 1), (4096, 2), (4096, 8), (64, 4),
                                         (10, 3)])
def test_host_batch_slice_matches_jax(size, world):
    from tetranerf_tpu.parallel.sharding import host_batch_slice as jax_slice

    if size % world:
        with pytest.raises(ValueError, match="not divisible"):
            host_batch_slice(size, 0, world)
        with pytest.raises(ValueError, match="not divisible"):
            jax_slice(size, 0, world)
        return
    for rank in range(world):
        assert host_batch_slice(size, rank, world) == jax_slice(size, rank, world)


def test_global_bucket_split_is_the_stable_sort_of_the_concatenation():
    """Two ranks' crossing counts, with ties across ranks and a deepest
    bucket that rank 0 does not reach: each rank's buckets hold exactly its
    rays of the global stable sort's chunks, in that order."""
    rng = np.random.default_rng(0)
    num_local, k_buckets = 40, 4
    nv0 = rng.integers(0, 12, num_local)        # shallow rays only
    nv1 = rng.integers(5, 40, num_local)        # ties with rank 0 at 5..11
    nv = torch.from_numpy(np.concatenate([nv0, nv1]).astype(np.int32))
    order_g = np.argsort(nv.numpy(), kind="stable")
    plan = [(k, len(nv) * k // k_buckets, len(nv) * (k + 1) // k_buckets, 16, 8, 8)
            for k in range(k_buckets)]
    seen = np.zeros(len(nv), int)
    for rank in range(2):
        order, local_plan, positions = split_buckets(nv, rank, num_local, plan)
        assert sorted(order.tolist()) == list(range(num_local))
        for (k, lo, hi, *rest), (k2, a, b, *rest2), pos in zip(plan, local_plan, positions):
            assert (k, rest) == (k2, rest2)
            pos = pos.numpy()
            assert np.all((pos >= lo) & (pos < hi)) and np.all(np.diff(pos) > 0)
            # The rank's rays of the global chunk, in the global sort's order.
            expect = [p for p in range(lo, hi) if order_g[p] // num_local == rank]
            assert pos.tolist() == expect
            assert (order[a:b].numpy() + rank * num_local).tolist() == order_g[pos].tolist()
            seen[pos] += 1
        if rank == 0:
            assert local_plan[-1][1] == local_plan[-1][2] == num_local  # empty
    assert np.all(seen == 1)


def test_one_rank_group_is_bit_equal_to_no_group(reference, tmp_path):
    """One gloo rank runs the group path (the gathers, the global split, the
    uniforms' row selection, the gradient all-reduce) and gives the
    one-process run's bits."""
    (one,) = _spawn(reference["job"], 1, tmp_path)
    port = reference["port"]
    assert one["losses"] == port["losses"] and one["psnr"] == port["psnr"]
    assert one["bounds"] == port["bounds"] and one["retunes"] == port["retunes"]
    assert one["overflow"] == port["overflow"]
    for a, b in zip(one["occupancy"], port["occupancy"]):
        assert torch.equal(a, b)
    for k in port["params"]:
        assert torch.equal(one["params"][k], port["params"][k]), k


def test_two_ranks_match_one_process_and_jax(reference, tmp_path):
    """Two gloo ranks of 32 rows each against the one-process port run on
    the same 64-ray global batches and random numbers: losses to 1e-5
    relative (a mean of two local means against one mean, gradients summed
    in another order), the bounds, cap and ``# retune@`` lines equal, the
    first occupancy update exact (later ones follow fields that differ by
    rounding: 1e-5 of the EMA's largest entry), and the two ranks'
    parameters bit-equal after the nine steps. Against the JAX trainer at
    ``test_torch_retune.py``'s tolerances."""
    ranks = _spawn(reference["job"], 2, tmp_path)
    port, jax_out = reference["port"], reference["jax"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], port["losses"], rtol=1e-5, atol=0)
        assert [b[:2] for b in r["bounds"]] == [b[:2] for b in port["bounds"]]
        np.testing.assert_allclose([b[2] for b in r["bounds"]],
                                   [b[2] for b in port["bounds"]], rtol=1e-6)
        assert r["retunes"] == port["retunes"]
        assert r["overflow"] == port["overflow"]
        assert torch.equal(r["occupancy"][0], port["occupancy"][0])
        for a, b in zip(r["occupancy"], port["occupancy"]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
        # Against JAX (the port's own tolerances there).
        np.testing.assert_allclose(r["losses"], jax_out["losses"], rtol=1e-4, atol=0)
        assert [b[:2] for b in r["bounds"]] == [b[:2] for b in jax_out["bounds"]]
        np.testing.assert_allclose([b[2] for b in r["bounds"]],
                                   [b[2] for b in jax_out["bounds"]], rtol=2e-3)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for k in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
    field = port["params"]["tetrahedra_field"]
    err = float((ranks[0]["params"]["tetrahedra_field"] - field).abs().max())
    assert err <= 1e-4 * float(field.abs().max())


@pytest.mark.parametrize("data, model", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_model_shards_match_one_process_and_jax(model_reference, tmp_path, data, model):
    """``data x model`` gloo ranks (JAX's ``make_mesh(model_shards=2)``
    grid) against the one-process port run and the JAX trainer, as
    :func:`test_two_ranks_match_one_process_and_jax` holds data shards:
    losses to 1e-5 relative, the field reassembled from the model ranks'
    columns to 1e-4 of its largest entry, the bounds, cap, ``# retune@``
    lines and overflow equal, JAX's losses to 1e-4. Each rank holds
    ``[V, F/M]`` of the field and of both RAdam moments, its data group's
    ranks the same bits of them, and every rank the same replicated
    parameters. The grid's checkpoint holds the whole field and moments
    (restored in one process, bit for bit), the one-process checkpoint
    restores into the grid (each rank its columns), and the ranks of data
    index 0 render together what one process renders."""
    ref, world = model_reference, data * model
    job = dict(ref["job"], model_shards=model, save=str(tmp_path / "grid_ckpt"),
               restore=str(ref["ckpt"]))
    ranks = _spawn(job, world, tmp_path)
    port, jax_out = ref["port"], ref["jax"]
    field_ref = port["params"]["tetrahedra_field"]
    num_vertices, num_feat = field_ref.shape
    per = num_feat // model
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], port["losses"], rtol=1e-5, atol=0)
        assert [b[:2] for b in r["bounds"]] == [b[:2] for b in port["bounds"]]
        np.testing.assert_allclose([b[2] for b in r["bounds"]],
                                   [b[2] for b in port["bounds"]], rtol=1e-6)
        assert r["retunes"] == port["retunes"] and len(r["retunes"]) == 1
        assert r["overflow"] == port["overflow"]
        for a, b in zip(r["occupancy"], port["occupancy"]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
        np.testing.assert_allclose(r["losses"], jax_out["losses"], rtol=1e-4, atol=0)
        assert [b[:2] for b in r["bounds"]] == [b[:2] for b in jax_out["bounds"]]
        assert r["params"]["tetrahedra_field"].shape == (num_vertices, per)
        assert all(x.shape == (num_vertices, per) for x in r["moments"].values())
        first = ranks[rank % model]  # data index 0, same columns
        assert torch.equal(r["params"]["tetrahedra_field"], first["params"]["tetrahedra_field"])
        assert all(torch.equal(r["moments"][k], first["moments"][k]) for k in r["moments"])
        for k in port["params"]:
            if k != "tetrahedra_field":
                assert torch.equal(r["params"][k], ranks[0]["params"][k]), k
        assert r["losses"] == ranks[0]["losses"]
        assert torch.equal(r["occupancy"][-1], ranks[0]["occupancy"][-1])
    field = torch.cat([ranks[m]["params"]["tetrahedra_field"] for m in range(model)], dim=1)
    assert float((field - field_ref).abs().max()) <= 1e-4 * float(field_ref.abs().max())

    # The grid's checkpoint in one process: the whole field and moments.
    cfg = job["cfg"]
    one = Trainer(TrainConfig(), TetraNerf(cfg, num_vertices, device="cpu"), job["mesh"],
                  device="cpu")
    one.restore_checkpoint(tmp_path / "grid_ckpt")
    assert torch.equal(one.model.tetrahedra_field.detach(), field)
    for k, v in _field_moments(one).items():
        assert torch.equal(v, torch.cat([ranks[m]["moments"][k] for m in range(model)], 1)), k
    for k, v in one.model.state_dict().items():
        if k != "tetrahedra_field":
            assert torch.equal(v, ranks[0]["params"][k]), k

    # The one-process checkpoint in the grid, and the eval of data index 0.
    full_field, full_moments = port["restored"]
    for rank, r in enumerate(ranks):
        cols = slice(rank % model * per, (rank % model + 1) * per)
        restored_field, restored_moments = r["restored"]
        assert torch.equal(restored_field, full_field[:, cols])
        for k, v in restored_moments.items():
            assert torch.equal(v, full_moments[k][:, cols]), k
        assert ("render" in r) == (rank < model)
        if rank < model:
            for k, v in port["render"].items():
                np.testing.assert_array_equal(r["render"][k], v, err_msg=k)


class _ColumnGroup:
    """Model rank ``model_index`` of ``model_count`` inside one process: its
    column gather returns the full-width tensors it was made with, after
    checking that this rank's columns of them were passed."""

    def __init__(self, model_index, model_count, full):
        self.model_index, self.model_count, self.full = model_index, model_count, full

    def gather_columns(self, xs):
        per = self.full[0].shape[-1] // self.model_count
        cols = slice(self.model_index * per, (self.model_index + 1) * per)
        for x, full in zip(xs, self.full):
            assert torch.equal(x, full[..., cols])
        return [full.clone() for full in self.full]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("lever", ["f32", "bf16", "budget"])
def test_column_gather_backward_is_this_ranks_slice(request, device, lever):
    """Endpoint features of three bucket streams from a field sharded in 4
    column blocks, each model rank in turn: the forward is the whole
    field's, bit for bit, and each rank's field gradient is its columns of
    the whole field's gradient, neither summed over the model group nor
    scaled by it (the gather's backward is a slice): exactly on the CPU,
    to K7's atomic order (1e-6 of the largest entry) on the card, where
    K2, K2b and K7 run at ``F/M`` = 4. Also with the bf16 stream, and with
    a gradient-stream budget's dropped slots (every third, id -1)."""
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.ops.fused import endpoint_features_batch, march_features
    from tetranerf_torch.utils.synthetic import sample_sphere_rays as rays

    dev = request.getfixturevalue("cuda_device") if device == "cuda" else torch.device("cpu")
    points, _ = make_sphere_scene(300, seed=0)
    mesh = build_mesh(points, device=dev)
    o, d = (torch.from_numpy(x).to(dev) for x in rays(np.random.default_rng(3), 24))
    streams = [march_features(mesh, None, o[i::3].contiguous(), d[i::3].contiguous(),
                              32).stream for i in range(3)]
    gen = torch.Generator().manual_seed(0)
    field = torch.randn(mesh.num_vertices, 16, generator=gen).to(dev).requires_grad_()
    weights = [torch.randn(s.pos.shape[:2] + (16,), generator=gen).to(dev) for s in streams]
    stream_dtype = torch.bfloat16 if lever == "bf16" else None
    ids = None
    if lever == "budget":
        ids = [torch.where(torch.arange(s.vids.numel(), device=dev).view_as(s.vids) % 3 == 0,
                           -1, s.vids.clamp_min(0)).to(torch.int32) for s in streams]
    feats = endpoint_features_batch(field, streams, stream_dtype, ids)
    sum((f * w).sum() for f, w in zip(feats, weights)).backward()
    full = [f.detach() for f in feats]
    model_count, per = 4, 4
    for m in range(model_count):
        cols = slice(m * per, (m + 1) * per)
        block = field.detach()[:, cols].clone().requires_grad_()
        group = _ColumnGroup(m, model_count, full)
        out = endpoint_features_batch(block, streams, stream_dtype, ids, columns=group)
        assert all(torch.equal(a, b) for a, b in zip(out, full))
        sum((f * w).sum() for f, w in zip(out, weights)).backward()
        tol = 0.0 if device == "cpu" else 1e-6 * float(field.grad.abs().max())
        torch.testing.assert_close(block.grad, field.grad[:, cols], rtol=0, atol=tol)
    assert float(field.grad.abs().max()) > 0


@pytest.mark.parametrize("case", ["world", "field", "columns", "init"])
def test_indivisible_shards_are_refused(monkeypatch, case):
    """A world or a field width that does not divide by the model shards
    raises ``ValueError`` saying so, as JAX's ``make_mesh`` and
    ``state_shardings`` do; nothing falls back to a replicated field."""
    from tetranerf_torch.parallel import column_slice, distributed

    with pytest.raises(ValueError, match="not divisible") as caught:
        if case == "world":
            check_shards(TrainConfig(num_model_shards=2), 3)
        elif case == "field":
            check_shards(TrainConfig(num_model_shards=3), 3)
        elif case == "columns":
            column_slice(7, 0, 2)
        else:
            monkeypatch.setenv("RANK", "0")
            monkeypatch.setenv("WORLD_SIZE", "3")
            monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
            distributed.init_distributed("cpu", model_shards=2)
    if case == "columns":
        from tetranerf_tpu.parallel import make_mesh, state_shardings

        with pytest.raises(ValueError) as jax_caught:
            state_shardings(make_mesh(num_devices=8, model_shards=2),
                            {"tetrahedra_field": np.zeros((10, 7))})
        assert str(caught.value) == str(jax_caught.value)
    else:
        assert ("field_dim=64" if case == "field" else "model_shards=2") in str(caught.value)


class _SplitGroup:
    """Data shard ``rank`` of ``world`` inside one process: its gather
    returns the global vector of crossing counts it was made with (after
    checking that this rank's share of it was passed)."""

    def __init__(self, rank, world, num_valid):
        self.data_index, self.data_count, self.full = rank, world, num_valid

    def gather_rows(self, x):
        n = x.shape[0]
        assert torch.equal(x, self.full[self.data_index * n:(self.data_index + 1) * n])
        return self.full


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels' zero-row jobs run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("merge, fused", [(True, False), (False, True)],
                         ids=["merged", "fused"])
def test_a_rank_with_empty_buckets_trains(request, device, merge, fused):
    """Rank 0 holds 16 rays that miss the scene, rank 1 16 that cross it:
    of 4 buckets over the 32 global rays each rank has two empty ones (a
    zero-row job in K8, K2, K7 and K2b, no rows for K3, K3b and the MLPs).
    Both ranks' forwards and backwards run, merged MLP rounds or fused
    MLPs, and give the one-process forward's rgb and, summed, its field
    gradient."""
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.models import tetranerf_preset
    from tetranerf_torch.ops.fused import march_features
    from tetranerf_torch.utils.synthetic import sample_sphere_rays

    dev = request.getfixturevalue("cuda_device") if device == "cuda" else torch.device("cpu")
    points, colors = make_sphere_scene(800, seed=0)
    mesh = build_mesh(points, device=dev)
    cfg = tetranerf_preset(field_dim=16, hidden_size=32, num_samples=16, num_fine_samples=16,
                           max_intersected_triangles=64, ray_buckets=4,
                           bucket_merge_mlps=merge, fused_mlps=fused)
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(0), device=dev)
    o, d = sample_sphere_rays(np.random.default_rng(4), 32)
    d[:16] = -d[:16]  # rank 0's rays point away: they cross nothing
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    bounds = dict(bucket_steps=(16, 32, 48), occ_depth_cap=CAP)

    def forward(o_, d_, group=None):
        model.zero_grad(set_to_none=True)
        out = model.get_outputs(o_, d_, mesh, train=True, group=group,
                                generator=torch.Generator(dev).manual_seed(5), **bounds)
        out["rgb"].sum().backward()
        return out["rgb"].detach(), model.tetrahedra_field.grad.clone()

    rgb, grad = forward(o, d)
    nv = march_features(mesh, None, o, d, 64, use_occupancy=True, occ_depth_cap=CAP).num_valid
    assert int(nv[:16].max()) == 0 and int(nv[16:].min()) > 0
    rgbs, grad_sum = [], torch.zeros_like(grad)
    for rank in range(2):
        rows = slice(16 * rank, 16 * (rank + 1))
        rgb_r, grad_r = forward(o[rows], d[rows], _SplitGroup(rank, 2, nv))
        rgbs.append(rgb_r)
        grad_sum += grad_r
    tol = 1e-6 if device == "cpu" else 1e-3  # bf16 MLPs over other row counts
    torch.testing.assert_close(torch.cat(rgbs), rgb, atol=tol, rtol=0)
    torch.testing.assert_close(grad_sum, grad, rtol=0, atol=max(tol, 1e-5) * float(grad.abs().max()))
    assert float(grad.abs().max()) > 0


@pytest.mark.parametrize("data, model, world, refused", [
    (None, 1, 1, None), (None, 1, 4, None), (4, 1, 4, None), (1, 1, 1, None),
    (2, 1, 1, "rank"), (1, 1, 2, "rank"), (None, 2, 4, None),
], ids=[f"shards{i}" for i in range(7)])
def test_shard_counts_must_match_the_world(data, model, world, refused):
    """``num_data_shards`` is the rank count over the model shards (None:
    all of them); model shards (A9b) are accepted where the world divides
    by them."""
    cfg = TrainConfig(num_data_shards=data, num_model_shards=model)
    if refused is None:
        check_shards(cfg, world)
        return
    with pytest.raises(ValueError, match=refused):
        check_shards(cfg, world)


def test_cli_refuses_data_shards_the_run_lacks(monkeypatch, tmp_path):
    """Under torchrun's environment with 2 ranks, a config asking for 4 data
    shards exits before any process group is joined."""
    from tetranerf_torch.training import cli

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(cli, "_config_from_args", lambda args: TrainConfig(num_data_shards=4))
    with pytest.raises(SystemExit, match="num_data_shards=4 but the run has 2"):
        cli.main(["--data", str(tmp_path), "--device", "cpu"])


def test_collectives_wait_out_an_eval(monkeypatch):
    """Rank 0 alone evaluates while the other ranks wait at a barrier, so
    the group's collectives wait :data:`COLLECTIVE_TIMEOUT`, not the
    backends' default of 10 (NCCL) or 30 (gloo) minutes."""
    import datetime

    from tetranerf_torch.parallel import distributed

    seen = {}
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.update(kw, backend=backend))
    group = distributed.init_distributed("cpu")
    assert (group.rank, group.world, seen["backend"]) == (0, 1, "gloo")
    assert seen["timeout"] == distributed.COLLECTIVE_TIMEOUT >= datetime.timedelta(hours=1)


# ------------------------------------------- the live viewer over model shards

VIEWER_SIDE = 12
# (position, side, quality, rows): the fast and the full frame queued before
# fit, served after step 1, then the fast frame queued during step 2's eval.
VIEWER_FRAMES = (([0.3, 2.4, 0.6], VIEWER_SIDE, "fast", None),
                 ([0.3, 2.4, 0.6], VIEWER_SIDE, "full", [0, VIEWER_SIDE // 2]),
                 ([-1.8, 1.2, 1.0], VIEWER_SIDE, "fast", None))
VIEWER_TIMEOUT_S = 120


def _viewer_job():
    """A 300-point sphere at JAX's model-parallel test's widths with the fine
    round and 4 buckets, seeded weights, and two 64-ray batches."""
    from tetranerf_torch.geometry import build_mesh
    from tetranerf_torch.models import tetranerf_preset

    points, colors = make_sphere_scene(300, seed=4)
    cfg = tetranerf_preset(**dict(MODEL_SHARD_WIDTHS, num_fine_samples=8, ray_buckets=4))
    mesh = build_mesh(points, device="cpu")
    model = TetraNerf(cfg, mesh.num_vertices, point_colors=colors,
                      generator=torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(17)
    return dict(cfg=cfg, mesh=mesh, state=model.state_dict(),
                batches=[_batch(rng) for _ in range(2)],
                rays=sample_sphere_rays(np.random.default_rng(3), 40))


def _post_frame(port, frame, replies, key):
    """POST one frame to the viewer on ``port``; ``replies[key]`` becomes
    ``(HTTP status, body)``."""
    import json
    import urllib.error
    import urllib.request

    position, side, quality, rows = frame
    body = {"position": position, "side": side, "quality": quality, "rows": rows}
    req = urllib.request.Request(f"http://127.0.0.1:{port}/render", method="POST",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=VIEWER_TIMEOUT_S) as r:
            replies[key] = (r.status, r.read())
    except urllib.error.HTTPError as exc:
        replies[key] = (exc.code, b"")


def _queue_frame(viewer, frame, replies, key):
    """A client thread posting ``frame``, returned once rank 0 has queued it."""
    import threading
    import time

    queued = len(viewer._queue)
    thread = threading.Thread(target=_post_frame, args=(viewer.port, frame, replies, key))
    thread.start()
    deadline = time.monotonic() + VIEWER_TIMEOUT_S
    while len(viewer._queue) == queued:
        assert time.monotonic() < deadline, "the frame was never queued"
        time.sleep(0.01)
    return thread


def _viewer_rank(job, group):
    """One rank of a model-sharded run with the live viewer: every rank
    builds a viewer, rank 0 serves the socket. Two frames queued before
    ``fit``, one during step 2's eval on rank 0; after ``fit`` a late
    request. Returns every rank's frame outputs and, on rank 0, the HTTP
    replies, with the adapter's render and state dict (collective)."""
    from tetranerf_torch.torch_adapter import TorchRenderAdapter
    from tetranerf_torch.viewer import ViewerServer

    model = TetraNerf(job["cfg"], job["mesh"].num_vertices, device="cpu")
    model.load_state_dict(job["state"])
    trainer = Trainer(TrainConfig(num_model_shards=group.model_count), model, job["mesh"],
                      device="cpu", group=group)
    viewer = ViewerServer(trainer, port=0, host="127.0.0.1", chunk=64, fast_samples=8)
    outputs, plain = [], viewer._frame_outputs

    def recording(*args):
        out = plain(*args)
        outputs.append({k: np.asarray(v) for k, v in out.items()})
        return out

    viewer._frame_outputs = recording
    replies, threads = {}, []
    if group.rank == 0:
        viewer.start()
        threads = [_queue_frame(viewer, VIEWER_FRAMES[k], replies, k) for k in (0, 1)]

    def eval_fn(step, tr):
        if tr.is_main:  # queued while rank 0 evaluates: served at step 2's boundary
            threads.append(_queue_frame(viewer, VIEWER_FRAMES[2], replies, 2))

    try:
        trainer.fit(lambda i: job["batches"][i], num_iterations=2, log_every=0,
                    eval_fn=eval_fn, eval_every=2, viewer=viewer)
        if group.rank == 0:
            _post_frame(viewer.port, VIEWER_FRAMES[0], replies, "late")
            for t in threads:
                t.join(VIEWER_TIMEOUT_S)
            assert not any(t.is_alive() for t in threads), "a client still waits"
        adapter = TorchRenderAdapter(trainer, chunk=32)
        rendered = {k: v.numpy() for k, v in adapter.get_outputs(*job["rays"]).items()}
        state = {k: v.numpy() for k, v in adapter.state_dict().items()}
    finally:
        viewer.stop()
    return dict(outputs=outputs, replies=replies, rendered=rendered, state=state,
                field_shape=tuple(trainer.model.tetrahedra_field.shape))


def _viewer_rank_main(rank, world, port, job_path, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      GLOO_SOCKET_IFNAME="lo")
    from tetranerf_torch.parallel import destroy, init_distributed

    job = torch.load(job_path, weights_only=False)
    group = init_distributed("cpu", model_shards=world)
    try:
        torch.save(_viewer_rank(job, group), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy(group)


def test_viewer_refuses_a_sharded_field(tmp_path):
    """The live viewer of a trainer whose field is split over 1 x 2 model
    shards (A9c; this test once checked its refusal): rank 0 alone serves
    the socket, and the frames queued before ``fit`` (a fast frame and a
    full frame's band) and during step 2's eval come back at the step
    boundaries, equal to one process's frames after the same steps (float
    outputs to 1e-5, PNGs at most 1 level of 255 apart), rendered by both
    model ranks alike. A request after ``fit`` is refused with 503, never
    left waiting. The serving API on the grid: the adapter's render and
    whole-field state dict, collective on both ranks, equal one process's.
    The ranks run under a deadline, so a deadlock fails the test."""
    import time

    from tetranerf_torch.torch_adapter import TorchRenderAdapter
    from tetranerf_torch.utils.png import read_png
    from tetranerf_torch.viewer import ViewerServer, _colorize

    job = _viewer_job()
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    ctx = torch.multiprocessing.spawn(
        _viewer_rank_main, args=(2, _free_port(), str(job_path), str(tmp_path)), nprocs=2,
        join=False)
    deadline = time.monotonic() + 2 * VIEWER_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks ran past {2 * VIEWER_TIMEOUT_S} s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    # One process: the same model and batches, each frame after its step.
    model = TetraNerf(job["cfg"], job["mesh"].num_vertices, device="cpu")
    model.load_state_dict(job["state"])
    one = Trainer(TrainConfig(), model, job["mesh"], device="cpu")
    viewer = ViewerServer(one, port=0, chunk=64, fast_samples=8)
    want = []
    for step, frames in ((0, (0, 1)), (1, (2,))):
        one.train_step(job["batches"][step])
        for k in frames:
            position, side, quality, rows = VIEWER_FRAMES[k]
            want.append(viewer._frame_outputs(position, side, quality,
                                              tuple(rows or (0, side))))
    replies = ranks[0]["replies"]
    assert replies["late"][0] == 503 and not ranks[1]["replies"]
    assert [r["field_shape"] for r in ranks] == [(job["mesh"].num_vertices, 4)] * 2
    for k, ref in enumerate(want):
        status, png = replies[k]
        assert status == 200, (k, status)
        for r in ranks:
            got = r["outputs"][k]
            assert got.keys() == ref.keys()
            for name in ref:
                np.testing.assert_allclose(got[name].astype(np.float64),
                                           ref[name].astype(np.float64), atol=1e-5,
                                           rtol=0, err_msg=f"frame {k} {name}")
        (tmp_path / "frame.png").write_bytes(png)
        rows = VIEWER_FRAMES[k][3] or (0, VIEWER_SIDE)
        image = _colorize(ref, (rows[1] - rows[0], VIEWER_SIDE), "rgb")
        diff = np.abs(read_png(tmp_path / "frame.png").astype(int) - image.astype(int))
        assert diff.max() <= 1, f"frame {k}"
    o, d = job["rays"]
    rendered = one.render_rays(o, d, chunk=32)
    state = TorchRenderAdapter(one).state_dict()
    for r in ranks:
        for name in rendered:
            np.testing.assert_allclose(r["rendered"][name].astype(np.float64),
                                       rendered[name].astype(np.float64), atol=1e-5,
                                       rtol=0, err_msg=name)
        assert r["state"].keys() == state.keys()
        for name in state:
            np.testing.assert_allclose(r["state"][name], state[name].numpy(), atol=1e-5,
                                       rtol=0, err_msg=name)
