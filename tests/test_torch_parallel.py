"""Data-parallel training over ranks (``tetranerf_torch.parallel``) on the
CPU: ranks spawned with ``torch.multiprocessing`` over gloo, against the
one-process port trainer and the JAX trainer on the same global batches.

A D-rank step is the one-rank step on the concatenation of the ranks' rows
in rank order (the JAX package's GSPMD contract): the buckets cut the
global sort, the probes gather their statistics, the occupancy update maxes
every rank's rays into one EMA, and the gradients are averaged so that the
ranks' parameters stay bit-equal."""

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
    lines and the final parameters."""
    model = TetraNerf(job["cfg"], job["mesh"].num_vertices, device="cpu")
    model.load_state_dict(job["state"])
    trainer = Trainer(TrainConfig(), model, job["mesh"], device="cpu", group=group)
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
    return out


def _rank_main(rank, world, port, job_path, out_dir):
    """A spawned rank: joins the gloo group from torchrun's environment,
    runs :func:`_run_steps` and saves its result."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      GLOO_SOCKET_IFNAME="lo")
    from tetranerf_torch.parallel import destroy, init_distributed

    group = init_distributed("cpu")
    try:
        assert (group.rank, group.world, group.device.type) == (rank, world, "cpu")
        result = _run_steps(torch.load(job_path, weights_only=False), group)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy(group)


def _spawn(job, world, tmp_path):
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    torch.multiprocessing.spawn(_rank_main, args=(world, _free_port(), str(job_path),
                                                  str(tmp_path)), nprocs=world)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def reference():
    """The set-up of ``tests/test_torch_retune.py``'s nine steps (the
    800-point sphere, four buckets at bound 96, occupancy updated and
    refreshed every 4 steps, the transmittance retune at steps 4 and 8,
    the JAX trainer's parameters with a density bias of 8): the JAX
    trainer's losses, bounds and cap, its random numbers per step in the
    global batch's layout, and the one-process port run."""
    import jax
    from tetranerf_tpu.geometry import build_mesh as jax_build_mesh
    from tetranerf_tpu.models.tetra_nerf import TetraNerf as JaxTetraNerf
    from tetranerf_tpu.training.trainer import Trainer as JaxTrainer

    points, colors = make_sphere_scene(800, seed=0)
    jmesh = jax_build_mesh(points)
    jcfg, cfg = _configs("float32", ray_buckets=4, max_intersected_triangles=96,
                         occupancy_update_every=4, occupancy_refresh_every=4,
                         occupancy_retune_every=4)
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
    for step in range(STEPS):
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
    return dict(job=job, jax=jax_out, port=_run_steps(job))


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


class _SplitGroup:
    """Rank ``rank`` of a group of ``world`` inside one process: its gather
    returns the global vector of crossing counts it was made with (after
    checking that this rank's share of it was passed)."""

    def __init__(self, rank, world, num_valid):
        self.rank, self.world, self.full = rank, world, num_valid

    def gather_rows(self, x):
        n = x.shape[0]
        assert torch.equal(x, self.full[self.rank * n:(self.rank + 1) * n])
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
    (2, 1, 1, ValueError), (1, 1, 2, ValueError), (None, 2, 1, NotImplementedError),
], ids=[f"shards{i}" for i in range(7)])
def test_shard_counts_must_match_the_world(data, model, world, refused):
    """``num_data_shards`` is the rank count (None: all of them); feature
    shards (A9b) are refused whatever the world."""
    cfg = TrainConfig(num_data_shards=data, num_model_shards=model)
    if refused is None:
        check_shards(cfg, world)
        return
    with pytest.raises(refused, match="A9b" if model > 1 else "rank"):
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
