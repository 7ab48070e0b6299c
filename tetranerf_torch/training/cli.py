"""Training CLI of the port: the ``ns-train tetra-nerf`` equivalent on one
CUDA device, or data-parallel over the ranks torchrun starts.

Usage::

    tetranerf-torch-train --data <dir> [--tetrahedra-path tetra.npz] \
        [--output-dir out] [--method tetra-nerf] [--device cuda] [...]
    python -m tetranerf_torch.training.cli --data <dir> ...
    torchrun --nproc-per-node=N -m tetranerf_torch.training.cli --data <dir> ...

Under torchrun each rank trains on ``cuda:LOCAL_RANK`` (NCCL; gloo with
``--device cpu``) on its rows of every global batch of ``--rays-per-batch``
rays, which must divide by N; rank 0 logs, evaluates and writes the output
directory. With ``--num-model-shards M`` the N ranks are N/M data shards by
M shards of the feature field: the ranks of a data shard share its rows,
each holds 1/M of the field's columns, and ranks 0 to M-1 evaluate
together, and render the live viewer's frames together at the step
boundaries (rank 0 serves the socket).

Counterpart of :mod:`tetranerf_tpu.training.cli`, with the same flags and
output: dataset loading, the mesh from a tetrahedra file (with the
dataparser transform and scale applied to its vertices, reference
``model.py:349-392``) or from the dataset's 3D points, then
:meth:`~.trainer.Trainer.fit` with evaluation on three cadences, a final
evaluation over every held-out image (one JSON line on stdout and
``eval_metrics.json``) and a ``final/`` checkpoint. ``--device`` (default
``cuda``) names the torch device; without a card the CLI exits rather than
train on the CPU, which takes ``--device cpu``. Flags for code the port
does not have yet exit with the ``ROADMAP.md`` item that ports it.
``--viewer-port`` serves the live viewer (:mod:`..viewer`) while ``fit``
runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_mesh_for_dataset(dataset, tetrahedra_path=None, device="cuda"):
    """Mesh + vertex colours from a tetrahedra file or the dataset's points."""
    from ..geometry import build_mesh, load_tetrahedra
    from .datasets import apply_transform

    if tetrahedra_path is not None:
        data = load_tetrahedra(tetrahedra_path)
        vertices = apply_transform(data["vertices"], dataset.dataparser_transform,
                                   dataset.dataparser_scale)
        return build_mesh(vertices, data["cells"], device=device), data.get("colors")
    if dataset.points3d_xyz is None:
        raise SystemExit("dataset provides no 3D points; pass --tetrahedra-path")
    return build_mesh(dataset.points3d_xyz, device=device), dataset.points3d_rgb


def _parse_flag_value(raw: str, tp):
    """Parse a CLI string into a config-field value given its type
    annotation (int/float/str/bool, Optional[...] and Literal[...])."""
    import typing

    if raw.lower() in ("none", "null"):
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        for a in (a for a in typing.get_args(tp) if a is not type(None)):
            try:
                return _parse_flag_value(raw, a)
            except (ValueError, TypeError):
                continue
        raise ValueError(f"cannot parse {raw!r} as {tp}")
    if origin is typing.Literal:
        choices = typing.get_args(tp)
        for c in choices:
            if raw == str(c):
                return c
        raise ValueError(f"{raw!r} not in {choices}")
    if tp is bool:
        if raw.lower() in ("true", "1", "yes", "on"):
            return True
        if raw.lower() in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"{raw!r} is not a bool")
    if tp is int:
        return int(raw)
    if tp is float:
        return float(raw)
    return raw  # str / Path-like


def _add_model_flags(parser):
    """One ``--model.<field>`` flag per ``TetrahedraNerfConfig`` field (the
    reference's ``--pipeline.model.*`` surface, ``README.md:106-115``),
    parsed against the dataclass annotations when applied."""
    import dataclasses as dc

    from ..models.config import TetrahedraNerfConfig

    group = parser.add_argument_group(
        "model config (full TetrahedraNerfConfig override surface)")
    for f in dc.fields(TetrahedraNerfConfig):
        group.add_argument("--model." + f.name.replace("_", "-"), dest="model__" + f.name,
                           default=None, metavar="V",
                           help=f"override TetrahedraNerfConfig.{f.name}")


def _apply_model_flags(args, config):
    import dataclasses as dc
    import typing

    from ..models.config import TetrahedraNerfConfig

    hints = typing.get_type_hints(TetrahedraNerfConfig)
    for f in dc.fields(TetrahedraNerfConfig):
        raw = getattr(args, "model__" + f.name, None)
        if raw is not None:
            setattr(config.model, f.name, _parse_flag_value(raw, hints[f.name]))


# Named aliases and the --model.* field each sets.
_ALIAS_TO_MODEL_FIELD = {
    "num_samples": "num_samples",
    "num_fine_samples": "num_fine_samples",
    "max_intersected_triangles": "max_intersected_triangles",
    "field_dim": "field_dim",
    "background_color": "background_color",
    "occupancy": "use_occupancy_field",
    "no_occupancy": "use_occupancy_field",
    "skip_grid": "skip_grid_resolution",
    "occupancy_threshold": "occupancy_threshold",
    "ray_buckets": "ray_buckets",
    "interp_mode": "interp_mode",
    "retune_percentile": "occupancy_retune_percentile",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tetranerf-torch-train", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--method", default="tetra-nerf",
                        choices=["tetra-nerf", "tetra-nerf-original"])
    parser.add_argument("--data", required=True)
    parser.add_argument("--tetrahedra-path", default=None)
    parser.add_argument("--output-dir", default="outputs/tetra-nerf")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; the CPU "
                        "only when asked for with --device cpu)")
    parser.add_argument("--max-num-iterations", type=int, default=None)
    parser.add_argument("--rays-per-batch", type=int, default=None)
    parser.add_argument("--downscale", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--load-checkpoint", default=None)
    parser.add_argument("--log-every", type=int, default=100)
    # Eval cadences (reference registration.py:34-36 defaults).
    parser.add_argument("--steps-per-eval-batch", type=int, default=None)
    parser.add_argument("--steps-per-eval-image", type=int, default=None)
    parser.add_argument("--steps-per-eval-all-images", type=int, default=None)
    # Model overrides (subset of TetrahedraNerfConfig).
    parser.add_argument("--num-samples", type=int, default=None)
    parser.add_argument("--num-fine-samples", type=int, default=None)
    parser.add_argument("--max-intersected-triangles", type=int, default=None)
    parser.add_argument("--field-dim", type=int, default=None)
    parser.add_argument("--background-color", default=None)
    parser.add_argument("--occupancy", action="store_true",
                        help="maintain the per-cell occupancy EMA and use it for "
                        "ray termination + traversal-bound retuning")
    parser.add_argument("--no-occupancy", action="store_true",
                        help="disable the occupancy field (the tetra-nerf preset "
                        "defaults it ON)")
    parser.add_argument("--skip-grid", type=int, default=None,
                        help="empty-space skip grid resolution G (0 = off): the "
                        "march sphere-traces a G^3 free-space distance grid "
                        "rebuilt from the occupancy EMA at each refresh")
    parser.add_argument("--occupancy-threshold", type=float, default=None,
                        help="alias for --model.occupancy-threshold")
    parser.add_argument("--ray-buckets", type=int, default=None,
                        help="alias for --model.ray-buckets")
    parser.add_argument("--interp-mode", default=None,
                        choices=["matmul", "pallas", "gather"],
                        help="alias for --model.interp-mode")
    parser.add_argument("--retune-percentile", type=float, default=None,
                        help="alias for --model.occupancy-retune-percentile")
    parser.add_argument("--num-model-shards", type=int, default=None,
                        help="shards of the feature field over its feature axis: "
                        "torchrun's ranks form (ranks / M) data shards by M model "
                        "shards; M must divide the rank count and --field-dim")
    parser.add_argument("--allow-eval-on-train", action="store_true",
                        help="fall back to the train split when the test split "
                        "is missing (metrics are tagged eval_split='train'; "
                        "without this flag a missing test split aborts)")
    _add_model_flags(parser)
    parser.add_argument("--viewer-port", type=int, default=None,
                        help="serve the live viewer of the model while it trains "
                        "on this port (0: any free port)")
    return parser


def _config_from_args(args):
    from .presets import METHODS

    config = METHODS[args.method](seed=args.seed, output_dir=args.output_dir)
    if args.max_num_iterations:
        config.max_num_iterations = args.max_num_iterations
    if args.rays_per_batch:
        config.train_num_rays_per_batch = args.rays_per_batch
    for cadence in ("steps_per_eval_batch", "steps_per_eval_image",
                    "steps_per_eval_all_images"):
        v = getattr(args, cadence)
        if v is not None:
            setattr(config, cadence, v)
    for field in ("num_samples", "num_fine_samples", "max_intersected_triangles",
                  "field_dim", "background_color"):
        v = getattr(args, field)
        if v is not None:
            setattr(config.model, field, v)
    if args.occupancy:
        config.model.use_occupancy_field = True
    if args.no_occupancy:
        config.model.use_occupancy_field = False
    if args.skip_grid is not None:
        config.model.skip_grid_resolution = args.skip_grid
    if args.occupancy_threshold is not None:
        config.model.occupancy_threshold = args.occupancy_threshold
    if args.ray_buckets is not None:
        config.model.ray_buckets = args.ray_buckets
    if args.interp_mode is not None:
        config.model.interp_mode = args.interp_mode
    if args.retune_percentile is not None:
        config.model.occupancy_retune_percentile = args.retune_percentile
    if args.num_model_shards is not None:
        config.num_model_shards = args.num_model_shards
    # A named alias and the --model.* flag of the same field both set would
    # silently let --model.* win.
    for alias, field in _ALIAS_TO_MODEL_FIELD.items():
        v = getattr(args, alias, None)
        # store_true aliases are set only when True; a value alias whenever
        # it is not None, an explicit 0 included (0 == False).
        alias_set = v is True if alias in ("occupancy", "no_occupancy") else v is not None
        if alias_set and getattr(args, "model__" + field, None) is not None:
            raise SystemExit(
                f"conflicting flags: --{alias.replace('_', '-')} and "
                f"--model.{field.replace('_', '-')} both set — pass only one")
    _apply_model_flags(args, config)
    return config


def _world() -> int:
    """The rank count torchrun's environment names, else 1."""
    return int(os.environ["WORLD_SIZE"]) if "RANK" in os.environ else 1


def _refuse_unported(config):
    """Exit on settings whose code the port does not have yet, and on shard
    counts the run does not have."""
    from ..models.config import check_supported
    from .presets import check_shards

    try:
        check_shards(config, _world())
        check_supported(config.model)
    except (NotImplementedError, ValueError) as exc:
        raise SystemExit(str(exc)) from None


def check_device(device: str):
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    return device


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = _config_from_args(args)
    _refuse_unported(config)
    device = check_device(args.device)

    from ..parallel import destroy, init_distributed

    group = init_distributed(device, model_shards=config.num_model_shards or 1)
    if group is not None:
        device = group.device
    try:
        return _train(args, config, device, group)
    finally:
        destroy(group)


def _train(args, config, device, group):
    import torch

    from ..models import TetraNerf
    from .datasets import load_dataset
    from .metrics import Lpips, compute_image_metrics
    from .trainer import Trainer

    print(f"loading dataset from {args.data} ...", file=sys.stderr)
    kwargs = {"downscale": args.downscale} if args.downscale != 1 else {}
    train_ds = load_dataset(args.data, "train", **kwargs)
    eval_split = "test"
    try:
        eval_ds = load_dataset(args.data, "test", **kwargs)
    except Exception as exc:
        # A missing test split silently inflating every metric is worse
        # than an abort: evaluating on the train split needs the flag, and
        # the metrics say so.
        if not args.allow_eval_on_train:
            raise SystemExit(
                f"no test split at {args.data} ({exc}); pass "
                "--allow-eval-on-train to evaluate on the TRAIN split "
                "(metrics will be tagged eval_split='train')")
        print(f"WARNING: no test split ({exc}); evaluating on the TRAIN split — "
              "reported metrics are NOT held-out", file=sys.stderr)
        eval_ds = train_ds
        eval_split = "train"
    print(f"  {train_ds.num_images} train images {train_ds.width}x{train_ds.height}",
          file=sys.stderr)

    mesh, colors = build_mesh_for_dataset(train_ds, args.tetrahedra_path, device)
    print(f"  mesh: {mesh.num_vertices} vertices, {mesh.num_cells} cells",
          file=sys.stderr)
    model = TetraNerf(config.model, mesh.num_vertices,
                      num_train_images=train_ds.num_images, point_colors=colors,
                      generator=torch.Generator().manual_seed(args.seed), device=device)
    trainer = Trainer(config, model, mesh, device=device, group=group)
    if args.load_checkpoint:
        trainer.restore_checkpoint(args.load_checkpoint)

    main_rank = trainer.is_main
    if main_rank:
        os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    batch_size = config.train_num_rays_per_batch

    def next_batch(_):
        return train_ds.sample_ray_batch(rng, batch_size)

    def log_fn(msg):
        if main_rank:
            print(msg, file=sys.stderr)

    # Eval on the reference's three cadences (registration.py:34-36,
    # model.py:676-713): ray-batch PSNR every steps_per_eval_batch; one
    # held-out image with every metric every steps_per_eval_image; all
    # held-out images every steps_per_eval_all_images. The image cadences
    # fire on multiples of the batch cadence.
    eval_rng = np.random.default_rng(args.seed + 1)
    lpips_metric = Lpips()
    try:
        lpips_metric._load()
    except (RuntimeError, ValueError) as exc:
        # Missing or unusable weights must not kill a training run.
        print(f"LPIPS disabled: {exc}", file=sys.stderr)
        lpips_metric = None

    def eval_image(tr, idx):
        o, d = eval_ds.camera_rays(idx)
        pred = tr.render_rays(o, d)["rgb"].reshape(eval_ds.height, eval_ds.width, 3)
        return compute_image_metrics(torch.from_numpy(pred).to(device),
                                     torch.from_numpy(eval_ds.images[idx]).to(device),
                                     lpips=lpips_metric)

    def eval_all(tr):
        per_image = [eval_image(tr, i) for i in range(eval_ds.num_images)]
        return {k: float(np.mean([m[k] for m in per_image])) for k in per_image[0]}

    def fmt(metrics):
        return " ".join(f"{k}={v:.4g}" for k, v in metrics.items())

    every_batch = config.steps_per_eval_batch

    def eval_fn(step, tr):
        batch = eval_ds.sample_ray_batch(eval_rng, config.eval_num_rays_per_batch)
        rgb = tr.eval_batch(batch)["rgb"].cpu().numpy()
        mse = float(np.mean((rgb - batch["rgb"]) ** 2))
        log_fn(f"eval step {step}: psnr={-10.0 * np.log10(mse + 1e-12):.2f}")
        if step % max(config.steps_per_eval_all_images, every_batch) == 0:
            log_fn(f"eval-all-images step {step}: {fmt(eval_all(tr))}")
        elif step % max(config.steps_per_eval_image, every_batch) == 0:
            idx = int(eval_rng.integers(eval_ds.num_images))
            log_fn(f"eval-image step {step} (image {idx}): {fmt(eval_image(tr, idx))}")

    # The live viewer: rank 0 serves the socket. With model shards a frame
    # needs every model rank, so every rank holds a viewer, whose queued
    # frames fit serves at its step boundaries.
    viewer = None
    if args.viewer_port is not None and (main_rank or trainer.model.field_group is not None):
        from ..viewer import ViewerServer

        viewer = ViewerServer(trainer, port=args.viewer_port)
        if main_rank:
            viewer.start()
            log_fn(f"live viewer at http://localhost:{viewer.port}")
    try:
        trainer.fit(next_batch, log_every=args.log_every, log_fn=log_fn,
                    eval_fn=eval_fn, eval_every=every_batch, viewer=viewer)
    finally:
        if viewer is not None:
            viewer.stop()

    # Final eval over the whole held-out split with every metric, by the
    # ranks of data index 0 (rank 0 alone without model shards); rank 0
    # writes.
    if trainer.evaluates:
        mean_metrics = eval_all(trainer)
        mean_metrics["eval_split"] = eval_split
    if main_rank:
        print(json.dumps(mean_metrics))
        with open(os.path.join(args.output_dir, "eval_metrics.json"), "w") as f:
            json.dump(mean_metrics, f, indent=2)
    trainer.save_checkpoint(os.path.join(args.output_dir, "final"))
    return trainer  # for tests / programmatic callers


def entrypoint():
    main()


if __name__ == "__main__":
    main()
