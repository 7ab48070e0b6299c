"""Render CLI: a checkpoint's images (RGB and depth) with their metrics.

Counterpart of :mod:`tetranerf_tpu.scripts.render`, with the same flags
and outputs, plus ``--device`` (default ``cuda``; without a card the
script exits, and the CPU takes ``--device cpu``)::

    tetranerf-torch-render --checkpoint outputs/scene/final --data data/scene \
        [--tetrahedra-path tetra.npz] [--split test] [--output renders/]
    python -m tetranerf_torch.scripts.render ...

It writes ``{split}_{i:04d}.png`` and ``{split}_{i:04d}_depth.png`` per
image (through :mod:`..utils.png`), and ``metrics.json``: the mean of
each image's metrics and ``render_rays_per_sec``, also printed as one JSON
line. As in JAX, a checkpoint holds neither the tuned bounds nor the
calibrated cap, so a restored trainer renders at the configured bound and
``-log(occupancy_threshold)``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def load_trainer(checkpoint, data, split, tetrahedra_path=None, method="tetra-nerf",
                 device="cuda"):
    """``(trainer, dataset)``: the ``split`` of the dataset at ``data`` and a
    :class:`~..training.trainer.Trainer` restored from the ``checkpoint``
    directory, its model config taken from the checkpoint's
    ``train_config.json`` (scalar fields, as the JAX scripts take them)."""
    from ..models import TetraNerf
    from ..training.cli import build_mesh_for_dataset
    from ..training.checkpoints import CONFIG_FILE
    from ..training.datasets import load_dataset
    from ..training.presets import METHODS
    from ..training.trainer import Trainer

    ckpt_dir = Path(checkpoint)
    config = METHODS[method]()
    cfg_file = ckpt_dir / CONFIG_FILE
    if cfg_file.exists():
        with open(cfg_file) as f:
            saved = json.load(f)
        for k, v in saved.get("model", {}).items():
            if (hasattr(config.model, k) and isinstance(v, (int, float, str, bool))
                    and k != "tetrahedra_path"):
                setattr(config.model, k, v)
    dataset = load_dataset(data, split)
    mesh, colors = build_mesh_for_dataset(dataset, tetrahedra_path, device)
    model = TetraNerf(config.model, mesh.num_vertices, num_train_images=dataset.num_images,
                      point_colors=colors, device=device)
    trainer = Trainer(config, model, mesh, device=device, auto_tune_steps=False)
    trainer.restore_checkpoint(ckpt_dir)
    return trainer, dataset


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tetranerf-torch-render")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--tetrahedra-path", default=None)
    parser.add_argument("--split", default="test")
    parser.add_argument("--output", default="renders")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--method", default="tetra-nerf")
    parser.add_argument("--chunk", type=int, default=16384)
    parser.add_argument("--fast", action="store_true",
                        help="coarse-only render with 64 samples (viewer-speed mode)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; the CPU only when asked "
                        "for with --device cpu)")
    args = parser.parse_args(argv)

    import torch

    from ..training.cli import check_device
    from ..training.metrics import compute_image_metrics
    from ..utils.png import write_png

    device = check_device(args.device)
    trainer, dataset = load_trainer(args.checkpoint, args.data, args.split,
                                    args.tetrahedra_path, args.method, device)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    num = dataset.num_images
    if args.max_images:
        num = min(num, args.max_images)
    metrics_all = []
    t_start = time.perf_counter()
    total_rays = 0
    for i in range(num):
        o, d = dataset.camera_rays(i)
        total_rays += len(o)
        out = trainer.render_rays(
            o, d, chunk=args.chunk,
            num_samples=64 if args.fast else None,
            num_fine_samples=0 if args.fast else None,
        )
        h, w = dataset.height, dataset.width
        rgb = np.clip(out["rgb"].reshape(h, w, 3), 0, 1)
        write_png(out_dir / f"{args.split}_{i:04d}.png", (rgb * 255).astype(np.uint8))
        depth = out["depth"].reshape(h, w)
        finite = depth[np.isfinite(depth)]
        dmax = finite.max() if len(finite) else 1.0
        depth_img = np.clip(depth / max(dmax, 1e-6), 0, 1)
        write_png(out_dir / f"{args.split}_{i:04d}_depth.png",
                  (depth_img * 255).astype(np.uint8))
        m = compute_image_metrics(torch.from_numpy(rgb).to(device),
                                  torch.from_numpy(dataset.images[i]).to(device))
        metrics_all.append(m)
        print(f"image {i}: psnr={m['psnr']:.2f}", file=sys.stderr)
    dt = time.perf_counter() - t_start
    mean = {k: float(np.mean([m[k] for m in metrics_all])) for k in metrics_all[0]}
    mean["render_rays_per_sec"] = total_rays / dt
    print(json.dumps(mean))
    with open(out_dir / "metrics.json", "w") as f:
        json.dump(mean, f, indent=2)
    return mean


def entrypoint():
    main()


if __name__ == "__main__":
    main()
