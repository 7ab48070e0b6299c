"""Point cloud -> tetrahedra file CLI.

Counterpart of :mod:`tetranerf_tpu.scripts.triangulate` (the reference's
``tetranerf/scripts/triangulate.py``): load a ``.ply`` point cloud,
subsample it to a cap, optionally add jittered points (sphere-shell offsets
by default, gaussian with ``--use-gaussian``), Delaunay-tetrahedralize, and
save ``{cells, vertices, colors}`` as ``.th`` (``torch.save``) or ``.npz``.
The random points are drawn with the JAX script's ``np.random.default_rng``
calls in the same order, so both scripts write the same tetrahedra.

Usage::

    tetranerf-torch-triangulate --pointcloud cloud.ply --output tetra.th \
        [--random-points-ratio 1.0] [--max-pointcloud-size 1000000]
    python -m tetranerf_torch.scripts.triangulate ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def triangulate_pointcloud(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    max_pointcloud_size: int = 1_000_000,
    random_points_ratio: float = 0.0,
    use_gaussian: bool = False,
    seed: int = 42,
):
    """``(vertices f32[V, 3], cells i32[C, 4], colors u8[V, 4])`` of the
    point cloud, subsampled and jittered as the CLI's flags say."""
    from ..geometry import find_average_spacing, triangulate

    rng = np.random.default_rng(seed)
    points = np.asarray(points, np.float64)
    if len(points) > max_pointcloud_size:
        keep = rng.choice(len(points), max_pointcloud_size, replace=False)
        points = points[keep]
        colors = colors[keep] if colors is not None else None

    if random_points_ratio > 0:
        spacing = find_average_spacing(points)
        num_extra = int(len(points) * random_points_ratio)
        base = points[rng.integers(0, len(points), num_extra)]
        if use_gaussian:
            offsets = rng.normal(scale=spacing, size=(num_extra, 3))
        else:
            # Shell offsets: directions uniform, radii ~ |N(spacing, spacing/2)|.
            dirs = rng.normal(size=(num_extra, 3))
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            radii = np.abs(rng.normal(spacing, spacing / 2.0, size=(num_extra, 1)))
            offsets = dirs * radii
        points = np.concatenate([points, base + offsets], axis=0)
        if colors is not None:
            extra_colors = np.full((num_extra, colors.shape[1]), 128, np.uint8)
            colors = np.concatenate([colors, extra_colors], axis=0)

    cells = triangulate(points)
    vertices = points.astype(np.float32)
    if colors is None:
        colors = np.full((len(vertices), 4), 255, np.uint8)
    elif colors.shape[1] == 3:
        colors = np.concatenate([colors, np.full((len(colors), 1), 255, np.uint8)], axis=1)
    return vertices, cells, colors


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tetranerf-torch-triangulate")
    parser.add_argument("--pointcloud", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--max-pointcloud-size", type=int, default=1_000_000)
    parser.add_argument("--random-points-ratio", type=float, default=0.0)
    parser.add_argument("--use-gaussian", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    from ..geometry import read_ply, save_tetrahedra

    points, colors = read_ply(args.pointcloud)
    print(f"loaded {len(points)} points", file=sys.stderr)
    vertices, cells, colors = triangulate_pointcloud(
        points, colors, max_pointcloud_size=args.max_pointcloud_size,
        random_points_ratio=args.random_points_ratio, use_gaussian=args.use_gaussian,
        seed=args.seed,
    )
    print(f"triangulated: {len(vertices)} vertices, {len(cells)} cells", file=sys.stderr)
    save_tetrahedra(args.output, vertices=vertices, cells=cells, colors=colors)
    print(f"saved to {args.output}", file=sys.stderr)


def entrypoint():
    main()


if __name__ == "__main__":
    main()
