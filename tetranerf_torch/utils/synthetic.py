"""Synthetic sphere scene (host side, numpy).

Copies of ``make_sphere_scene``, ``sample_sphere_rays`` and
``sphere_ray_targets`` from
:mod:`tetranerf_tpu.utils.synthetic`, so that the port runs where the JAX
package is absent; a test holds them equal to the originals.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _albedo(p: np.ndarray) -> np.ndarray:
    """Smooth position-dependent surface colour in [0, 1]."""
    return 0.5 + 0.5 * np.stack(
        [
            np.sin(3.0 * p[..., 0]) * np.cos(2.0 * p[..., 1]),
            np.sin(4.0 * p[..., 1] + 1.0),
            np.cos(3.0 * p[..., 2] + 2.0) * np.sin(2.0 * p[..., 0]),
        ],
        axis=-1,
    )


def make_sphere_scene(
    num_points: int = 2000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud (80% on the unit sphere, the rest inside) + uint8 RGBA."""
    rng = np.random.default_rng(seed)
    n_surf = int(num_points * 0.8)
    d = rng.normal(size=(n_surf, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    surf = d * (1.0 + rng.normal(scale=0.01, size=(n_surf, 1)))
    inner = rng.normal(scale=0.45, size=(num_points - n_surf, 3))
    points = np.concatenate([surf, inner], axis=0)
    colors = np.clip(_albedo(points) * 255.0, 0, 255).astype(np.uint8)
    colors = np.concatenate(
        [colors, np.full((len(points), 1), 255, np.uint8)], axis=1
    )
    return points.astype(np.float64), colors


def sample_sphere_rays(
    rng: np.random.Generator, num_rays: int, radius: float = 2.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Rays from a shell of radius ``radius`` aimed at the ball interior."""
    o = rng.normal(size=(num_rays, 3))
    o *= radius / np.linalg.norm(o, axis=1, keepdims=True)
    target = rng.uniform(-0.7, 0.7, size=(num_rays, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def sphere_ray_targets(origins: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """Analytic ground truth: albedo at the first unit-sphere hit, else white."""
    o, d = origins.astype(np.float64), directions.astype(np.float64)
    b = np.sum(o * d, axis=1)
    c = np.sum(o * o, axis=1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + t[:, None] * d
    rgb = np.ones((len(o), 3), np.float32)
    rgb[hit] = _albedo(p[hit]).astype(np.float32)
    return rgb
