"""Synthetic scenes (host side, numpy): the sphere, the camera scene and
the hard scene.

Copies of :mod:`tetranerf_tpu.utils.synthetic`'s scenes, ray samplers and
analytic targets, so that the port runs where the JAX package is absent;
tests hold them bit-equal to the originals. The camera and hard scenes put
a sparse shell of background points far out, which stretches the hull:
most of a chord then crosses empty space, the regime where the empty-space
skip grid (:mod:`..ops.skip_grid`) pays.
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


# Camera-like scene: small objects + a sparse far background shell — the
# reference's standard COLMAP operating point (object points dense, a few
# hundred far scene/background points stretch the convex hull, cameras
# INSIDE the hull, most of each chord crossing empty space). This is the
# regime where empty-space skipping / occupancy termination must pay,
# unlike the sphere scene whose cloud fills its own hull.
_CAM_SPHERES = (  # (center, radius)
    (np.array([0.6, 0.0, 0.0]), 0.35),
    (np.array([-0.5, 0.45, 0.1]), 0.30),
    (np.array([0.0, -0.5, 0.35]), 0.25),
)
_CAM_BG_RADIUS = 5.0


def make_camera_scene(
    num_points: int = 2000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Object-surface-heavy cloud + ~5% sparse background points on a far
    shell (hull-stretchers, like COLMAP's far scene points)."""
    rng = np.random.default_rng(seed)
    n_bg = max(64, int(num_points * 0.05))
    n_obj = num_points - n_bg
    pts = []
    total_r = sum(r for _, r in _CAM_SPHERES)
    for c, r in _CAM_SPHERES:
        n = int(n_obj * r / total_r)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts.append(c[None] + d * r * (1.0 + rng.normal(scale=0.01, size=(n, 1))))
    bg = rng.normal(size=(n_bg, 3))
    bg /= np.linalg.norm(bg, axis=1, keepdims=True)
    bg *= _CAM_BG_RADIUS * (1.0 + rng.uniform(-0.1, 0.1, size=(n_bg, 1)))
    pts.append(bg)
    points = np.concatenate(pts, axis=0)
    colors = np.clip(_albedo(points) * 255.0, 0, 255).astype(np.uint8)
    colors = np.concatenate(
        [colors, np.full((len(points), 1), 255, np.uint8)], axis=1
    )
    return points.astype(np.float64), colors


def sample_camera_rays(
    rng: np.random.Generator, num_rays: int, radius: float = 2.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Rays from a camera shell INSIDE the hull aimed at the objects."""
    o = rng.normal(size=(num_rays, 3))
    o *= radius / np.linalg.norm(o, axis=1, keepdims=True)
    k = rng.integers(len(_CAM_SPHERES), size=num_rays)
    centers = np.stack([c for c, _ in _CAM_SPHERES])[k]
    jitter = rng.uniform(-0.5, 0.5, size=(num_rays, 3))
    d = centers + jitter - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def camera_ray_targets(origins: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """Analytic ground truth: albedo at the nearest object-sphere hit,
    else white background."""
    o, d = origins.astype(np.float64), directions.astype(np.float64)
    best_t = np.full(len(o), np.inf)
    rgb = np.ones((len(o), 3), np.float32)
    for c, r in _CAM_SPHERES:
        oc = o - c[None]
        b = np.sum(oc * d, axis=1)
        cc = np.sum(oc * oc, axis=1) - r * r
        disc = b * b - cc
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= (t > 0) & (t < best_t)
        p = o + t[:, None] * d
        rgb[hit] = _albedo(p[hit]).astype(np.float32)
        best_t = np.where(hit, t, best_t)
    return rgb


# Hard scene: textured albedo + a thin occluder + view-dependent
# shading. The smooth sphere scenes converge to ~1e-4 train loss, so
# quality regressions smaller than "collapse" are invisible on them;
# this scene keeps high-frequency content (sharpened multi-frequency
# texture), a thin plate whose silhouette moves across views, and a
# specular lobe that only a view-conditioned color head can fit — the
# local proxy for the reference's real-dataset quality bar (thin
# structures / texture / view-dependence, reference README.md:157-165).
_HARD_SPHERES = (  # (center, radius)
    (np.array([0.45, 0.1, 0.0]), 0.45),
    (np.array([-0.55, -0.25, 0.15]), 0.35),
)
# Thin axis-aligned plate: 0.7 x 0.56 footprint, 0.024 thick, floating
# between the spheres so it occludes each from some cameras.
_HARD_PLATE = (
    np.array([-0.35, 0.12, 0.38]),
    np.array([0.35, 0.68, 0.404]),
)
_HARD_LIGHT = np.array([0.40824829, 0.40824829, 0.81649658])  # unit
_HARD_BG_RADIUS = 5.0


def _hard_albedo(p: np.ndarray) -> np.ndarray:
    """High-frequency textured albedo in [0, 1]: a smooth base hue
    modulated by a tanh-sharpened multi-frequency pattern (near-edges
    without aliasing, so converged loss cannot saturate at ~1e-4)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    base = 0.5 + 0.5 * np.stack(
        [np.sin(2.0 * x + 1.0), np.sin(2.0 * y), np.cos(2.0 * z)], axis=-1
    )
    checker = np.tanh(
        2.5 * np.sin(14.0 * x) * np.sin(14.0 * y) * np.sin(14.0 * z)
    )
    stripes = np.tanh(3.0 * np.sin(23.0 * (x + 0.7 * y - 0.4 * z)))
    tex = 0.55 + 0.3 * checker[..., None] + 0.15 * stripes[..., None]
    return np.clip(base * tex, 0.0, 1.0)


def _hard_shade(p, n, d):
    """Lambert + Blinn-Phong specular — the specular lobe depends on the
    VIEW direction ``d``, so the target is view-dependent (but still a
    consistent radiance field: color is a function of (p, d))."""
    l = _HARD_LIGHT
    ndl = np.clip(np.sum(n * l, axis=-1), 0.0, None)
    h = l[None, :] - d
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-9)
    spec = 0.5 * np.clip(np.sum(n * h, axis=-1), 0.0, None) ** 48
    rgb = _hard_albedo(p) * (0.3 + 0.7 * ndl)[..., None] + spec[..., None]
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def make_hard_scene(
    num_points: int = 2000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud on the hard scene's surfaces (spheres + thin plate)
    plus ~5% far background shell points, with albedo-lit colors."""
    rng = np.random.default_rng(seed)
    n_bg = max(64, int(num_points * 0.05))
    n_obj = num_points - n_bg
    areas = [4 * np.pi * r * r for _, r in _HARD_SPHERES]
    lo, hi = _HARD_PLATE
    ext = hi - lo
    areas.append(2 * ext[0] * ext[1])  # the two big faces dominate
    total = sum(areas)
    pts, nrm = [], []
    for (c, r), a in zip(_HARD_SPHERES, areas[:2]):
        n = int(n_obj * a / total)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts.append(c[None] + d * r * (1.0 + rng.normal(scale=0.005, size=(n, 1))))
        nrm.append(d)
    n_pl = n_obj - sum(len(p) for p in pts)
    xy = rng.uniform(size=(n_pl, 2)) * ext[None, :2] + lo[None, :2]
    side = rng.integers(0, 2, size=n_pl)
    z = np.where(side == 1, hi[2], lo[2])
    pts.append(np.stack([xy[:, 0], xy[:, 1], z], axis=-1))
    nz = np.where(side == 1, 1.0, -1.0)
    nrm.append(np.stack([np.zeros(n_pl), np.zeros(n_pl), nz], axis=-1))
    bg = rng.normal(size=(n_bg, 3))
    bg /= np.linalg.norm(bg, axis=1, keepdims=True)
    bg *= _HARD_BG_RADIUS * (1.0 + rng.uniform(-0.1, 0.1, size=(n_bg, 1)))
    pts.append(bg)
    nrm.append(bg / np.linalg.norm(bg, axis=1, keepdims=True))
    points = np.concatenate(pts, axis=0)
    normals = np.concatenate(nrm, axis=0)
    # Seed colors with the VIEW-INDEPENDENT part of the shading (the
    # reference seeds from COLMAP point colors the same way).
    ndl = np.clip(np.sum(normals * _HARD_LIGHT, axis=-1), 0.0, None)
    albedo = _hard_albedo(points) * (0.3 + 0.7 * ndl)[..., None]
    colors = np.clip(albedo * 255.0, 0, 255).astype(np.uint8)
    colors = np.concatenate(
        [colors, np.full((len(points), 1), 255, np.uint8)], axis=1
    )
    return points.astype(np.float64), colors


def sample_hard_rays(
    rng: np.random.Generator, num_rays: int, radius: float = 2.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Rays from a camera shell aimed at the hard scene's objects."""
    o = rng.normal(size=(num_rays, 3))
    o *= radius / np.linalg.norm(o, axis=1, keepdims=True)
    centers = [c for c, _ in _HARD_SPHERES]
    centers.append((_HARD_PLATE[0] + _HARD_PLATE[1]) / 2.0)
    k = rng.integers(len(centers), size=num_rays)
    target = np.stack(centers)[k] + rng.uniform(-0.45, 0.45, size=(num_rays, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def hard_ray_targets(
    origins: np.ndarray, directions: np.ndarray
) -> np.ndarray:
    """Analytic ground truth for the hard scene: nearest hit among the
    two textured spheres and the thin plate, shaded with Lambert +
    view-dependent specular; white background."""
    o = origins.astype(np.float64)
    d = directions.astype(np.float64)
    best_t = np.full(len(o), np.inf)
    best_n = np.zeros((len(o), 3))
    for c, r in _HARD_SPHERES:
        oc = o - c[None]
        b = np.sum(oc * d, axis=1)
        cc = np.sum(oc * oc, axis=1) - r * r
        disc = b * b - cc
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (t > 1e-6) & (t < best_t)
        p = o + t[:, None] * d
        best_n = np.where(hit[:, None], (p - c[None]) / r, best_n)
        best_t = np.where(hit, t, best_t)
    # Thin AABB plate via the slab test; the entry face's axis gives the
    # normal.
    lo, hi = _HARD_PLATE
    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.where(d >= 0, 1e-12, -1e-12), d)
    t_lo = (lo[None] - o) * inv
    t_hi = (hi[None] - o) * inv
    t1 = np.minimum(t_lo, t_hi)
    t2 = np.maximum(t_lo, t_hi)
    t_near = t1.max(axis=1)
    t_far = t2.min(axis=1)
    hit = (t_near <= t_far) & (t_near > 1e-6) & (t_near < best_t)
    axis = np.argmax(t1, axis=1)
    sign = -np.sign(np.take_along_axis(d, axis[:, None], axis=1)[:, 0])
    n_plate = np.zeros((len(o), 3))
    np.put_along_axis(n_plate, axis[:, None], sign[:, None], axis=1)
    best_n = np.where(hit[:, None], n_plate, best_n)
    best_t = np.where(hit, t_near, best_t)
    rgb = np.ones((len(o), 3), np.float32)
    m = np.isfinite(best_t)
    if m.any():
        p = o[m] + best_t[m, None] * d[m]
        rgb[m] = _hard_shade(p, best_n[m], d[m])
    return rgb



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
