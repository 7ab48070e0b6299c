"""Bound and budget rounding: copies of ``grid_ceil``, ``rounded_bound``,
``inner_bound`` and ``scaled_budget`` from :mod:`tetranerf_tpu.utils.shapes`,
so that the bounds and sample budgets tuned by the port's trainer land where
the JAX trainer's would."""

from __future__ import annotations

import numpy as np

BOUND_GRID = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def grid_ceil(n) -> int:
    """Smallest ``BOUND_GRID`` value >= n (multiples of 256 above it)."""
    for g in BOUND_GRID:
        if g >= n:
            return g
    return int(np.ceil(n / 256)) * 256


def rounded_bound(crossings) -> int:
    """Traversal bound from an observed crossing count: 1.5x margin,
    rounded up to the grid."""
    return grid_ceil(max(16.0, float(crossings) * 1.5))


def inner_bound(crossings, margin: float = 1.15) -> int:
    """Quantile-bucket bound from a chunk's crossing count: a small margin,
    rounded up to a multiple of 8."""
    b = max(16.0, float(crossings) * margin)
    return int(-(-b // 8) * 8)


def scaled_budget(base: int, t: int, t_full: int, floor: int = 16) -> int:
    """Sample budget of a bucket bounded at ``t`` of ``t_full`` steps: the
    base budget scaled with the bound, rounded up to the grid, floored at
    ``floor``; a zero budget stays 0."""
    if not base:
        return base
    frac = t / max(t_full, 1)
    return min(base, grid_ceil(max(floor, base * frac)))
