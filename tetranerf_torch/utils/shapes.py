"""Traversal-bound rounding: copies of ``grid_ceil`` and ``rounded_bound``
from :mod:`tetranerf_tpu.utils.shapes`, so that a bound tuned by the port's
trainer lands where the JAX trainer's would."""

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
