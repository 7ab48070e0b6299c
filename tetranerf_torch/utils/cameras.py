"""Camera distortion models and ray-direction undistortion (host-side).

The port's copy of :mod:`tetranerf_tpu.utils.cameras` (numpy only), so
that the port runs where the JAX package is absent; a test holds the two
equal.

The reference supports COLMAP's camera-model zoo by converting every model
to OpenCV-style intrinsics + distortion coefficients
(``tetranerf/scripts/utils.py:54-252``) and letting nerfstudio undistort
when generating rays. This module provides the same coverage natively:

- ``distort_*`` — forward distortion of ideal (pinhole) normalized camera
  coordinates, per COLMAP's `camera_models.h` conventions.
- ``undistort_*`` — the inverse maps, via fixed-point / Newton iteration
  (the standard approach; closed forms do not exist).
- :class:`Distortion` — a small value object bundling the camera type and
  coefficient array, with ``undistort(x, y)`` used by ray generation.

Camera types:
- ``"perspective"`` — radial (k1..k6) + tangential (p1, p2); covers
  SIMPLE_PINHOLE/PINHOLE (no coefficients), SIMPLE_RADIAL, RADIAL,
  OPENCV, FULL_OPENCV.
- ``"fisheye"`` — equidistant projection with k1..k4 polynomial in theta;
  covers OPENCV_FISHEYE, SIMPLE_RADIAL_FISHEYE, RADIAL_FISHEYE.
- ``"fov"`` — the Devernay-Faugeras FOV model (omega); COLMAP ``FOV``.

All functions are vectorized numpy over coordinate arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Coefficient layout used throughout: [k1, k2, p1, p2, k3, k4, k5, k6]
# (perspective); [k1, k2, k3, k4, 0, 0, 0, 0] (fisheye); [omega, 0, ...]
# (fov). Matches the order OpenCV uses for its rational model.
NUM_COEFFS = 8


# ------------------------------------------------------------- perspective
def distort_radtan(x, y, coeffs):
    """OpenCV rational radial + tangential distortion of ideal coords."""
    k1, k2, p1, p2, k3, k4, k5, k6 = np.moveaxis(
        np.broadcast_to(coeffs, (*np.shape(x), NUM_COEFFS)), -1, 0
    )
    r2 = x * x + y * y
    radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (
        1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    )
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def undistort_radtan(xd, yd, coeffs, num_iters: int = 25):
    """Invert :func:`distort_radtan` by fixed-point iteration
    (the same scheme OpenCV's ``undistortPoints`` uses)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = np.moveaxis(
        np.broadcast_to(coeffs, (*np.shape(xd), NUM_COEFFS)), -1, 0
    )
    x, y = np.array(xd, np.float64), np.array(yd, np.float64)
    for _ in range(num_iters):
        r2 = x * x + y * y
        radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (
            1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
        )
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


# ---------------------------------------------------------------- fisheye
def distort_fisheye(x, y, coeffs):
    """OpenCV fisheye (equidistant) distortion of ideal coords."""
    k1, k2, k3, k4 = np.moveaxis(
        np.broadcast_to(coeffs, (*np.shape(x), NUM_COEFFS)), -1, 0
    )[:4]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = np.where(r > 1e-12, theta_d / np.maximum(r, 1e-12), 1.0)
    return x * scale, y * scale


def undistort_fisheye(xd, yd, coeffs, num_iters: int = 25):
    """Invert :func:`distort_fisheye`: Newton-solve theta from theta_d,
    then map back through ``r = tan(theta)``."""
    k1, k2, k3, k4 = np.moveaxis(
        np.broadcast_to(coeffs, (*np.shape(xd), NUM_COEFFS)), -1, 0
    )[:4]
    theta_d = np.sqrt(np.asarray(xd) ** 2 + np.asarray(yd) ** 2)
    theta = np.array(theta_d, np.float64)
    for _ in range(num_iters):
        t2 = theta * theta
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        dpoly = (
            3.0 * k1 * t2
            + 5.0 * k2 * t2 * t2
            + 7.0 * k3 * t2 * t2 * t2
            + 9.0 * k4 * t2 * t2 * t2 * t2
        )
        f = theta * poly - theta_d
        theta = theta - f / np.maximum(poly + dpoly, 1e-12)
    r = np.tan(theta)
    scale = np.where(theta_d > 1e-12, r / np.maximum(theta_d, 1e-12), 1.0)
    return xd * scale, yd * scale


# -------------------------------------------------------------------- fov
def distort_fov(x, y, coeffs):
    """Devernay-Faugeras FOV model (COLMAP ``FOV``): omega in coeffs[0]."""
    omega = np.broadcast_to(coeffs, (*np.shape(x), NUM_COEFFS))[..., 0]
    r = np.sqrt(x * x + y * y)
    factor = np.where(
        np.abs(omega) > 1e-9,
        np.arctan(2.0 * r * np.tan(omega / 2.0)) / np.maximum(r * omega, 1e-12),
        1.0,
    )
    factor = np.where(r > 1e-12, factor, 1.0)
    return x * factor, y * factor


def undistort_fov(xd, yd, coeffs, num_iters: int = 0):
    """Closed-form inverse of the FOV model."""
    del num_iters
    omega = np.broadcast_to(coeffs, (*np.shape(xd), NUM_COEFFS))[..., 0]
    rd = np.sqrt(np.asarray(xd) ** 2 + np.asarray(yd) ** 2)
    factor = np.where(
        (np.abs(omega) > 1e-9) & (rd > 1e-12),
        np.tan(rd * omega) / np.maximum(2.0 * rd * np.tan(omega / 2.0), 1e-12),
        1.0,
    )
    return xd * factor, yd * factor


_DISTORT = {
    "perspective": distort_radtan,
    "fisheye": distort_fisheye,
    "fov": distort_fov,
}
_UNDISTORT = {
    "perspective": undistort_radtan,
    "fisheye": undistort_fisheye,
    "fov": undistort_fov,
}


@dataclasses.dataclass(frozen=True)
class Distortion:
    """Camera type + per-image coefficient rows ``[N, 8]`` (or ``[8]``)."""

    camera_type: str  # "perspective" | "fisheye" | "fov"
    coeffs: np.ndarray

    def __post_init__(self):
        if self.camera_type not in _DISTORT:
            raise ValueError(f"unknown camera type {self.camera_type!r}")

    @property
    def is_identity(self) -> bool:
        return self.camera_type == "perspective" and not np.any(self.coeffs)

    def distort(self, x, y, idx=None):
        return _DISTORT[self.camera_type](x, y, self._rows(idx, x))

    def undistort(self, x, y, idx=None):
        if self.is_identity:
            return x, y
        return _UNDISTORT[self.camera_type](x, y, self._rows(idx, x))

    def _rows(self, idx, ref):
        c = np.asarray(self.coeffs, np.float64)
        if c.ndim == 1 or idx is None:
            return c if c.ndim == 1 else c[0]
        return c[np.asarray(idx)]


def identity_distortion(n: int = 1) -> Distortion:
    return Distortion("perspective", np.zeros((n, NUM_COEFFS)))


def distortion_from_intrinsics(intr: dict) -> np.ndarray:
    """Pack a ``camera_intrinsics`` dict into the [8] coefficient row.

    ``intr["camera_type"]`` decides interpretation: perspective uses
    (k1,k2,p1,p2,k3,k4,k5,k6); fisheye uses (k1..k4); fov uses (omega).
    """
    c = np.zeros(NUM_COEFFS)
    t = intr.get("camera_type", "perspective")
    if t == "perspective":
        for i, k in enumerate(("k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6")):
            c[i] = intr.get(k, 0.0)
    elif t == "fisheye":
        for i, k in enumerate(("k1", "k2", "k3", "k4")):
            c[i] = intr.get(k, 0.0)
    elif t == "fov":
        c[0] = intr.get("omega", 0.0)
    else:
        raise ValueError(f"unknown camera type {t!r}")
    return c
