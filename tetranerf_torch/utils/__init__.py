"""Synthetic scenes, rays and their targets (numpy), as the tests and the
smoke runs use them."""

from .synthetic import (
    camera_ray_targets,
    hard_ray_targets,
    make_camera_scene,
    make_hard_scene,
    make_sphere_scene,
    sample_camera_rays,
    sample_hard_rays,
    sample_sphere_rays,
    sphere_ray_targets,
)

__all__ = [
    "camera_ray_targets",
    "hard_ray_targets",
    "make_camera_scene",
    "make_hard_scene",
    "make_sphere_scene",
    "sample_camera_rays",
    "sample_hard_rays",
    "sample_sphere_rays",
    "sphere_ray_targets",
]
