"""Chunked ray rendering: the serving path.

Counterpart of ``Trainer.render_rays`` / ``_chunked`` / ``eval_batch`` in
:mod:`tetranerf_tpu.training.trainer`, as ``scripts/render.py`` drives it:
rays go through the model in fixed-size chunks, the tail chunk padded with
dummy rays, and per-ray outputs come back as numpy arrays
(:meth:`Renderer.render_rays`) or as tensors on the device
(:meth:`Renderer.render_tensors`, the torch serving API's path).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def chunks(origins, directions, chunk: int, device):
    """``[N, 3]`` rays in chunks of ``chunk`` on ``device``, as ``(origins,
    directions, rays)``: the last chunk padded with rays from the origin
    along +z, ``rays`` the number of real ones."""
    origins = torch.as_tensor(origins, dtype=torch.float32)
    directions = torch.as_tensor(directions, dtype=torch.float32)
    pad_dir = torch.tensor([0.0, 0.0, 1.0], device=device)
    for i in range(0, origins.shape[0], chunk):
        o = origins[i : i + chunk].to(device)
        d = directions[i : i + chunk].to(device)
        num = o.shape[0]
        if num < chunk:
            o = torch.cat([o, torch.zeros((chunk - num, 3), device=device)])
            d = torch.cat([d, pad_dir.expand(chunk - num, 3)])
        yield o, d, num


class Renderer:
    """Renders rays with ``model`` (a :class:`~.models.TetraNerf`) through
    ``mesh`` (a :class:`~.geometry.TorchMesh`), both moved to ``device``.

    ``occ_depth_cap`` is the optical depth at which the march stops a ray
    when the config uses the occupancy field; None means
    ``-log(occupancy_threshold)``, the JAX trainer's initial cap.
    ``max_steps`` and ``bucket_steps`` are the march bound and the inner
    bucket bounds (a trainer's tuned ones, :meth:`~.training.trainer.Trainer.
    renderer`); None means the configured bound and, with ``ray_buckets >=
    2``, its untuned linear split, as the JAX model's eval without a
    trainer."""

    def __init__(self, model, mesh, device, occ_depth_cap=None,
                 max_steps: Optional[int] = None,
                 bucket_steps: Optional[Sequence[int]] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh.to(self.device)
        self.occ_depth_cap = occ_depth_cap
        self.max_steps = max_steps
        self.bucket_steps = bucket_steps

    @torch.inference_mode()
    def render_batch(self, origins, directions, num_samples: Optional[int] = None,
                     num_fine_samples: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The eval forward of one batch of rays ``[R, 3]``, as tensors on
        the device: ``rgb [R, 3]``, ``depth [R, 1]``, ``accumulation [R, 1]``,
        ``ray_mask [R]`` and ``traversal_overflow [R]``.
        ``num_samples``/``num_fine_samples`` override the sample budget."""
        return self.model.get_outputs(
            torch.as_tensor(origins, dtype=torch.float32, device=self.device),
            torch.as_tensor(directions, dtype=torch.float32, device=self.device),
            self.mesh, max_steps=self.max_steps, num_samples=num_samples,
            num_fine_samples=num_fine_samples, occ_depth_cap=self.occ_depth_cap,
            bucket_steps=self.bucket_steps,
        )

    def render_tensors(self, origins, directions, chunk: int = 8192,
                       num_samples: Optional[int] = None,
                       num_fine_samples: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Render ``[N, 3]`` rays in chunks of ``chunk`` (the last one padded
        with rays from the origin along +z); returns the outputs of
        :meth:`render_batch` for the ``N`` rays as tensors on the device."""
        outs = []
        for o, d, num in chunks(origins, directions, chunk, self.device):
            out = self.render_batch(o, d, num_samples, num_fine_samples)
            outs.append({k: v[:num] for k, v in out.items()})
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def render_rays(self, origins, directions, chunk: int = 8192,
                    num_samples: Optional[int] = None,
                    num_fine_samples: Optional[int] = None) -> Dict[str, np.ndarray]:
        """:meth:`render_tensors` as numpy arrays."""
        out = self.render_tensors(origins, directions, chunk, num_samples, num_fine_samples)
        return {k: v.cpu().numpy() for k, v in out.items()}
