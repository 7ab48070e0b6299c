"""Chunked ray rendering: the serving path.

Counterpart of ``Trainer.render_rays`` / ``_chunked`` / ``eval_batch`` in
:mod:`tetranerf_tpu.training.trainer`, as ``scripts/render.py`` drives it:
rays go through the model in fixed-size chunks, the tail chunk padded with
dummy rays, and per-ray outputs come back as numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class Renderer:
    """Renders rays with ``model`` (a :class:`~.models.TetraNerf`) through
    ``mesh`` (a :class:`~.geometry.TorchMesh`), both moved to ``device``.

    ``occ_depth_cap`` is the optical depth at which the march stops a ray
    when the config uses the occupancy field; None means
    ``-log(occupancy_threshold)``, the JAX trainer's initial cap."""

    def __init__(self, model, mesh, device, occ_depth_cap=None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh.to(self.device)
        self.occ_depth_cap = occ_depth_cap

    @torch.inference_mode()
    def render_rays(self, origins, directions, chunk: int = 8192) -> Dict[str, np.ndarray]:
        """Render ``[N, 3]`` rays; returns ``rgb [N, 3]``, ``depth [N, 1]``,
        ``accumulation [N, 1]``, ``ray_mask [N]`` and
        ``traversal_overflow [N]``."""
        origins = torch.as_tensor(origins, dtype=torch.float32)
        directions = torch.as_tensor(directions, dtype=torch.float32)
        num = origins.shape[0]
        dev = self.device
        # Padding rays: from the origin straight along +z.
        pad_dir = torch.tensor([0.0, 0.0, 1.0], device=dev)
        outs = []
        for i in range(0, num, chunk):
            o = origins[i : i + chunk].to(dev)
            d = directions[i : i + chunk].to(dev)
            pad = chunk - o.shape[0]
            if pad:
                o = torch.cat([o, torch.zeros((pad, 3), device=dev)])
                d = torch.cat([d, pad_dir.expand(pad, 3)])
            out = self.model.get_outputs(
                o, d, self.mesh, occ_depth_cap=self.occ_depth_cap
            )
            outs.append({k: v[: chunk - pad] for k, v in out.items()})
        return {
            k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]
        }
