"""The Tetra-NeRF model: march -> sampling -> field -> MLPs -> rendering.

Counterpart of :class:`tetranerf_tpu.models.tetra_nerf.TetraNerf`, render
(eval) forward with ``ray_buckets=1``. The module holds the per-vertex
feature field ``tetrahedra_field [V, F]`` (vertex-major, as in the JAX
package) and the four MLP parts; the mesh is passed to each call.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import nerf_encoding, nerf_encoding_dim
from ..ops.fused import (
    biased_warp_range,
    march_features,
    ray_bounds,
    sample_features,
)
from ..ops.rendering import render_rgb_depth_acc, render_weights
from ..ops.sampling import pdf_sample, stratified_bins
from .config import TetrahedraNerfConfig, check_supported
from .nn import MLP, Linear

_DIR_FREQS = 4


class TetraNerf(nn.Module):
    """Usage::

        model = TetraNerf(config, mesh.num_vertices, point_colors=colors,
                          generator=torch.Generator().manual_seed(0))
        out = model.get_outputs(origins, directions, mesh)
    """

    def __init__(
        self,
        config: TetrahedraNerfConfig,
        num_vertices: int,
        num_train_images: int = 0,
        point_colors=None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        check_supported(config)
        self.config = config
        cfg = config
        g = generator
        field = torch.empty(num_vertices, cfg.field_dim, device=device)
        field.uniform_(-1e-4, 1e-4, generator=g)
        if cfg.initialize_colors and point_colors is not None:
            # Channels 1..3 from the point colours in [-1, 1], channel 0 from
            # alpha (or 1); reference model.py:337-343, 380-386.
            colors = torch.as_tensor(point_colors).to(field.device, torch.float32)
            field[:, 1:4] = colors[:, :3] * 2.0 / 255.0 - 1.0
            if colors.shape[1] >= 4:
                field[:, 0] = colors[:, 3] * 2.0 / 255.0 - 1.0
            else:
                field[:, 0] = 1.0
        self.tetrahedra_field = nn.Parameter(field)
        mlp_in = nerf_encoding_dim(cfg.field_dim, cfg.input_fourier_frequencies)
        head_in = (
            cfg.hidden_size + nerf_encoding_dim(3, _DIR_FREQS)
            + cfg.appearance_embed_dim
        )
        kw = dict(generator=g, device=device)
        self.mlp_base = MLP(mlp_in, cfg.num_density_layers, cfg.hidden_size, **kw)
        self.mlp_head = MLP(head_in, cfg.num_color_layers, cfg.hidden_size, **kw)
        self.field_output_color = Linear(cfg.hidden_size, 3, **kw)
        self.field_output_density = Linear(cfg.hidden_size, 1, **kw)
        if cfg.appearance_embed_dim > 0:
            self.appearance_embedding = nn.Parameter(
                torch.randn(
                    num_train_images, cfg.appearance_embed_dim, generator=g,
                    device=device,
                )
            )

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.config.compute_dtype)

    # --------------------------------------------------------------- helpers
    def _base(self, field_values):
        cfg = self.config
        x = field_values
        if cfg.input_fourier_frequencies > 0:
            n = cfg.input_fourier_frequencies
            x = nerf_encoding(x, n, 0.0, float(n))
        dt = self.compute_dtype
        base_out = self.mlp_base(x, torch.relu, dt, dt)
        density = F.softplus(self.field_output_density(base_out, dt)[..., 0])
        return base_out, density

    def density_mlp(self, field_values):
        """Density ``f32[R, S]`` only: the coarse PDF round reads no colour."""
        return self._base(field_values)[1].float()

    def field_mlps(self, field_values, directions):
        """``(rgb f32[R, S, 3], density f32[R, S])`` at per-sample features
        ``[R, S, F]`` seen along ``directions [R, 3]``."""
        dt = self.compute_dtype
        base_out, density = self._base(field_values)
        num_rays, num_samples = base_out.shape[:2]
        dir_enc = nerf_encoding(directions, _DIR_FREQS, 0.0, 4.0)  # [R, 27]
        head_in = [dir_enc.to(dt)[:, None, :].expand(-1, num_samples, -1),
                   base_out.to(dt)]
        if self.config.appearance_embed_dim > 0:
            # Eval: the mean embedding (no camera indices on this path).
            app = self.appearance_embedding.mean(dim=0).to(dt)
            head_in.append(app.expand(num_rays, num_samples, -1))
        head_out = self.mlp_head(torch.cat(head_in, dim=-1), torch.relu, dt, dt)
        rgb = torch.sigmoid(self.field_output_color(head_out, dt))
        return rgb.float(), density.float()

    def background(self, num_rays: int, device) -> torch.Tensor:
        """Eval background; ``"random"`` is grey at eval, as in the JAX
        package without a key. ``"last_sample"`` is handled by the caller."""
        color = self.config.background_color
        value = {"white": 1.0, "black": 0.0, "random": 0.5}.get(color)
        if value is None:
            raise NotImplementedError(color)
        return torch.full((num_rays, 3), value, device=device)

    # --------------------------------------------------------------- forward
    def get_outputs(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        mesh,
        max_steps: Optional[int] = None,
        num_samples: Optional[int] = None,
        num_fine_samples: Optional[int] = None,
        occ_depth_cap=None,
    ) -> Dict[str, torch.Tensor]:
        """Render (eval) forward of rays ``[R, 3]`` through ``mesh`` (a
        :class:`~..geometry.TorchMesh` on the rays' device).

        Returns ``rgb [R, 3]``, ``accumulation [R, 1]``, ``depth [R, 1]``,
        ``ray_mask [R]`` and ``traversal_overflow [R]`` (rays whose march
        reached ``max_steps`` before ending)."""
        cfg = self.config
        max_steps = max_steps or cfg.max_intersected_triangles
        n_coarse = cfg.num_samples if num_samples is None else num_samples
        n_fine = cfg.num_fine_samples if num_fine_samples is None else num_fine_samples
        num_rays = origins.shape[0]
        dev = origins.device

        res = march_features(
            mesh, self.tetrahedra_field, origins, directions, max_steps,
            use_occupancy=cfg.use_occupancy_field,
            occ_threshold=cfg.occupancy_threshold,
            occ_depth_cap=occ_depth_cap,
        )
        nears, fars, first_kept, num_kept, ray_mask = ray_bounds(res)
        span = (fars - nears)[:, None]

        bins01 = stratified_bins(num_rays, n_coarse, device=dev)
        euclid = nears[:, None] + bins01 * span
        if cfg.use_biased_sampler:
            euclid = biased_warp_range(res, first_kept, num_kept, nears, fars, euclid)
        spacing = (euclid - nears[:, None]) / span

        def run_field(bins):
            distances = (bins[:, 1:] + bins[:, :-1]) / 2.0
            deltas = bins[:, 1:] - bins[:, :-1]
            field_values, smask = sample_features(res, distances, ray_mask)
            return distances, deltas, smask, field_values

        if n_fine > 0:
            _, deltas, smask, field_values = run_field(euclid)
            density_c = torch.where(smask, self.density_mlp(field_values), 0.0)
            weights_c = render_weights(density_c, deltas)
            spacing = pdf_sample(spacing, weights_c, n_fine, include_original=True)
            euclid = nears[:, None] + spacing * span

        distances, deltas, smask, field_values = run_field(euclid)
        rgb, density = self.field_mlps(field_values, directions)
        density = torch.where(smask, density, 0.0)
        # Gradient scaling (use_gradient_scaling) is the identity in the
        # forward; it only rescales gradients in training.
        weights = render_weights(density, deltas)
        if cfg.background_color == "last_sample":
            background = rgb[:, -1, :]
        else:
            background = self.background(num_rays, dev)
        rgb_out, acc, depth = render_rgb_depth_acc(
            weights, rgb, distances, background_rgb=background,
            depth_method=cfg.depth_method,
        )
        rgb_out = torch.where(ray_mask[:, None], rgb_out, background)
        acc = torch.where(ray_mask, acc, 0.0)
        depth = torch.where(ray_mask & (acc > 0), depth, cfg.far_plane)
        return {
            "rgb": rgb_out,
            "accumulation": acc[:, None],
            "depth": depth[:, None],
            "ray_mask": ray_mask,
            "traversal_overflow": res.overflow,
        }
