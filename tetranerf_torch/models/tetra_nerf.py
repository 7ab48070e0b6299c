"""The Tetra-NeRF model: march -> sampling -> field -> MLPs -> rendering.

Counterpart of :class:`tetranerf_tpu.models.tetra_nerf.TetraNerf`: the
render (eval) forward and the train forward, whose backward runs through
the kernels' autograd Functions (``ops.interp``, and with ``fused_mlps`` the
fused MLP kernels of ``ops.mlp``), plain or in quantile buckets
(``ray_buckets >= 2``, each bucket cut from one march by the row gather
K8; ``bucket_merge_mlps`` runs each MLP round over all buckets at once).
The module holds the per-vertex feature field ``tetrahedra_field [V, F]``
(vertex-major, as in the JAX package) and the four MLP parts; the mesh is
passed to each call.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import nerf_encoding, nerf_encoding_dim
from ..ops.fused import (
    biased_warp_range,
    endpoint_features,
    endpoint_features_batch,
    march_features,
    ray_bounds,
    sample_features,
    slice_march_buckets,
)
from ..ops.march import FusedMarch
from ..ops.mlp import FusedDensityMLP, FusedFieldMLPs, as_operand
from ..ops.rendering import render_rgb_depth_acc, render_weights
from ..ops.sampling import pdf_sample, stratified_bins
from ..utils.shapes import scaled_budget
from .config import TetrahedraNerfConfig, check_supported
from .nn import MLP, Linear

_DIR_FREQS = 4


class GradientScaler(torch.autograd.Function):
    """Identity on ``(colors [R, S, 3], sigmas [R, S])``; the backward scales
    both gradients by ``scaling [R, S]`` (``_gradient_scaler`` of the JAX
    model, reference ``model.py:625-630``)."""

    @staticmethod
    def forward(ctx, colors, sigmas, scaling):
        ctx.save_for_backward(scaling)
        return colors.view_as(colors), sigmas.view_as(sigmas)

    @staticmethod
    def backward(ctx, g_colors, g_sigmas):
        (scaling,) = ctx.saved_tensors
        return g_colors * scaling[..., None], g_sigmas * scaling, None


def draw_uniforms(num_rays, num_samples, num_fine_samples, generator=None,
                  device=None) -> Dict[str, torch.Tensor]:
    """The train forward's random numbers, uniform in [0, 1): the coarse
    bin jitter ``[R, S+1]``, the PDF strata ``[R, N+1]`` and the
    ``"random"`` background ``[R, 3]``, drawn from ``generator`` on its own
    device and placed on ``device``."""
    gdev = generator.device if generator is not None else device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=gdev).to(device)

    return {
        "coarse": rand(num_rays, num_samples + 1),
        "fine": rand(num_rays, num_fine_samples + 1),
        "background": rand(num_rays, 3),
    }


class TetraNerf(nn.Module):
    """Usage::

        model = TetraNerf(config, mesh.num_vertices, point_colors=colors,
                          generator=torch.Generator().manual_seed(0))
        out = model.get_outputs(origins, directions, mesh)

    Parameters are drawn on the CPU from ``generator`` and then moved to
    ``device``, so a seed gives the same weights on every device."""

    def __init__(
        self,
        config: TetrahedraNerfConfig,
        num_vertices: int,
        num_train_images: int = 0,
        point_colors=None,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        check_supported(config)
        self.config = config
        cfg = config
        g = generator
        field = torch.empty(num_vertices, cfg.field_dim)
        field.uniform_(-1e-4, 1e-4, generator=g)
        if cfg.initialize_colors and point_colors is not None:
            # Channels 1..3 from the point colours in [-1, 1], channel 0 from
            # alpha (or 1); reference model.py:337-343, 380-386.
            colors = torch.as_tensor(point_colors).to(torch.float32)
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
        self.mlp_base = MLP(mlp_in, cfg.num_density_layers, cfg.hidden_size,
                            generator=g)
        self.mlp_head = MLP(head_in, cfg.num_color_layers, cfg.hidden_size,
                            generator=g)
        self.field_output_color = Linear(cfg.hidden_size, 3, generator=g)
        self.field_output_density = Linear(cfg.hidden_size, 1, generator=g)
        if cfg.appearance_embed_dim > 0:
            self.appearance_embedding = nn.Parameter(
                torch.randn(
                    num_train_images, cfg.appearance_embed_dim, generator=g
                )
            )
        self.to(device)

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

    def density_at(self, field_values):
        """Density ``f32[...]`` only, at feature vectors ``[..., F]``, on the
        plain path: the occupancy updates read no colour (and stay un-fused
        with ``fused_mlps``, as in the JAX trainer)."""
        return self._base(field_values)[1].float()

    @property
    def _fused(self) -> bool:
        """The fused kernels (K4/K5) run the MLPs: ``fused_mlps`` without a
        Fourier input encoding, as in the JAX model."""
        cfg = self.config
        return cfg.fused_mlps and cfg.input_fourier_frequencies == 0

    def density_weights(self):
        """The fused density kernel's flat weights (``ops.mlp``): base
        ``(W, b)`` pairs, then the density layer's."""
        weights = []
        for layer in self.mlp_base.layers:
            weights += [layer.weight, layer.bias]
        return weights + [self.field_output_density.weight,
                          self.field_output_density.bias]

    def density_mlp(self, field_values):
        """Density ``f32[R, S]`` of the coarse PDF round at features
        ``[R, S, F]``: the fused density kernel K5 with ``fused_mlps``
        (JAX ``_density_mlp``), else :meth:`density_at`."""
        if self._fused:
            return FusedDensityMLP.apply(
                field_values, len(self.mlp_base.layers), self.compute_dtype,
                *self.density_weights(),
            )[..., 0]
        return self.density_at(field_values)

    def _appearance(self, num_rays, camera_indices):
        emb = self.appearance_embedding
        if camera_indices is not None:
            return emb[torch.as_tensor(camera_indices, device=emb.device).long()]
        return emb.mean(dim=0).expand(num_rays, -1)

    def fused_field_inputs(self, directions, camera_indices=None):
        """``(head_dir f32[R, H], weights)`` of the fused field kernel
        (``ops.mlp``, JAX ``_field_mlps_fused``). The first head layer's
        direction and appearance columns and its bias act per ray, so they
        enter as ``head_dir``, computed here at ``[R, H]`` cost; its
        base-feature columns go into ``weights``. Autograd carries the
        gradients back through the column slices."""
        cfg = self.config
        dt = self.compute_dtype
        head0 = self.mlp_head.layers[0]
        w0 = head0.weight  # [H, 27 + H + A]: direction, base, appearance columns
        d_dir, hidden = nerf_encoding_dim(3, _DIR_FREQS), cfg.hidden_size
        dir_enc = nerf_encoding(directions, _DIR_FREQS, 0.0, 4.0)  # [R, 27]
        head_dir = (as_operand(dir_enc, dt) @ as_operand(w0[:, :d_dir], dt).T
                    + head0.bias)
        if cfg.appearance_embed_dim > 0:
            app = self._appearance(directions.shape[0], camera_indices)
            head_dir = head_dir + (as_operand(app, dt)
                                   @ as_operand(w0[:, d_dir + hidden:], dt).T)
        weights = self.density_weights() + [w0[:, d_dir : d_dir + hidden]]
        for layer in self.mlp_head.layers[1:]:
            weights += [layer.weight, layer.bias]
        weights += [self.field_output_color.weight, self.field_output_color.bias]
        return head_dir, weights

    def _field_mlps_fused(self, field_values, directions, camera_indices):
        head_dir, weights = self.fused_field_inputs(directions, camera_indices)
        rgb, density = FusedFieldMLPs.apply(
            field_values, head_dir, len(self.mlp_base.layers),
            len(self.mlp_head.layers), self.compute_dtype, *weights,
        )
        return rgb, density[..., 0]

    def field_mlps(self, field_values, directions, camera_indices=None):
        """``(rgb f32[R, S, 3], density f32[R, S])`` at per-sample features
        ``[R, S, F]`` seen along ``directions [R, 3]``. With an appearance
        embedding, ``camera_indices i32[R]`` pick each ray's row; without
        them every ray takes the mean row (eval). With ``fused_mlps`` (and
        no Fourier input encoding) the fused field kernel K4 runs them."""
        if self._fused:
            return self._field_mlps_fused(field_values, directions, camera_indices)
        return self.plain_field_mlps(field_values, directions, camera_indices)

    def plain_field_mlps(self, field_values, directions, camera_indices=None):
        """:meth:`field_mlps` on the plain path whatever ``fused_mlps`` says
        (the transmittance probe's, as in the JAX trainer)."""
        dt = self.compute_dtype
        base_out, density = self._base(field_values)
        num_rays, num_samples = base_out.shape[:2]
        dir_enc = nerf_encoding(directions, _DIR_FREQS, 0.0, 4.0)  # [R, 27]
        head_in = [dir_enc.to(dt)[:, None, :].expand(-1, num_samples, -1),
                   base_out.to(dt)]
        if self.config.appearance_embed_dim > 0:
            app = self._appearance(num_rays, camera_indices)
            head_in.append(app.to(dt)[:, None, :].expand(-1, num_samples, -1))
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
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        uniforms=None,
        camera_indices=None,
        bucket_steps: Optional[Sequence[int]] = None,
        short_steps: Optional[int] = None,
        cached_march: Optional[FusedMarch] = None,
    ) -> Dict[str, torch.Tensor]:
        """Forward of rays ``[R, 3]`` through ``mesh`` (a
        :class:`~..geometry.TorchMesh` on the rays' device).

        ``train=True`` is the train forward (``TetraNerf._forward`` of the
        JAX model with ``train=True``): stratified coarse bins, stratified
        PDF samples and a random background (``"random"`` only), from
        ``uniforms`` (keys of :func:`draw_uniforms`; with bucketed shading
        a list of such dicts, one per bucket of :meth:`bucket_plan` in
        bucket order) or else drawn from ``generator``, bucket by bucket;
        per-ray appearance rows from ``camera_indices``. The coarse round
        runs without autograd, as the JAX model stops its gradients.

        With ``ray_buckets >= 2`` the rays are shaded in quantile buckets
        of their crossing count at the bounds of :meth:`bucket_bounds`
        (``bucket_steps`` are the trainer's tuned inner bounds); when every
        bound equals ``max_steps`` bucketing is a no-op and the plain
        forward runs. ``cached_march`` re-shades a geometry-only march of
        the same rays against the current field.

        Returns ``rgb [R, 3]``, ``accumulation [R, 1]``, ``depth [R, 1]``,
        ``ray_mask [R]`` and ``traversal_overflow [R]`` (rays whose march
        reached its bound, or a bucket's bound, before ending)."""
        cfg = self.config
        max_steps = max_steps or cfg.max_intersected_triangles
        n_coarse = cfg.num_samples if num_samples is None else num_samples
        n_fine = cfg.num_fine_samples if num_fine_samples is None else num_fine_samples
        if not train:
            camera_indices = None
        elif camera_indices is not None:
            camera_indices = torch.as_tensor(camera_indices, device=origins.device)
        if cfg.ray_buckets >= 2:
            if cached_march is not None:
                max_steps = cached_march.t1.shape[1]
            bounds = self.bucket_bounds(max_steps, short_steps, bucket_steps)
            if any(b < max_steps for b in bounds):
                return self._get_outputs_bucketed(
                    origins, directions, mesh, bounds, n_coarse, n_fine,
                    occ_depth_cap, train, generator, uniforms, camera_indices,
                    cached_march,
                )
        return self._forward(
            origins, directions, mesh, max_steps, n_coarse, n_fine,
            occ_depth_cap, train, generator, uniforms, camera_indices,
            cached_march,
        )

    def bucket_bounds(self, max_steps: int, short_steps: Optional[int] = None,
                      bucket_steps: Optional[Sequence[int]] = None) -> tuple:
        """The ``ray_buckets`` ascending bounds of quantile-bucketed shading,
        the deepest at ``max_steps`` (JAX ``_bucket_bounds``). Priority:
        ``bucket_steps`` (trainer-tuned inner bounds), then ``short_steps``
        or ``config.bucket_short_steps`` interpolated linearly, then an
        untuned linear split."""
        cfg = self.config
        k_buckets = cfg.ray_buckets
        if bucket_steps is not None:
            inner = [int(b) for b in bucket_steps][: k_buckets - 1]
        else:
            short = short_steps or cfg.bucket_short_steps
            if short is None:
                inner = [max(16, max_steps * (k + 1) // k_buckets)
                         for k in range(k_buckets - 1)]
            else:
                inner = [int(short + (max_steps - short) * k / max(k_buckets - 1, 1))
                         for k in range(k_buckets - 1)]
        # Clamp into (0, max_steps], force nondecreasing.
        bounds, cur = [], 16
        for b in inner:
            cur = min(max(b, cur), max_steps)
            bounds.append(cur)
        bounds.append(max_steps)
        return tuple(bounds)

    def bucket_plan(self, num_rays: int, bounds: Sequence[int],
                    num_samples: Optional[int] = None,
                    num_fine_samples: Optional[int] = None) -> List[tuple]:
        """``(k, lo, hi, t_k, ns_k, nf_k)`` of each non-empty bucket: the
        rays ``lo:hi`` of the crossing-count order, shaded at bound ``t_k``
        with ``ns_k`` coarse and ``nf_k`` fine samples (scaled to the bound
        with ``bucket_adaptive_samples``)."""
        cfg = self.config
        n_coarse = cfg.num_samples if num_samples is None else num_samples
        n_fine = cfg.num_fine_samples if num_fine_samples is None else num_fine_samples
        k_buckets, max_steps = len(bounds), bounds[-1]
        plan = []
        for k, t_k in enumerate(bounds):
            lo, hi = num_rays * k // k_buckets, num_rays * (k + 1) // k_buckets
            if hi == lo:
                continue
            if cfg.bucket_adaptive_samples:
                ns_k = scaled_budget(n_coarse, t_k, max_steps)
                nf_k = scaled_budget(n_fine, t_k, max_steps)
            else:
                ns_k, nf_k = n_coarse, n_fine
            plan.append((k, lo, hi, t_k, ns_k, nf_k))
        return plan

    def _get_outputs_bucketed(
        self, origins, directions, mesh, bounds, n_coarse, n_fine,
        occ_depth_cap, train, generator, uniforms, camera_indices,
        cached_march,
    ):
        """Quantile-bucketed shading (JAX ``_get_outputs_bucketed``): one
        geometry-only march at the full bound (K1), rays sorted by crossing
        count (stably, as ``jnp.argsort``) and cut into equal quantile
        chunks; one K8 launch slices every chunk to its own bound (geometry
        only: the slices take no gradient), one K2 launch computes every
        slice's endpoint features against the field (so the field gradient
        is one ``[V, F]`` tensor, one K7 launch), and the outputs go back
        to ray order. Each slice is shaded by :meth:`_shade`, or with
        ``bucket_merge_mlps`` (and not ``fused_mlps``, as in JAX) by
        :meth:`_shade_buckets_merged`."""
        cfg = self.config
        res = cached_march
        if res is None:
            res = march_features(
                mesh, None, origins, directions, bounds[-1],
                use_occupancy=cfg.use_occupancy_field,
                occ_threshold=cfg.occupancy_threshold,
                occ_depth_cap=occ_depth_cap,
            )
        order = torch.argsort(res.num_valid, stable=True)
        inv_order = torch.argsort(order)
        plan = self.bucket_plan(origins.shape[0], bounds, n_coarse, n_fine)
        slices = slice_march_buckets(res, order, plan, (origins, directions))
        feats = endpoint_features_batch(self.tetrahedra_field,
                                        [sliced.stream for sliced, _ in slices])
        jobs = [
            (o_k, d_k, sliced._replace(feats=feats_k), ns_k, nf_k,
             None if uniforms is None else uniforms[k],
             None if camera_indices is None else camera_indices[order[lo:hi]])
            for (k, lo, hi, t_k, ns_k, nf_k), (sliced, (o_k, d_k)), feats_k
            in zip(plan, slices, feats)
        ]
        if cfg.bucket_merge_mlps and not cfg.fused_mlps:
            outs = self._shade_buckets_merged(jobs, train, generator)
        else:
            outs = [self._shade(o_k, d_k, res_k, ns_k, nf_k, train, generator, u_k, cams_k)
                    for o_k, d_k, res_k, ns_k, nf_k, u_k, cams_k in jobs]
        return {key: torch.cat([o[key] for o in outs])[inv_order] for key in outs[0]}

    def _shade_buckets_merged(self, jobs, train, generator):
        """Bucketed shading with each MLP round merged across the buckets
        (JAX ``_shade_buckets_merged``): the samples are pointwise for the
        MLPs, so every bucket's ``[R_k, S_k, F]`` samples go through one
        call as ``[sum R_k S_k, 1, F]``, directions and camera indices
        repeated per sample: 2 MLP chains a step in place of 2 per bucket.
        Sampling, the PDF round and rendering stay per bucket (their shapes
        follow each bucket's bound). Buckets with no fine budget shade their
        coarse samples and skip the coarse-density round."""
        shade = [self._coarse_round(o_k, res_k, ns_k, nf_k, train, generator, u_k)
                 for o_k, _, res_k, ns_k, nf_k, u_k, _ in jobs]
        rays = [(d_k, cams_k) for _, d_k, _, _, _, _, cams_k in jobs]

        def merged(mlp, members):
            """``mlp`` over the members' samples as one call, each output
            split back to ``[R_k, S_k, ...]``."""
            fv = [shade[i]["fv"] for i in members]
            sizes = [x.shape[1] for x in fv]
            cams = [rays[i][1] for i in members]
            outs = mlp(
                torch.cat([x.reshape(-1, 1, x.shape[-1]) for x in fv]),
                torch.cat([rays[i][0].repeat_interleave(n, dim=0)
                           for i, n in zip(members, sizes)]),
                None if cams[0] is None else torch.cat(
                    [c.repeat_interleave(n, dim=0) for c, n in zip(cams, sizes)]),
            )
            splits = [x.shape[0] * x.shape[1] for x in fv]
            return [
                [part.reshape(*x.shape[:2], *part.shape[2:])
                 for part, x in zip(torch.split(out, splits), fv)]
                for out in outs
            ]

        fine = [i for i, b in enumerate(shade) if b["nf"] > 0]
        if fine:
            with torch.no_grad():
                (dens,) = merged(lambda x, d, c: (self.density_mlp(x),), fine)
            for i, d_c in zip(fine, dens):
                self._fine_round(shade[i], d_c)
        rgbs, denss = merged(self.field_mlps, range(len(shade)))
        return [self._render(b, rgb, dens, train)
                for b, rgb, dens in zip(shade, rgbs, denss)]

    def _forward(
        self, origins, directions, mesh, max_steps, n_coarse, n_fine,
        occ_depth_cap, train, generator, uniforms, camera_indices,
        cached_march=None,
    ) -> Dict[str, torch.Tensor]:
        """The forward of one batch of rays at one bound (JAX ``_forward``);
        a ``cached_march`` is re-shaded, its endpoint features computed here
        against the current field (K2): the ``feats`` a cached march carries
        are never used, they may be an older field's."""
        cfg = self.config
        if cached_march is not None:
            res = cached_march._replace(
                feats=endpoint_features(self.tetrahedra_field, cached_march.stream))
        else:
            res = march_features(
                mesh, self.tetrahedra_field, origins, directions, max_steps,
                use_occupancy=cfg.use_occupancy_field,
                occ_threshold=cfg.occupancy_threshold,
                occ_depth_cap=occ_depth_cap,
            )
        return self._shade(origins, directions, res, n_coarse, n_fine, train,
                           generator, uniforms, camera_indices)

    def _shade(self, origins, directions, res, n_coarse, n_fine, train, generator,
               uniforms, camera_indices) -> Dict[str, torch.Tensor]:
        """Shade one batch of rays from its march ``res`` (with ``feats``):
        the coarse round, the PDF round, the field MLPs and rendering."""
        b = self._coarse_round(origins, res, n_coarse, n_fine, train, generator, uniforms)
        if n_fine > 0:
            with torch.no_grad():
                density_c = self.density_mlp(b["fv"])
            self._fine_round(b, density_c)
        rgb, density = self.field_mlps(b["fv"], directions, camera_indices)
        return self._render(b, rgb, density, train)

    def _run_field(self, b, bins):
        """Midpoint distances, deltas, per-sample features ``fv`` and
        validity ``smask`` at bin edges ``bins`` into ``b`` (K3)."""
        b["dist"] = (bins[:, 1:] + bins[:, :-1]) / 2.0
        b["deltas"] = bins[:, 1:] - bins[:, :-1]
        b["fv"], b["smask"] = sample_features(b["res"], b["dist"], b["ray_mask"])

    def _coarse_round(self, origins, res, n_coarse, n_fine, train, generator, uniforms):
        """The random numbers (``train``), ray bounds and coarse samples of
        one batch; the coarse features run without autograd when a PDF round
        follows, as the JAX model stops their gradients."""
        cfg = self.config
        num_rays = origins.shape[0]
        dev = origins.device
        u = {}
        if train:
            u = uniforms if uniforms is not None else draw_uniforms(
                num_rays, n_coarse, n_fine, generator, dev
            )
            u = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in u.items()}
        nears, fars, first_kept, num_kept, ray_mask = ray_bounds(res)
        span = (fars - nears)[:, None]
        bins01 = stratified_bins(num_rays, n_coarse, device=dev, u=u.get("coarse"))
        euclid = nears[:, None] + bins01 * span
        if cfg.use_biased_sampler:
            euclid = biased_warp_range(res, first_kept, num_kept, nears, fars, euclid)
        b = dict(res=res, u=u, nears=nears, span=span, ray_mask=ray_mask, nf=n_fine,
                 spacing=(euclid - nears[:, None]) / span)
        with torch.no_grad() if n_fine > 0 else contextlib.nullcontext():
            self._run_field(b, euclid)
        return b

    def _fine_round(self, b, density_c):
        """The PDF round from the coarse density ``[R, S]``: resample the
        spacing and take the fine samples' features."""
        weights_c = render_weights(torch.where(b["smask"], density_c, 0.0), b["deltas"])
        b["spacing"] = pdf_sample(b["spacing"], weights_c, b["nf"], include_original=True,
                                  u=b["u"].get("fine"))
        self._run_field(b, b["nears"][:, None] + b["spacing"] * b["span"])

    def _render(self, b, rgb, density, train) -> Dict[str, torch.Tensor]:
        """Volume rendering of one batch from its samples' ``rgb [R, S, 3]``
        and ``density [R, S]``, with the gradient scaler under autograd."""
        cfg = self.config
        ray_mask = b["ray_mask"]
        num_rays, dev = ray_mask.shape[0], ray_mask.device
        density = torch.where(b["smask"], density, 0.0)
        if cfg.use_gradient_scaling and torch.is_grad_enabled():
            # Spacing-domain distance doubles as distance-to-object-centre
            # (reference model.py:625-630); the identity in the forward.
            spacing = b["spacing"]
            scaling = torch.square(spacing[:, 1:] + spacing[:, :-1]).clamp(0.0, 1.0)
            rgb, density = GradientScaler.apply(rgb, density, scaling)
        weights = render_weights(density, b["deltas"])
        if cfg.background_color == "last_sample":
            background = rgb[:, -1, :]
        elif train and cfg.background_color == "random":
            background = b["u"]["background"]
        else:
            background = self.background(num_rays, dev)
        rgb_out, acc, depth = render_rgb_depth_acc(
            weights, rgb, b["dist"], background_rgb=background,
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
            "traversal_overflow": b["res"].overflow,
        }

    # ------------------------------------------------------------------ loss
    @staticmethod
    def loss(outputs, image) -> torch.Tensor:
        """MSE on RGB, the reference's only loss (``model.py:665-674``)."""
        return torch.mean(torch.square(outputs["rgb"] - image))
