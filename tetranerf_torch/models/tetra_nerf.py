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

Data-parallel training passes a :class:`~..parallel.Group` to the train
forward: each rank shades its own rays, and what is global over the batch
stays global (the quantile buckets' sort, each bucket's random numbers,
the gradient-stream budget), so that a D-rank step computes the one-rank
step on the concatenation of the data shards' rows. With model shards
(:meth:`TetraNerf.shard_field`) the module holds this rank's columns of
the field, and every forward, train or eval, gathers the endpoint features
over its model group (:attr:`TetraNerf.field_group`), so the ranks of a
model group run each forward together.
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
    stream_budget_ids,
)
from ..ops.march import FusedMarch
from ..ops.mlp import FusedDensityMLP, FusedFieldMLPs, as_operand
from ..ops.rendering import render_rgb_depth_acc, render_weights
from ..ops.sampling import pdf_sample, stratified_bins
from ..ops import stream_dtypes
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


def split_buckets(num_valid: torch.Tensor, rank: int, num_local: int, plan):
    """This data shard's share of the quantile buckets of a global batch.

    ``num_valid i32[R]`` holds every data shard's crossing counts in data
    order (``R = data_count * num_local``); ``plan`` entries ``(k, lo, hi,
    ...)`` cut the stable sort of ``num_valid`` into buckets at global
    positions ``[lo, hi)`` (:meth:`TetraNerf.bucket_plan` of ``R`` rays).
    Data shard ``rank`` owns rays ``[rank * num_local, (rank + 1) *
    num_local)``.

    Returns ``(order, local_plan, positions)``: ``order`` the rank's rays
    (local indices) in global sort order; ``local_plan`` the entries with
    ``lo, hi`` replaced by the rank's extents in ``order`` (possibly empty);
    ``positions`` per entry, the global sort positions of those rays. The
    extents are read with one device-to-host copy of ``K + 1`` integers."""
    dev = num_valid.device
    order_g = torch.argsort(num_valid, stable=True)
    start = rank * num_local
    mine = (order_g >= start) & (order_g < start + num_local)
    # The positions of this rank's rays, ascending: a stable sort puts them
    # (key 0) first. No host sync, unlike a boolean mask.
    pos = torch.argsort((~mine).to(torch.uint8), stable=True)[:num_local]
    order = order_g[pos] - start
    edges = torch.tensor([e[1] for e in plan] + [plan[-1][2]], device=dev, dtype=pos.dtype)
    ext = torch.searchsorted(pos, edges).tolist()
    local_plan = [(e[0], ext[i], ext[i + 1]) + tuple(e[3:]) for i, e in enumerate(plan)]
    positions = [pos[a:b] for _, a, b, *_ in local_plan]
    return order, local_plan, positions


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
        self.field_group = None
        """The :class:`~..parallel.Group` whose model group holds the other
        columns of :attr:`tetrahedra_field` (:meth:`shard_field`); None
        while the module holds the whole field."""
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

    @torch.no_grad()
    def shard_field(self, group) -> None:
        """Keep only ``group``'s columns of the field (JAX ``state_shardings``
        on a ``data x model`` mesh): :attr:`tetrahedra_field` becomes the
        ``[V, F/M]`` block of model index ``m``, a new parameter, so build
        the optimizer after this. ``ValueError`` when ``F`` does not divide
        by ``M``."""
        cols = group.field_columns(self.tetrahedra_field.shape[1])
        self.tetrahedra_field = nn.Parameter(self.tetrahedra_field[:, cols].contiguous())
        self.field_group = group

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
        group=None,
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

        ``group`` (a :class:`~..parallel.Group`) makes this one data shard's
        share of a data-parallel forward whose global batch is the data
        shards' rows in data order: the buckets cut the global sort
        (:func:`split_buckets`),
        every bucket's random numbers are drawn (or given in ``uniforms``)
        at the global bucket's shape and this rank keeps its own rows, and
        the gradient-stream budget counts the global stream.

        Returns ``rgb [R, 3]``, ``accumulation [R, 1]``, ``depth [R, 1]``,
        ``ray_mask [R]`` and ``traversal_overflow [R]`` (rays whose march
        reached its bound, or a bucket's bound, before ending); with
        ``grad_stream_budget_per_ray`` in training also
        ``grad_stream_dropped [R]`` (rays whose stream ends past the
        budget: part or all of their field gradient is dropped)."""
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
                    cached_march, group,
                )
        return self._forward(
            origins, directions, mesh, max_steps, n_coarse, n_fine,
            occ_depth_cap, train, generator, uniforms, camera_indices,
            cached_march, group,
        )

    def stream_levers(self, train: bool):
        """``(budget_per_ray, stream_dtype)`` of a forward (JAX ``_forward``):
        the gradient-stream budget in training only; the low-precision
        stream (a :class:`~..ops.stream_dtypes.StreamType`) whenever configured,
        except while the budget is on (JAX ``endpoint_features`` takes the
        budget first). ``"float64"`` is the f32 stream, as JAX computes it
        with 64-bit types off (:func:`~..ops.stream_dtypes.stream_dtype`)."""
        cfg = self.config
        per_ray = cfg.grad_stream_budget_per_ray if train else None
        per_ray = per_ray or None
        dtype = None if per_ray else stream_dtypes.stream_dtype(cfg.field_stream_dtype)
        return per_ray, dtype

    def merges_buckets(self, train: bool) -> bool:
        """Whether bucketed shading merges its MLP rounds (JAX's condition,
        ``tetranerf_tpu/models/tetra_nerf.py:546-551``): not with the
        budget in training, a stream dtype other than ``"float32"`` (also
        ``"float64"``, whose stream is f32's: JAX compares the name) or
        ``fused_mlps``."""
        cfg = self.config
        return bool(
            cfg.bucket_merge_mlps
            and not (train and cfg.grad_stream_budget_per_ray)
            and cfg.field_stream_dtype in (None, "float32")
            and not cfg.fused_mlps
        )

    @staticmethod
    def _budget_jobs(per_ray: int, num_valid: torch.Tensor, entries):
        """The gradient-stream budget of each forward of ``entries``: per
        entry ``(lo, hi, t, positions, vids)``, a forward over the rays at
        positions ``[lo, hi)`` of ``num_valid`` (every rank's crossing
        counts in the forward's ray order) marched to ``t`` intervals, of
        which this rank holds those at ``positions`` with stream ids
        ``vids``. Returns per entry ``(scatter ids, dropped bool[n])``: the
        K7 ids of :func:`~..ops.fused.stream_budget_ids` and JAX's
        ``cumsum(counts) > budget`` for this rank's rays."""
        out = []
        for lo, hi, t, positions, vids in entries:
            counts = num_valid[lo:hi].to(torch.int64).clamp_max(t) + 4
            ends = torch.cumsum(counts, 0)
            sel = (positions - lo).long()
            ends_l, counts_l = ends[sel], counts[sel]
            budget = per_ray * (hi - lo)
            ids = stream_budget_ids(vids, counts_l, ends_l - counts_l, budget,
                                    sel == hi - lo - 1)
            out.append((ids, ends_l > budget))
        return out

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
        cached_march, group=None,
    ):
        """Quantile-bucketed shading (JAX ``_get_outputs_bucketed``): one
        geometry-only march at the full bound (K1), rays sorted by crossing
        count (stably, as ``jnp.argsort``) and cut into equal quantile
        chunks; one K8 launch slices every chunk to its own bound (geometry
        only: the slices take no gradient), one K2 launch computes every
        slice's endpoint features against the field (so the field gradient
        is one ``[V, F]`` tensor, one K7 launch), and the outputs go back
        to ray order. Each slice is shaded by :meth:`_shade`, or where
        :meth:`merges_buckets` by :meth:`_shade_buckets_merged`.

        With ``group`` the sort is over every rank's crossing counts and a
        bucket's slice holds this rank's rays of it, possibly none (a
        zero-row job in every batch of K8, K2 and K7)."""
        cfg = self.config
        res = cached_march
        if res is None:
            res = march_features(
                mesh, None, origins, directions, bounds[-1],
                use_occupancy=cfg.use_occupancy_field,
                occ_threshold=cfg.occupancy_threshold,
                occ_depth_cap=occ_depth_cap,
            )
        num_rays = origins.shape[0]
        per_ray, stream_dtype = self.stream_levers(train)
        nv = res.num_valid
        if group is None:
            order = torch.argsort(nv, stable=True)
            plan = self.bucket_plan(num_rays, bounds, n_coarse, n_fine)
            global_plan, positions = plan, None
        else:
            nv = group.gather_rows(nv)
            global_plan = self.bucket_plan(nv.shape[0], bounds, n_coarse, n_fine)
            order, plan, positions = split_buckets(nv, group.data_index, num_rays,
                                                   global_plan)
            if train:
                uniforms = self._global_uniforms(global_plan, positions, generator,
                                                 uniforms, origins.device)
        inv_order = torch.argsort(order)
        slices = slice_march_buckets(res, order, plan, (origins, directions))
        streams = [sliced.stream for sliced, _ in slices]
        budget = None
        if per_ray:
            if positions is None:
                positions = [torch.arange(lo, hi, device=nv.device) for _, lo, hi, *_ in plan]
            max_t = res.t1.shape[1]
            budget = self._budget_jobs(per_ray, torch.sort(nv).values, [
                (lo, hi, min(t, max_t), pos, s.vids)
                for (_, lo, hi, t, *_), pos, s in zip(global_plan, positions, streams)])
        feats = endpoint_features_batch(self.tetrahedra_field, streams, stream_dtype,
                                        None if budget is None else [ids for ids, _ in budget],
                                        self.field_group,
                                        [sliced.num_valid for sliced, _ in slices])
        jobs = [
            (o_k, d_k, sliced._replace(feats=feats_k), ns_k, nf_k,
             None if uniforms is None else uniforms[k],
             None if camera_indices is None else camera_indices[order[lo:hi]])
            for (k, lo, hi, t_k, ns_k, nf_k), (sliced, (o_k, d_k)), feats_k
            in zip(plan, slices, feats)
        ]
        if self.merges_buckets(train):
            outs = self._shade_buckets_merged(jobs, train, generator)
        else:
            outs = [self._shade(o_k, d_k, res_k, ns_k, nf_k, train, generator, u_k, cams_k)
                    for o_k, d_k, res_k, ns_k, nf_k, u_k, cams_k in jobs]
        if budget is not None:
            for o, (_, dropped) in zip(outs, budget):
                o["grad_stream_dropped"] = dropped
        return {key: torch.cat([o[key] for o in outs])[inv_order] for key in outs[0]}

    @staticmethod
    def _global_uniforms(global_plan, positions, generator, uniforms, device):
        """Each bucket's random numbers at the global bucket's shape, then
        this rank's rows of them (at its ``positions`` in the bucket): the
        given ``uniforms`` (global layout, indexed by bucket), or drawn from
        ``generator`` bucket by bucket, as the one-rank forward draws them."""
        out = {}
        for (k, lo, hi, _, ns_k, nf_k), pos in zip(global_plan, positions):
            u = (draw_uniforms(hi - lo, ns_k, nf_k, generator, device)
                 if uniforms is None else uniforms[k])
            rows = (pos - lo).to(device)
            out[k] = {key: torch.as_tensor(v, dtype=torch.float32, device=device)[rows]
                      for key, v in u.items()}
        return out

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
        cached_march=None, group=None,
    ) -> Dict[str, torch.Tensor]:
        """The forward of one batch of rays at one bound (JAX ``_forward``);
        a ``cached_march`` is re-shaded, its endpoint features computed here
        against the current field (K2): the ``feats`` a cached march carries
        are never used, they may be an older field's. With ``group`` every
        ray is local: the random numbers are the global batch's (drawn, or
        given, for every rank's rays) at this rank's rows, and only the
        gradient-stream budget reads the other ranks' crossing counts."""
        cfg = self.config
        num_rays = origins.shape[0]
        if group is not None and train:
            start = group.data_index * num_rays
            plan = [(0, 0, group.data_count * num_rays, None, n_coarse, n_fine)]
            rows = [torch.arange(start, start + num_rays, device=origins.device)]
            uniforms = self._global_uniforms(
                plan, rows, generator, None if uniforms is None else [uniforms],
                origins.device)[0]
        res = cached_march
        if res is None:
            res = march_features(
                mesh, None, origins, directions, max_steps,
                use_occupancy=cfg.use_occupancy_field,
                occ_threshold=cfg.occupancy_threshold,
                occ_depth_cap=occ_depth_cap,
            )
        per_ray, stream_dtype = self.stream_levers(train)
        budget = None
        if per_ray:
            nv, start = res.num_valid, 0
            if group is not None:
                nv, start = group.gather_rows(nv), group.data_index * num_rays
            positions = torch.arange(start, start + num_rays, device=nv.device)
            (budget,) = self._budget_jobs(per_ray, nv, [
                (0, nv.shape[0], res.t1.shape[1], positions, res.stream.vids)])
        res = res._replace(feats=endpoint_features(
            self.tetrahedra_field, res.stream, stream_dtype,
            None if budget is None else budget[0], self.field_group, res.num_valid))
        out = self._shade(origins, directions, res, n_coarse, n_fine, train,
                          generator, uniforms, camera_indices)
        if budget is not None:
            out["grad_stream_dropped"] = budget[1]
        return out

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
