"""The train step: occupancy upkeep, bound retunes, forward, MSE loss,
backward, RAdam.

Counterpart of ``Trainer.train_step`` and ``make_train_step`` in
:mod:`tetranerf_tpu.training.trainer`, on one device or as one rank of
many. Before a step, as in the JAX trainer:

- on the first call, a geometry-only probe tightens the march bound to the
  scene and, with ``ray_buckets >= 2``, sizes the quantile-bucket bounds
  (:meth:`Trainer.tune_traversal_steps`);
- every ``occupancy_update_every`` steps from step 0, a ray-based update
  of the per-cell density EMA (:meth:`Trainer.update_occupancy`);
- every ``occupancy_refresh_every`` steps after step 0, a refresh at every
  cell centroid (:meth:`Trainer.refresh_occupancy`), each written into
  column 24 of the march table, and with ``skip_grid_resolution > 0`` the
  empty-space skip grid rebuilt from the EMA
  (:meth:`Trainer._rebuild_skip_grid`);
- every ``occupancy_retune_every`` steps after step 0, a retune of the
  bounds: from the model's own optical depth, which also calibrates the
  march's termination cap (:meth:`Trainer.retune_with_transmittance`), or
  from the occupancy march (:meth:`Trainer.retune_with_occupancy`), as
  ``occupancy_retune_mode`` says.

These cadences count the steps this trainer has taken
(:attr:`Trainer._step_count`, JAX ``Trainer._step_count``), not the
restored step: a trainer resumed at step 12 updates its occupancy at steps
12, 28, 44, ...

The trainer holds one termination cap, :attr:`Trainer.occ_depth_cap`: the
train forward, the occupancy update, the probes and rendering all read it.
:attr:`Trainer.march_version` counts the changes to what a march depends on
(the bounds, the occupancy column, the skip grid, the cap), so that a march cached by
:meth:`Trainer.cache_camera` and re-shaded by :meth:`Trainer.render_cached`
(the viewer's refine) is not taken for a current one. :attr:`Trainer.lock`
lets a viewer render while another thread trains: a step, and every render,
holds it.

:meth:`Trainer.fit` is the training loop (JAX ``Trainer.fit``): batches
assembled on a producer thread, log lines, ``eval_fn`` and checkpoints
(:mod:`.checkpoints`) on their cadences.

Data parallel: with a :class:`~..parallel.Group` each rank feeds only its
data shard's rows of the global batch (``host_batch_slice``;
:meth:`Trainer.fit` cuts them), and a step is the one-rank step on the
data shards' rows in data order, as JAX's GSPMD step is: the train forward
buckets and budgets over the global batch, the gradients are averaged over
the data group with one ``all_reduce`` before RAdam (the ranks of a data
group end a step with the same parameters), the probes gather their per-ray
statistics in data order (the same bounds, cap and ``# retune@`` lines on
every rank), and the occupancy update maxes every data shard's rays into
one EMA. The refresh and the skip grid are computed alike on every rank.

Model shards (``num_model_shards`` M > 1, JAX's ``data x model`` mesh):
each rank holds its ``[V, F/M]`` columns of the field and RAdam's moments
of them, and everything else replicated. Whatever reads the field (the
train and eval forwards, the probes, the occupancy update and refresh)
gathers full-width features over the rank's model group, so the ranks of a
model group run these together; everything after a gather is replicated in
the model group, bit for bit. The ranks of data index 0 evaluate together
(:attr:`Trainer.evaluates`) and gather the full field for a checkpoint.
Rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.fused import biased_warp_range, march_features, ray_bounds, sample_features
from ..ops.march import march
from ..ops.sampling import stratified_bins
from ..ops.skip_grid import SkipSetup, build_skip_table, make_skip_setup
from ..render import Renderer, chunks
from ..utils.shapes import grid_ceil, inner_bound, rounded_bound
from ..parallel import gather_columns, table_checksum
from . import checkpoints
from .optim import make_optimizer, set_step
from .presets import TrainConfig, check_shards

__all__ = ["TrainConfig", "Trainer"]

_PROBE_RAYS = 8192
_REFRESH_CHUNK = 65536


# Bucket-bound statistics: copies of the JAX trainer's helpers
# (``training/trainer.py:59-125``), so that the port's tuned bounds equal
# the JAX trainer's on the same crossing counts.
def quantile_bucket_stats(nv: np.ndarray, k_buckets: int, percentile: float) -> tuple:
    """Rays sorted by crossing count and split into K equal chunks; each
    chunk's ``percentile`` crossing count (no margin, no grid)."""
    snv = np.sort(nv)
    return tuple(
        float(np.percentile(
            snv[snv.size * k // k_buckets : snv.size * (k + 1) // k_buckets],
            percentile,
        ))
        for k in range(k_buckets)
    )


def ranked_chunk_stats(key: np.ndarray, value: np.ndarray, k_buckets: int,
                       percentile: float) -> tuple:
    """Per-chunk ``percentile`` of ``value`` with rays ranked (stably) by
    ``key``: chunks follow the shading's sort key (the march's emitted
    crossing counts) and are sized from their members' true need."""
    order = np.argsort(key, kind="stable")
    n = order.size
    return tuple(
        float(np.percentile(
            value[order[n * k // k_buckets : n * (k + 1) // k_buckets]],
            percentile,
        ))
        for k in range(k_buckets)
    )


def bounds_from_stats(stats, full: int, margin: float = 1.15) -> tuple:
    """Inner bounds (``K - 1``) from the first K-1 chunk statistics:
    :func:`~..utils.shapes.inner_bound`, clamped to ``full`` and forced
    nondecreasing."""
    inner, cur = [], 16
    for s in stats[:-1]:
        cur = min(max(inner_bound(s, margin), cur), full)
        inner.append(cur)
    return tuple(inner)


def quantile_bucket_bounds(nv: np.ndarray, k_buckets: int, full: int,
                           percentile: float, margin: float = 1.15) -> tuple:
    """:func:`bounds_from_stats` of :func:`quantile_bucket_stats` (one probe)."""
    return bounds_from_stats(
        quantile_bucket_stats(nv, k_buckets, percentile), full, margin
    )


class Trainer:
    """Trains ``model`` (a :class:`~..models.TetraNerf`) on ``mesh`` (a
    :class:`~..geometry.TorchMesh`), both moved to ``device``.

    Usage::

        trainer = Trainer(TrainConfig(), model, mesh)
        metrics = trainer.train_step({"origins": o, "directions": d, "rgb": c})

    A batch holds ``origins [R, 3]``, ``directions [R, 3]``, ``rgb [R, 3]``
    and optionally ``camera_indices [R]`` (numpy arrays or tensors).
    ``auto_tune_steps=False`` skips the first step's bound tune.

    ``group`` (:func:`~..parallel.init_distributed`) trains on the group's
    device: :meth:`train_step` then takes this rank's data shard's rows of
    the global batch (equal counts on every data shard). With model shards
    (the group's ``model_count``, which must be ``num_model_shards``) the
    model, built with the whole seeded field, keeps this rank's columns of
    it (:meth:`~..models.TetraNerf.shard_field`) before RAdam is built over
    it. Every rank must build the same mesh; the constructor checks it."""

    def __init__(self, config: TrainConfig, model, mesh, device="cuda",
                 auto_tune_steps: bool = True, group=None):
        check_shards(config, 1 if group is None else group.world)
        model_count = 1 if group is None else group.model_count
        if model_count != (config.num_model_shards or 1):
            raise ValueError(
                f"num_model_shards={config.num_model_shards} but the group has "
                f"{model_count} model shard(s): pass model_shards to init_distributed")
        self.config = config
        self.group = group
        self._auto_tune_steps = auto_tune_steps
        self.device = torch.device(device) if group is None else group.device
        self.model = model.to(self.device)
        if model_count > 1:
            self.model.shard_field(group)
        self.mesh = mesh.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), config)
        self.step = 0
        """Updates taken so far (the JAX ``TrainState.step``): the learning
        rate, the step's random stream; restored with a checkpoint."""
        self._step_count = 0
        """Steps this trainer has taken since it was built (JAX
        ``Trainer._step_count``): the occupancy update, refresh and retune
        cadences read it, and :meth:`restore_checkpoint` leaves it alone."""
        self.tuned_max_steps: Optional[int] = None
        self.tuned_bucket_steps: Optional[tuple] = None
        """The ``ray_buckets - 1`` ascending inner bucket bounds (the deepest
        bucket shades at :attr:`max_steps`); None until tuned."""
        self._tuned = False
        cfg = model.config
        self.occupancy: Optional[torch.Tensor] = None
        """Per-cell density EMA ``f32[C]`` (None until the first update)."""
        self.occ_depth_cap = float(-np.log(cfg.occupancy_threshold))
        """The march's termination cap: ``-log(occupancy_threshold)`` until
        :meth:`retune_with_transmittance` calibrates it."""
        self._cap_history: list = []
        self._retune_stats: list = []
        self._generator = torch.Generator(device=self.device)
        self.march_version = 0
        """Bumped whenever the bounds, the occupancy column or the cap change,
        or a checkpoint is restored (JAX ``Trainer.march_version``)."""
        self.lock = threading.RLock()
        """Held by :meth:`train_step` and by every render, so that a viewer
        thread never reads the parameters while the optimizer writes them."""
        self._skip_setup: Optional[SkipSetup] = None
        if group is not None:
            group.check_same("the march table", table_checksum(self.mesh.march_table))

    @property
    def is_main(self) -> bool:
        """Rank 0, or the only process: the one that logs and writes."""
        return self.group is None or self.group.rank == 0

    @property
    def evaluates(self) -> bool:
        """The ranks of data index 0, or the only process: the model group
        that runs every eval forward (rank 0 alone without model shards)."""
        return self.group is None or self.group.data_index == 0

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _global(self, x: torch.Tensor) -> np.ndarray:
        """A per-ray statistic of this rank's probe rays, with every data
        shard's rows in data order (one gather), as numpy."""
        if self.group is not None:
            x = self.group.gather_rows(x)
        return x.cpu().numpy()

    @property
    def max_steps(self) -> int:
        return self.tuned_max_steps or self.model.config.max_intersected_triangles

    # ------------------------------------------------------------ bounds
    def _probe_rays(self, batch: Mapping):
        """This rank's first 8192 rows (JAX ``_probe_arrays``: each process
        contributes its own, and the statistics are gathered)."""
        return (self._tensor(batch["origins"][:_PROBE_RAYS]),
                self._tensor(batch["directions"][:_PROBE_RAYS]))

    @torch.no_grad()
    def tune_traversal_steps(self, batch: Mapping) -> int:
        """March up to 8192 of the batch's rays without occupancy and set
        the bound to 1.5x the deepest crossing count, rounded up to the
        bound grid, if that is below the configured bound. With
        ``ray_buckets >= 2`` (and no ``bucket_short_steps``) the inner bucket
        bounds come from the crossing counts' own quantile chunks, at their
        maximum with a 1.5x margin."""
        cfg = self.model.config
        before = (self.tuned_max_steps, self.tuned_bucket_steps)
        o, d = self._probe_rays(batch)
        num_valid = self._global(
            march(self.mesh, o, d, cfg.max_intersected_triangles).num_valid)
        tuned = min(cfg.max_intersected_triangles, rounded_bound(num_valid.max()))
        if tuned < cfg.max_intersected_triangles:
            self.tuned_max_steps = tuned
        if cfg.ray_buckets >= 2 and cfg.bucket_short_steps is None:
            self.tuned_bucket_steps = quantile_bucket_bounds(
                num_valid, cfg.ray_buckets, tuned, 100.0, margin=1.5
            )
        if (self.tuned_max_steps, self.tuned_bucket_steps) != before:
            self.march_version += 1
        return self.max_steps

    @torch.no_grad()
    def _nv_eff(self, o, d):
        """Per ray, the crossings up to the point where the model's own
        optical depth passes ``-log(occupancy_threshold)``, and the EMA's
        estimated depth there (JAX ``Trainer._nv_eff_fn``). Marches the
        configured bound without termination, samples as the coarse round
        does without jitter, and runs the plain MLPs even with
        ``fused_mlps``, as the JAX probe does."""
        model = self.model
        cfg = model.config
        res = march_features(self.mesh, model.tetrahedra_field, o, d,
                             cfg.max_intersected_triangles, columns=model.field_group)
        nears, fars, first, num_kept, mask = ray_bounds(res)
        bins01 = stratified_bins(o.shape[0], cfg.num_samples, device=self.device)
        euclid = nears[:, None] + bins01 * (fars - nears)[:, None]
        if cfg.use_biased_sampler:
            euclid = biased_warp_range(res, first, num_kept, nears, fars, euclid)
        distances = ((euclid[:, 1:] + euclid[:, :-1]) / 2.0).contiguous()
        deltas = euclid[:, 1:] - euclid[:, :-1]
        feats, smask = sample_features(res, distances, mask)
        _, dens = model.plain_field_mlps(feats, d)
        dens = torch.where(smask, dens, 0.0)
        optical = torch.cumsum(dens * deltas, dim=1)
        depth_cap = -float(np.log(cfg.occupancy_threshold))
        d_star = torch.where(optical > depth_cap, distances, float("inf")).amin(dim=1)
        t0 = res.t0
        nv_eff = (res.valid & (t0 <= d_star[:, None])).sum(dim=1)
        # The EMA's depth accumulated up to the true exhaustion point (the
        # full chord for rays that never exhaust): the cap must exceed it.
        sig_est = self.mesh.march_table[:, 24][res.cells.clamp_min(0).long()]
        dt = torch.where(res.valid, res.t1 - t0, 0.0)
        est_cum = torch.cumsum(sig_est * dt, dim=1)
        within = res.valid & (res.t1 <= d_star[:, None])
        est_at = torch.where(within, est_cum, 0.0).amax(dim=1)
        return self._global(nv_eff), self._global(est_at)

    @torch.no_grad()
    def _march_nv(self, o, d):
        """The march's emitted crossing counts at the configured bound under
        the current termination cap: the key bucketed shading sorts by."""
        cfg = self.model.config
        return self._global(march(
            self.mesh, o, d, cfg.max_intersected_triangles,
            use_occupancy=cfg.use_occupancy_field,
            occ_threshold=cfg.occupancy_threshold,
            occ_depth_cap=self.occ_depth_cap,
        ).num_valid)

    def retune_with_transmittance(self, batch: Mapping) -> int:
        """Size the bounds from the model's own optical depth and calibrate
        the termination cap (JAX ``Trainer.retune_with_transmittance``, the
        numpy part copied as it is). Returns the main bound.

        - The cap: 1.2x the 99.9th percentile of the EMA's depth at the
          true exhaustion point, at least ``-log(threshold)``, the maximum
          over the last 3 probes (it only comes down once 3 probes agree).
        - The statistics (the main bound's need, the tie guard, each
          chunk's need with rays ranked by the march's emitted counts) are
          each the maximum over the last 3 probes.
        - With buckets the main bound is sized like the inner ones from the
          top chunk, never below the tie guard; else 1.5x on the grid.
        - Hysteresis: a bound grows at once and shrinks only by more than
          16; the inner bounds are then made nondecreasing again.

        Prints a ``# retune@<n>`` line on stderr, ``n`` the steps this
        trainer has taken."""
        cfg = self.model.config
        o, d = self._probe_rays(batch)
        nv, est_at = self._nv_eff(o, d)
        floor = float(-np.log(cfg.occupancy_threshold))
        cap_now = max(
            floor,
            cfg.occ_cap_margin
            * float(np.percentile(est_at, cfg.occ_cap_percentile)),
        )
        self._cap_history = (self._cap_history + [cap_now])[-3:]
        self.occ_depth_cap = max(self._cap_history)
        self.march_version += 1  # the cap moves where marches stop
        nv_m = self._march_nv(o, d)
        k_buckets = max(cfg.ray_buckets, 1)
        raw = (
            float(np.percentile(nv, cfg.occupancy_retune_percentile)),
            # Tie guard: rays tied at the bound sort arbitrarily, so the main
            # bound covers the top chunk's emitted range.
            float(np.percentile(nv_m, 100.0 * (k_buckets - 1) / k_buckets)),
        ) + ranked_chunk_stats(nv_m, nv, k_buckets, cfg.occupancy_retune_percentile)
        hist = [h for h in self._retune_stats if len(h) == len(raw)] + [raw]
        self._retune_stats = hist[-3:]
        smoothed = tuple(max(col) for col in zip(*self._retune_stats))
        observed = int(smoothed[0])
        tie_b = smoothed[1]
        chunk_stats = smoothed[2:]
        cur = self.max_steps
        bucketed = cfg.ray_buckets >= 2 and cfg.bucket_short_steps is None
        if bucketed:
            bound = min(cfg.max_intersected_triangles, max(
                16,
                inner_bound(chunk_stats[-1], cfg.bucket_bound_margin),
                inner_bound(tie_b, cfg.bucket_bound_margin),
            ))
        else:
            bound = min(cfg.max_intersected_triangles, rounded_bound(observed))
        if bound < cur - 16 or bound > cur:
            self.tuned_max_steps = bound
        full = self.max_steps
        if bucketed:
            proposed = bounds_from_stats(chunk_stats, full,
                                         margin=cfg.bucket_bound_margin)
            cur_b = self.tuned_bucket_steps or proposed
            if len(cur_b) != len(proposed):
                cur_b = proposed
            new_b = tuple(p if (p > c or p < c - 16) else c
                          for p, c in zip(proposed, cur_b))
            mono, low = [], 16
            for b in new_b:
                low = min(max(b, low), full)
                mono.append(low)
            self.tuned_bucket_steps = tuple(mono)
        elif self.tuned_bucket_steps is not None:
            self.tuned_bucket_steps = tuple(min(b, full) for b in self.tuned_bucket_steps)
        print(
            f"# retune@{self._step_count}: bound={self.tuned_max_steps} "
            f"buckets={self.tuned_bucket_steps} "
            f"occ_cap={self.occ_depth_cap:.1f} (floor {floor:.1f}) "
            f"nv_eff p50/p99={int(np.percentile(nv, 50))}/"
            f"{int(np.percentile(nv, 99))} "
            f"nv_march p50/p99={int(np.percentile(nv_m, 50))}/"
            f"{int(np.percentile(nv_m, 99))}",
            file=sys.stderr,
        )
        return full

    @torch.no_grad()
    def retune_with_occupancy(self, batch: Mapping) -> int:
        """Re-probe the crossing counts with occupancy termination at the
        current bound and set the bound to 1.5x their
        ``occupancy_retune_percentile`` on the grid, with the same
        hysteresis (JAX ``Trainer.retune_with_occupancy``); the bucket
        bounds are clamped to it. Returns the main bound."""
        cfg = self.model.config
        cur = self.max_steps
        o, d = self._probe_rays(batch)
        nv = self._global(march(self.mesh, o, d, cur, use_occupancy=True,
                                occ_depth_cap=self.occ_depth_cap).num_valid)
        observed = int(np.percentile(nv, cfg.occupancy_retune_percentile))
        bound = min(cfg.max_intersected_triangles, rounded_bound(observed))
        if bound < cur - 16 or bound > cur:
            self.tuned_max_steps = bound
            if self.tuned_bucket_steps is not None:
                self.tuned_bucket_steps = tuple(
                    min(b, bound) for b in self.tuned_bucket_steps
                )
            self.march_version += 1
        return self.max_steps

    # --------------------------------------------------------- occupancy
    def _ensure_occupancy(self):
        if self.occupancy is None:
            self.occupancy = torch.zeros(self.mesh.num_cells, device=self.device)

    def _write_occupancy(self):
        self.mesh = self.mesh.with_occupancy(self.occupancy)
        self.march_version += 1

    @torch.no_grad()
    def update_occupancy(self, batch: Mapping) -> None:
        """Ray-based EMA update: march the batch with occupancy termination,
        take each interval's mean sample density (deterministic coarse
        bins), and set ``occ = max(decay * occ, density)`` per crossed cell
        (JAX ``Trainer._occupancy_update_fn``). With a group each rank maxes
        its own rays in and the data group's EMAs are maxed together, which
        is the update over the global batch: ``max(d o, a, b) = max(max(d o,
        a), max(d o, b))`` (a model group's ranks hold the same rays)."""
        self._ensure_occupancy()
        model = self.model
        cfg = model.config
        o = self._tensor(batch["origins"])
        d = self._tensor(batch["directions"])
        res = march_features(
            self.mesh, model.tetrahedra_field, o, d, self.max_steps,
            use_occupancy=True, occ_depth_cap=self.occ_depth_cap,
            columns=model.field_group,
        )
        nears, fars, first, num_kept, mask = ray_bounds(res)
        bins01 = stratified_bins(o.shape[0], cfg.num_samples, device=self.device)
        euclid = nears[:, None] + bins01 * (fars - nears)[:, None]
        if cfg.use_biased_sampler:
            euclid = biased_warp_range(res, first, num_kept, nears, fars, euclid)
        distances = ((euclid[:, 1:] + euclid[:, :-1]) / 2.0).contiguous()
        feats, smask = sample_features(res, distances, mask)
        dens = torch.where(smask, model.density_at(feats), 0.0)
        # Each sample's interval k = #(t1 <= d); per-interval mean density.
        max_t = res.t1.shape[1]
        k = torch.searchsorted(res.t1.contiguous(), distances, right=True)
        k = k.clamp_max(max_t - 1)
        sig_sum = torch.zeros_like(res.t1).scatter_add_(1, k, dens)
        sig_cnt = torch.zeros_like(res.t1).scatter_add_(1, k, smask.float())
        sig_int = sig_sum / sig_cnt.clamp_min(1.0)
        cells = torch.where(res.valid, res.cells, -1).reshape(-1)
        vals = torch.where(cells >= 0, sig_int.reshape(-1), 0.0)
        # Invalid slots write max(occ[0], 0) == occ[0]: a no-op.
        self.occupancy = (self.occupancy * cfg.occupancy_decay).scatter_reduce_(
            0, cells.clamp_min(0).long(), vals, "amax"
        )
        if self.group is not None:
            self.group.all_reduce_max(self.occupancy)
        self._write_occupancy()

    @torch.no_grad()
    def refresh_occupancy(self) -> None:
        """Full-coverage refresh: the density at every cell centroid (the
        mean of its four vertex features) maxed into the decayed EMA (JAX
        ``Trainer.refresh_occupancy``). With model shards each chunk's means
        are taken over this rank's columns and gathered, not the field."""
        self._ensure_occupancy()
        model = self.model
        field = model.tetrahedra_field
        cells = self.mesh.cells.long()
        dens = torch.cat([
            model.density_at(gather_columns(
                model.field_group, [field[cells[i : i + _REFRESH_CHUNK]].mean(dim=1)])[0])
            for i in range(0, cells.shape[0], _REFRESH_CHUNK)
        ])
        self.occupancy = torch.maximum(
            self.occupancy * model.config.occupancy_decay, dens
        )
        self._write_occupancy()
        self._rebuild_skip_grid()

    @torch.no_grad()
    def _rebuild_skip_grid(self) -> None:
        """Build the empty-space skip grid from the occupancy EMA and attach
        it to a new mesh (JAX ``Trainer._rebuild_skip_grid``), with
        ``skip_grid_resolution > 0``. No grid while the EMA is at most
        ``skip_grid_eps`` everywhere: an all-empty grid would skip every
        ray's whole chord. The geometry part (:func:`make_skip_setup`) is
        built once per mesh; each rebuild swaps the mesh, never writing the
        one a cached march or a viewer holds."""
        cfg = self.model.config
        if not cfg.skip_grid_resolution or self.occupancy is None:
            return
        if float(self.occupancy.max()) <= cfg.skip_grid_eps:
            return
        with self.lock:
            if self._skip_setup is None:
                self._skip_setup = make_skip_setup(self.mesh, cfg.skip_grid_resolution)
            table = build_skip_table(self.occupancy, self._skip_setup,
                                     skip_eps=cfg.skip_grid_eps)
            self.mesh = self.mesh.with_skip_grid(table, self._skip_setup.meta)
            self.march_version += 1

    # -------------------------------------------------------------- step
    def _step_generator(self, step: int) -> torch.Generator:
        """The step's random stream: a function of the seed and the step
        count (the JAX step folds the step into its key)."""
        seed = int(np.random.SeedSequence([self.config.seed, step]).generate_state(1)[0])
        return self._generator.manual_seed(seed)

    def train_step(self, batch: Mapping, uniforms=None) -> Dict[str, torch.Tensor]:
        """One optimisation step, under :attr:`lock`. ``uniforms`` (keys of
        :func:`~..models.tetra_nerf.draw_uniforms`, or with bucketed shading
        a list of them, one per bucket, in the global batch's layout with a
        group) replace the step's own random numbers. Returns ``loss``,
        ``psnr`` and ``overflow_rays`` (rays whose march reached its bound),
        and with ``grad_stream_budget_per_ray`` ``grad_stream_dropped_rays``
        (rays that lost field gradient to the budget), as device scalars;
        with a group the loss is the mean over the data shards (the global
        batch's) and the counts are sums over them."""
        with self.lock:
            return self._train_step(batch, uniforms)

    def _train_step(self, batch: Mapping, uniforms) -> Dict[str, torch.Tensor]:
        cfg = self.model.config
        step, count = self.step, self._step_count
        occ = cfg.use_occupancy_field
        if self._auto_tune_steps and not self._tuned:
            self._tuned = True
            self.tune_traversal_steps(batch)
        if occ and cfg.occupancy_update_every and count % cfg.occupancy_update_every == 0:
            self.update_occupancy(batch)
        if (occ and cfg.occupancy_refresh_every and count > 0
                and count % cfg.occupancy_refresh_every == 0):
            self.refresh_occupancy()
        if (occ and cfg.occupancy_retune_every and count > 0
                and count % cfg.occupancy_retune_every == 0):
            if cfg.occupancy_retune_mode == "transmittance":
                self.retune_with_transmittance(batch)
            else:
                self.retune_with_occupancy(batch)
        self._step_count += 1

        o = self._tensor(batch["origins"])
        d = self._tensor(batch["directions"])
        target = self._tensor(batch["rgb"])
        cams = batch.get("camera_indices")
        if cams is not None:
            cams = self._tensor(cams, torch.int64)
        model = self.model
        out = model.get_outputs(
            o, d, self.mesh, max_steps=self.max_steps,
            bucket_steps=self.tuned_bucket_steps,
            occ_depth_cap=self.occ_depth_cap, train=True,
            generator=None if uniforms is not None else self._step_generator(step),
            uniforms=uniforms, camera_indices=cams, group=self.group,
        )
        loss = model.loss(out, target)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        counts = {"overflow_rays": out["traversal_overflow"].sum()}
        if "grad_stream_dropped" in out:
            counts["grad_stream_dropped_rays"] = out["grad_stream_dropped"].sum()
        loss = loss.detach()
        if self.group is not None:
            # Data shards hold equal row counts, so the mean of the local
            # means is the global batch's loss and its gradient.
            sums = self.group.reduce_grads(
                model.parameters(), torch.stack([loss] + [c.float() for c in counts.values()]))
            loss = sums[0] / self.group.data_count
            counts = {k: sums[i + 1].round().long() for i, k in enumerate(counts)}
        set_step(self.optimizer, self.config, step)
        self.optimizer.step()
        self.step += 1
        return {"loss": loss, "psnr": -10.0 * torch.log10(loss + 1e-12), **counts}

    # -------------------------------------------------------------- eval
    def renderer(self) -> Renderer:
        """A :class:`~..render.Renderer` of the model at the trainer's tuned
        bounds and calibrated termination cap."""
        return Renderer(self.model, self.mesh, self.device,
                        occ_depth_cap=self.occ_depth_cap, max_steps=self.max_steps,
                        bucket_steps=self.tuned_bucket_steps)

    def eval_batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The eval forward of one batch (``origins``, ``directions``) as
        device tensors (JAX ``Trainer.eval_batch``)."""
        with self.lock:
            return self.renderer().render_batch(batch["origins"], batch["directions"])

    def render_rays(self, origins, directions, chunk: int = 8192,
                    num_samples: Optional[int] = None,
                    num_fine_samples: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Render ``[N, 3]`` rays in chunks as numpy arrays (JAX
        ``Trainer.render_rays``); ``num_samples``/``num_fine_samples``
        override the sample budget (``num_fine_samples=0`` skips the PDF
        round)."""
        with self.lock:
            return self.renderer().render_rays(origins, directions, chunk,
                                               num_samples, num_fine_samples)

    # ------------------------------------------------ static-camera cache
    @torch.inference_mode()
    def cache_camera(self, origins, directions, chunk: int = 8192,
                     sort_by_depth: bool = False) -> dict:
        """March a camera's ``[N, 3]`` rays once, geometry only (K1), and keep
        each chunk's march on the device, for :meth:`render_cached` to
        re-shade against the parameters of the time (JAX
        ``Trainer.cache_camera``). Chunks are padded as
        :meth:`render_rays` pads them, and march at the eval forward's bound
        and termination settings, so a re-shade reproduces
        :meth:`render_rays`.

        ``sort_by_depth`` marches twice: the first pass gives every ray's
        crossing count, then the rays are re-chunked in that order (stably)
        and each chunk re-marched at its own bound, ``grid_ceil`` of its
        deepest ray (at least 16, at most the full bound), so that a
        shallow chunk is shaded at its own depth.

        Returns ``{"chunks": [(march, origins, directions)], "chunk",
        "num_rays"}``, and with ``sort_by_depth`` also ``"perm"`` (the
        order of the rays) and ``"bounds"`` (one per chunk)."""
        cfg = self.model.config
        origins = torch.as_tensor(np.asarray(origins, np.float32))
        directions = torch.as_tensor(np.asarray(directions, np.float32))
        num = origins.shape[0]
        with self.lock:
            # One snapshot for both passes: an occupancy write swaps the mesh
            # for a new table, and the cap moves at a retune.
            mesh, cap, full = self.mesh, self.occ_depth_cap, self.max_steps

            def march_chunks(o_all, d_all, bounds=None):
                return [
                    (march_features(mesh, None, o, d, bounds[ci] if bounds else full,
                                    use_occupancy=cfg.use_occupancy_field,
                                    occ_threshold=cfg.occupancy_threshold,
                                    occ_depth_cap=cap), o, d)
                    for ci, (o, d, _) in enumerate(chunks(o_all, d_all, chunk, self.device))
                ]

            marched = march_chunks(origins, directions)
            if not sort_by_depth:
                return {"chunks": marched, "chunk": chunk, "num_rays": num}
            # Every chunk's crossing counts in one transfer.
            nv = torch.cat([
                res.num_valid[: min(chunk, num - ci * chunk)]
                for ci, (res, _, _) in enumerate(marched)
            ]).cpu().numpy()
            perm = np.argsort(nv, kind="stable")
            bounds = [
                min(full, grid_ceil(max(int(nv[perm[i : i + chunk]].max()), 16)))
                for i in range(0, num, chunk)
            ]
            order = torch.from_numpy(perm)
            marched = march_chunks(origins[order], directions[order], bounds)
        return {"chunks": marched, "chunk": chunk, "num_rays": num,
                "perm": perm, "bounds": bounds}

    def adaptive_budget(self, bounds, ci: int, num_samples: Optional[int] = None,
                        num_fine_samples: Optional[int] = None) -> tuple:
        """``(num_samples, num_fine_samples)`` of chunk ``ci`` of a
        depth-sorted cache (JAX ``Trainer.adaptive_budget``): the budgets
        scaled by the chunk's bound over the deepest, so that the samples
        per crossing never drop below the full budget's, rounded up on the
        bound grid, at least 16; a zero fine budget stays 0."""
        cfg = self.model.config
        t_c = bounds[ci]
        full = max(bounds) if bounds else 1
        base_ns = num_samples if num_samples is not None else cfg.num_samples
        base_nf = num_fine_samples if num_fine_samples is not None else cfg.num_fine_samples
        frac = t_c / max(full, 1)
        ns = min(base_ns, grid_ceil(max(16, base_ns * frac)))
        nf = min(base_nf, grid_ceil(max(16, base_nf * frac))) if base_nf else base_nf
        return ns, nf

    @torch.inference_mode()
    def render_cached(self, cache: dict, num_samples: Optional[int] = None,
                      num_fine_samples: Optional[int] = None,
                      adaptive_samples: bool = False) -> Dict[str, np.ndarray]:
        """Re-shade a camera cached by :meth:`cache_camera` with the current
        parameters, without a march (JAX ``Trainer.render_cached``); the
        outputs of :meth:`render_rays`, in the rays' own order.

        A depth-sorted chunk is shaded at its own bound with every bucket
        bound equal to it, so the plain forward runs (no bucket slice);
        ``adaptive_samples`` scales its sample budget by
        :meth:`adaptive_budget`. An unsorted chunk is shaded as
        :meth:`render_rays` shades it, in buckets at the tuned bounds."""
        bounds = cache.get("bounds")
        outs = []
        with self.lock:
            model = self.model
            for ci, (cached, o, d) in enumerate(cache["chunks"]):
                t_c = bounds[ci] if bounds else None
                ns, nf = num_samples, num_fine_samples
                if adaptive_samples and t_c is not None:
                    ns, nf = self.adaptive_budget(bounds, ci, ns, nf)
                out = model.get_outputs(
                    o, d, self.mesh, num_samples=ns, num_fine_samples=nf,
                    short_steps=t_c,
                    bucket_steps=None if t_c else self.tuned_bucket_steps,
                    cached_march=cached,
                )
                valid = min(cache["chunk"], cache["num_rays"] - ci * cache["chunk"])
                outs.append({k: v[:valid] for k, v in out.items()})
        out = {k: torch.cat([o_[k] for o_ in outs]).cpu().numpy() for k in outs[0]}
        perm = cache.get("perm")
        if perm is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            out = {k: v[inv] for k, v in out.items()}
        return out

    # -------------------------------------------------------- checkpoint
    def save_checkpoint(self, path) -> None:
        """Write the step, parameters, optimizer state and occupancy EMA
        into the directory ``path`` (:func:`.checkpoints.save_checkpoint`).
        With a group rank 0 writes, and every rank waits for it; with model
        shards the ranks of data index 0 first gather the full field and
        moments (:func:`.checkpoints.trainer_state`)."""
        state = checkpoints.trainer_state(self) if self.evaluates else None
        if self.is_main:
            checkpoints.save_checkpoint(path, self, state)
        if self.group is not None:
            self.group.barrier()

    def restore_checkpoint(self, path) -> None:
        """Load a directory written by :meth:`save_checkpoint`. The bounds
        and the cap are not saved: the next step tunes them if this
        trainer has not yet. The count of steps taken, which times the
        occupancy work, is not restored either. With model shards each
        rank keeps its columns of the saved field and moments."""
        with self.lock:
            checkpoints.restore_checkpoint(path, self)
            self.march_version += 1

    # -------------------------------------------------------------- loop
    def fit(self, next_batch: Callable[[int], Dict[str, np.ndarray]],
            num_iterations: Optional[int] = None, log_every: int = 100, log_fn=print,
            eval_fn: Optional[Callable[[int, "Trainer"], None]] = None,
            eval_every: Optional[int] = None, prefetch: int = 2,
            viewer=None) -> "Trainer":
        """The training loop (JAX ``Trainer.fit``). ``next_batch(i)`` gives
        step ``i``'s batch; ``eval_fn(step, trainer)`` runs every
        ``eval_every`` steps (default ``steps_per_eval_batch``); a log line
        every ``log_every`` steps; a checkpoint ``step-{step:09d}`` under
        ``output_dir`` every ``steps_per_save`` steps.

        With ``prefetch`` > 0 a producer thread calls ``next_batch`` once
        per step, in order, up to ``prefetch`` steps ahead of the train step
        and concurrently with ``eval_fn``, and its errors are re-raised
        here: ``next_batch`` must be a function of ``i`` and its own state
        (numpy only). One that reads the trainer or shares a generator with
        ``eval_fn`` needs ``prefetch=0``.

        With a group ``next_batch(i)`` gives the global batch on every rank
        and each rank trains on its data shard's ``host_batch_slice``; rank 0
        logs (the rays/s of the global batch) and writes the checkpoints,
        and the ranks of :attr:`evaluates` run ``eval_fn`` while the others
        wait at a barrier (with model shards ``eval_fn`` runs on every rank
        of data index 0, whose forwards gather over their model group: let
        it write only on :attr:`is_main`).

        ``viewer``, a :class:`~..viewer.ViewerServer` of this trainer, has its
        queue opened when the loop starts and its queued frames served at
        every step boundary, the last one closing it
        (:meth:`~..viewer.ViewerServer.serve_queued`): with model shards
        every rank passes its own. A viewer without model shards renders on
        its HTTP threads and needs no turn here."""
        num_iterations = num_iterations or self.config.max_num_iterations
        eval_every = eval_every or self.config.steps_per_eval_batch
        if not prefetch or num_iterations <= 1:
            self._fit_loop(next_batch, num_iterations, log_every, log_fn, eval_fn,
                           eval_every, viewer)
            return self

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                for j in range(num_iterations):
                    put(next_batch(j))  # exactly once per step
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised by the consumer
                put(e)

        def get_batch(_):
            b = q.get()
            if isinstance(b, BaseException):
                raise b
            return b

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            self._fit_loop(get_batch, num_iterations, log_every, log_fn, eval_fn,
                           eval_every, viewer)
        finally:
            stop.set()
            while not q.empty():  # unblock a producer waiting on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            producer.join()
        return self

    def _fit_loop(self, next_batch, num_iterations, log_every, log_fn, eval_fn,
                  eval_every, viewer=None) -> None:
        t0 = t_start = time.perf_counter()
        rays_per_batch = None
        steps_at_t0 = 0
        group = self.group
        if viewer is not None:
            viewer.open_queue()
        for i in range(num_iterations):
            batch = next_batch(i)
            if rays_per_batch is None:
                rays_per_batch = len(batch["origins"])
            if group is not None:
                rows = group.batch_slice(len(batch["origins"]))
                batch = {k: v[rows] for k, v in batch.items()}
            metrics = self.train_step(batch)
            if i == 0:
                # Restart the rate clock after step 1, which pays for the
                # kernel build and the bound tune.
                float(metrics["loss"])
                t0 = time.perf_counter()
                steps_at_t0 = 1
            if eval_fn is not None and eval_every and (i + 1) % eval_every == 0:
                if self.evaluates:
                    eval_fn(i + 1, self)
                if group is not None:
                    group.barrier()
            if viewer is not None:
                viewer.serve_queued(last=i + 1 == num_iterations)
            if log_every and (i + 1) % log_every == 0 and self.is_main:
                # The only host syncs besides step 1's.
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                steps_done = i + 1 - steps_at_t0
                # log_every=1: the first log line is step 1 itself.
                if steps_done == 0:
                    steps_done, dt = 1, time.perf_counter() - t_start
                rate = steps_done * rays_per_batch / max(dt, 1e-9)
                ovf = int(metrics.get("overflow_rays", 0))
                gsd = int(metrics.get("grad_stream_dropped_rays", 0))
                log_fn(
                    f"step {i + 1}/{num_iterations} "
                    f"loss={metrics['loss']:.5f} psnr={metrics['psnr']:.2f} "
                    f"rays/s={rate:,.0f}"
                    + (f" OVERFLOW={ovf} rays truncated" if ovf else "")
                    + (f" GRAD-DROPPED={gsd} rays (raise grad_stream_budget_per_ray)"
                       if gsd else "")
                )
            if (self.config.output_dir and self.config.steps_per_save
                    and (i + 1) % self.config.steps_per_save == 0):
                self.save_checkpoint(
                    os.path.join(self.config.output_dir, f"step-{i + 1:09d}"))
