"""The train step: occupancy upkeep, forward, MSE loss, backward, RAdam.

Counterpart of ``Trainer.train_step`` and ``make_train_step`` in
:mod:`tetranerf_tpu.training.trainer`, on one device and with
``ray_buckets=1``. Before a step, as in the JAX trainer:

- on the first call, a geometry-only probe tightens the march bound to the
  scene (:meth:`Trainer.tune_traversal_steps`);
- every ``occupancy_update_every`` steps from step 0, a ray-based update
  of the per-cell density EMA (:meth:`Trainer.update_occupancy`);
- every ``occupancy_refresh_every`` steps after step 0, a refresh at every
  cell centroid (:meth:`Trainer.refresh_occupancy`);

each written into column 24 of the march table. The transmittance retune
(JAX ``trainer.py:687-963``) is not ported: a step at which
``occupancy_retune_every`` would fire raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.fused import biased_warp_range, march_features, ray_bounds, sample_features
from ..ops.march import march
from ..ops.sampling import stratified_bins
from ..utils.shapes import rounded_bound
from .optim import make_optimizer, set_step

_PROBE_RAYS = 8192
_REFRESH_CHUNK = 65536


@dataclasses.dataclass
class TrainConfig:
    """The fields of :class:`tetranerf_tpu.training.presets.TrainConfig`
    that the train step reads (same names and defaults)."""

    learning_rate: float = 1e-3
    learning_rate_final: float = 1e-4
    lr_max_steps: int = 300_000
    seed: int = 42


class Trainer:
    """Trains ``model`` (a :class:`~..models.TetraNerf`) on ``mesh`` (a
    :class:`~..geometry.TorchMesh`), both moved to ``device``.

    Usage::

        trainer = Trainer(TrainConfig(), model, mesh)
        metrics = trainer.train_step({"origins": o, "directions": d, "rgb": c})

    A batch holds ``origins [R, 3]``, ``directions [R, 3]``, ``rgb [R, 3]``
    and optionally ``camera_indices [R]`` (numpy arrays or tensors)."""

    def __init__(self, config: TrainConfig, model, mesh, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.mesh = mesh.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), config)
        self.step = 0
        """Updates taken so far (the JAX ``TrainState.step``)."""
        self.tuned_max_steps: Optional[int] = None
        self._tuned = False
        cfg = model.config
        self.occupancy: Optional[torch.Tensor] = None
        """Per-cell density EMA ``f32[C]`` (None until the first update)."""
        self.occ_depth_cap = float(-np.log(cfg.occupancy_threshold))
        self._generator = torch.Generator(device=self.device)

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @property
    def max_steps(self) -> int:
        return self.tuned_max_steps or self.model.config.max_intersected_triangles

    # ------------------------------------------------------------ bounds
    @torch.no_grad()
    def tune_traversal_steps(self, batch: Mapping) -> int:
        """March up to 8192 of the batch's rays without occupancy and set
        the bound to 1.5x the deepest crossing count, rounded up to the
        bound grid, if that is below the configured bound."""
        cfg = self.model.config
        o = self._tensor(batch["origins"][:_PROBE_RAYS])
        d = self._tensor(batch["directions"][:_PROBE_RAYS])
        num_valid = march(self.mesh, o, d, cfg.max_intersected_triangles).num_valid
        tuned = min(cfg.max_intersected_triangles,
                    rounded_bound(int(num_valid.max())))
        if tuned < cfg.max_intersected_triangles:
            self.tuned_max_steps = tuned
        return self.max_steps

    # --------------------------------------------------------- occupancy
    def _ensure_occupancy(self):
        if self.occupancy is None:
            self.occupancy = torch.zeros(self.mesh.num_cells, device=self.device)

    def _write_occupancy(self):
        self.mesh = self.mesh.with_occupancy(self.occupancy)

    @torch.no_grad()
    def update_occupancy(self, batch: Mapping) -> None:
        """Ray-based EMA update: march the batch with occupancy termination,
        take each interval's mean sample density (deterministic coarse
        bins), and set ``occ = max(decay * occ, density)`` per crossed cell
        (JAX ``Trainer._occupancy_update_fn``)."""
        self._ensure_occupancy()
        model = self.model
        cfg = model.config
        o = self._tensor(batch["origins"])
        d = self._tensor(batch["directions"])
        res = march_features(
            self.mesh, model.tetrahedra_field, o, d, self.max_steps,
            use_occupancy=True, occ_depth_cap=self.occ_depth_cap,
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
        self._write_occupancy()

    @torch.no_grad()
    def refresh_occupancy(self) -> None:
        """Full-coverage refresh: the density at every cell centroid (the
        mean of its four vertex features) maxed into the decayed EMA (JAX
        ``Trainer.refresh_occupancy``)."""
        self._ensure_occupancy()
        model = self.model
        field = model.tetrahedra_field
        cells = self.mesh.cells.long()
        dens = torch.cat([
            model.density_at(field[cells[i : i + _REFRESH_CHUNK]].mean(dim=1))
            for i in range(0, cells.shape[0], _REFRESH_CHUNK)
        ])
        self.occupancy = torch.maximum(
            self.occupancy * model.config.occupancy_decay, dens
        )
        self._write_occupancy()

    # -------------------------------------------------------------- step
    def _step_generator(self, step: int) -> torch.Generator:
        """The step's random stream: a function of the seed and the step
        count (the JAX step folds the step into its key)."""
        seed = int(np.random.SeedSequence([self.config.seed, step]).generate_state(1)[0])
        return self._generator.manual_seed(seed)

    def train_step(self, batch: Mapping, uniforms: Optional[Mapping] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimisation step. ``uniforms`` (keys of
        :func:`~..models.tetra_nerf.draw_uniforms`) replace the step's own
        random numbers. Returns ``loss``, ``psnr`` and ``overflow_rays``
        (rays whose march reached the bound) as device scalars."""
        cfg = self.model.config
        step = self.step
        occ = cfg.use_occupancy_field
        if (occ and cfg.occupancy_retune_every and step > 0
                and step % cfg.occupancy_retune_every == 0):
            raise NotImplementedError(
                f"step {step}: the occupancy bound retune "
                f"(occupancy_retune_every={cfg.occupancy_retune_every}) is not "
                "ported yet (ROADMAP.md, Next: the transmittance retune)"
            )
        if not self._tuned:
            self._tuned = True
            self.tune_traversal_steps(batch)
        if occ and cfg.occupancy_update_every and step % cfg.occupancy_update_every == 0:
            self.update_occupancy(batch)
        if (occ and cfg.occupancy_refresh_every and step > 0
                and step % cfg.occupancy_refresh_every == 0):
            self.refresh_occupancy()

        o = self._tensor(batch["origins"])
        d = self._tensor(batch["directions"])
        target = self._tensor(batch["rgb"])
        cams = batch.get("camera_indices")
        if cams is not None:
            cams = self._tensor(cams, torch.int64)
        model = self.model
        out = model.get_outputs(
            o, d, self.mesh, max_steps=self.max_steps,
            occ_depth_cap=self.occ_depth_cap, train=True,
            generator=None if uniforms is not None else self._step_generator(step),
            uniforms=uniforms, camera_indices=cams,
        )
        loss = model.loss(out, target)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_step(self.optimizer, self.config, step)
        self.optimizer.step()
        self.step += 1
        loss = loss.detach()
        return {
            "loss": loss,
            "psnr": -10.0 * torch.log10(loss + 1e-12),
            "overflow_rays": out["traversal_overflow"].sum(),
        }
