"""Training presets: the port's copy of
:mod:`tetranerf_tpu.training.presets` (the reference's method
registrations, ``tetranerf/nerfstudio/registration.py:20-67``).

``tetra-nerf-original`` is the paper configuration (256 uniform + 256 PDF
samples, no gradient scaling); ``tetra-nerf`` is the improved default
(128 biased + 128 PDF samples, gradient scaling, occupancy termination and
8 quantile buckets: :func:`..models.config.tetranerf_preset`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.config import TetrahedraNerfConfig
from ..models.config import tetranerf_preset as _model_preset


@dataclasses.dataclass
class TrainConfig:
    """Every field of the JAX package's ``TrainConfig``, with the same
    names and defaults."""

    method_name: str = "tetra-nerf"
    model: TetrahedraNerfConfig = dataclasses.field(
        default_factory=TetrahedraNerfConfig
    )
    max_num_iterations: int = 300_000
    train_num_rays_per_batch: int = 4096
    eval_num_rays_per_batch: int = 4096
    steps_per_save: int = 25_000
    steps_per_eval_batch: int = 1_000
    steps_per_eval_image: int = 2_000
    steps_per_eval_all_images: int = 50_000
    # RAdam lr 1e-3 with exponential decay to 1e-4 over max_steps
    # (``registration.py:37-45``).
    learning_rate: float = 1e-3
    learning_rate_final: float = 1e-4
    lr_max_steps: int = 300_000
    seed: int = 42
    output_dir: Optional[str] = None
    num_data_shards: Optional[int] = None
    """Data-parallel shards: the ranks the run was started with (None: all
    of them, as JAX's None takes every local device)."""
    num_model_shards: int = 1
    """Shards of the feature field; only 1 is accepted (``ROADMAP.md`` A9b)."""


def check_shards(config: TrainConfig, world: int = 1) -> None:
    """Refuse feature-field shards, which the port lacks, and a data shard
    count other than the ``world`` of ranks the run was started with."""
    if config.num_model_shards not in (None, 1):
        raise NotImplementedError(
            "not ported to tetranerf_torch yet (ROADMAP A9b): num_model_shards="
            f"{config.num_model_shards}; the port shards the data, not the field"
        )
    if config.num_data_shards not in (None, world):
        raise ValueError(
            f"num_data_shards={config.num_data_shards} but the run has {world} "
            "rank(s): start one rank per data shard (torchrun --nproc-per-node), "
            "or leave it None"
        )


def tetranerf_original_preset(**overrides) -> TrainConfig:
    cfg = TrainConfig(
        method_name="tetra-nerf-original",
        model=TetrahedraNerfConfig(
            num_samples=256,
            num_fine_samples=256,
            use_biased_sampler=False,
            use_gradient_scaling=False,
        ),
    )
    return dataclasses.replace(cfg, **overrides)


def tetranerf_preset(**overrides) -> TrainConfig:
    cfg = TrainConfig(method_name="tetra-nerf", model=_model_preset())
    return dataclasses.replace(cfg, **overrides)


METHODS = {
    "tetra-nerf": tetranerf_preset,
    "tetra-nerf-original": tetranerf_original_preset,
}
