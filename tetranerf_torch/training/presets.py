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
    """Data shards: the ranks the run was started with over
    ``num_model_shards`` (None: all of them, as JAX's None takes every
    local device)."""
    num_model_shards: int = 1
    """Shards of the feature field over its feature axis (JAX's ``model``
    mesh axis): the ranks form ``world / M`` data shards by ``M`` model
    shards, and each holds ``field_dim / M`` columns of the field."""


def check_shards(config: TrainConfig, world: int = 1) -> None:
    """Raise ``ValueError`` unless ``world`` ranks form the grid the config
    asks for: ``world`` divisible by ``num_model_shards`` M, the field's
    width divisible by M (JAX ``make_mesh`` and ``state_shardings``), and
    ``num_data_shards`` None or ``world / M``."""
    from ..parallel.distributed import check_model_shards, column_slice

    model_shards = config.num_model_shards or 1
    check_model_shards(world, model_shards)
    column_slice(config.model.field_dim, 0, model_shards)
    if config.num_data_shards not in (None, world // model_shards):
        raise ValueError(
            f"num_data_shards={config.num_data_shards} but the run has {world} "
            f"rank(s) over {model_shards} model shard(s): start num_data_shards x "
            "num_model_shards ranks (torchrun --nproc-per-node), or leave it None"
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
