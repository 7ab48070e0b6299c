"""RAdam with exponential learning-rate decay, as ``make_optimizer`` of
:mod:`tetranerf_tpu.training.trainer` builds it from optax
(``optax.radam(optax.exponential_decay(...))``, reference
``registration.py:37-45``)."""

from __future__ import annotations

import math

import torch

_BETAS = (0.9, 0.999)
_EPS = 1e-8


def learning_rate(config, count: int) -> float:
    """``lr0 * (lr_final / lr0) ** (count / lr_max_steps)`` for an
    optimizer that has taken ``count`` updates (optax evaluates its
    schedule at the update count before the update)."""
    decay = config.learning_rate_final / config.learning_rate
    return config.learning_rate * decay ** (count / config.lr_max_steps)


def make_optimizer(params, config) -> torch.optim.RAdam:
    """``torch.optim.RAdam`` with optax's defaults (betas 0.9 / 0.999, eps
    1e-8, no weight decay). Call :func:`set_step` before each ``step()``."""
    return torch.optim.RAdam(
        params, lr=config.learning_rate, betas=_BETAS, eps=_EPS, weight_decay=0.0
    )


def set_step(optimizer: torch.optim.Optimizer, config, count: int) -> None:
    """Set the learning rate and eps of update ``count + 1``.

    optax adds eps to ``sqrt(v_hat) = sqrt(v) / sqrt(1 - b2^t)``, torch to
    ``sqrt(v)``; scaling torch's eps by ``sqrt(1 - b2^t)`` makes the two
    rectified updates the same function (it matters where ``sqrt(v_hat)``
    is near eps: field rows that a batch barely touches)."""
    lr = learning_rate(config, count)
    eps = _EPS * math.sqrt(1.0 - _BETAS[1] ** (count + 1))
    for group in optimizer.param_groups:
        group["lr"] = lr
        group["eps"] = eps
