"""Positional (NeRF) encoding.

Counterpart of :mod:`tetranerf_tpu.ops.encoding`: inputs scaled by 2*pi,
frequencies ``2**linspace(min_exp, max_exp, num)``, ``sin`` of the scaled
inputs then of the scaled inputs shifted by pi/2, the raw input appended.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def nerf_encoding(
    x: torch.Tensor,
    num_frequencies: int,
    min_freq_exp: float = 0.0,
    max_freq_exp: Optional[float] = None,
    include_input: bool = True,
) -> torch.Tensor:
    if num_frequencies == 0:
        return x
    if max_freq_exp is None:
        max_freq_exp = float(num_frequencies)
    freqs = 2.0 ** torch.linspace(
        min_freq_exp, max_freq_exp, num_frequencies, dtype=x.dtype,
        device=x.device,
    )
    scaled = 2.0 * math.pi * x
    s = (scaled[..., None] * freqs).flatten(-2)  # [..., D*F]
    encoded = torch.sin(torch.cat([s, s + math.pi / 2.0], dim=-1))
    if include_input:
        encoded = torch.cat([encoded, x], dim=-1)
    return encoded


def nerf_encoding_dim(
    in_dim: int, num_frequencies: int, include_input: bool = True
) -> int:
    if num_frequencies == 0:
        return in_dim
    return in_dim * num_frequencies * 2 + (in_dim if include_input else 0)
