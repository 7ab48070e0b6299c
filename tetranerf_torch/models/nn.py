"""Linear and MLP modules under the JAX package's precision contract.

Counterpart of :mod:`tetranerf_tpu.models.nn`: parameters are f32; a
layer casts its operands (input, weight, bias) to ``compute_dtype``,
accumulates in f32, and stores its output in ``out_dtype`` (hidden layer
boundaries in ``compute_dtype``, the last layer in f32 by default).
Initialization is torch-Linear's: weight and bias ``U(-1/sqrt(in), 1/sqrt(in))``.
Weights are stored ``[out, in]`` (the JAX package stores ``[in, out]``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, generator=None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.weight = nn.Parameter(
            torch.empty(out_dim, in_dim, device=device).uniform_(
                -bound, bound, generator=generator
            )
        )
        self.bias = nn.Parameter(
            torch.empty(out_dim, device=device).uniform_(
                -bound, bound, generator=generator
            )
        )

    def forward(
        self,
        x: torch.Tensor,
        compute_dtype: torch.dtype = torch.float32,
        out_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        out_dtype = out_dtype or torch.float32
        w = self.weight.to(compute_dtype)
        b = self.bias.to(compute_dtype)
        x = x.to(compute_dtype)
        if out_dtype == compute_dtype:
            # f32 accumulation inside the GEMM, one rounding to the output.
            return F.linear(x, w, b)
        # Exact products of the rounded operands, accumulated in f32.
        return F.linear(x.float(), w.float(), b.float()).to(out_dtype)


class MLP(nn.Module):
    """``num_layers`` Linear layers of ``width`` outputs with ReLU between
    them."""

    def __init__(
        self, in_dim: int, num_layers: int, width: int, generator=None,
        device=None,
    ):
        super().__init__()
        dims = [in_dim] + [width] * num_layers
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], generator=generator, device=device)
            for i in range(len(dims) - 1)
        )

    def forward(
        self,
        x: torch.Tensor,
        out_activation: Optional[Callable] = None,
        compute_dtype: torch.dtype = torch.float32,
        final_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            hidden = i + 1 < len(self.layers)
            x = layer(x, compute_dtype, compute_dtype if hidden else final_dtype)
            if hidden:
                x = torch.relu(x)
        if out_activation is not None:
            x = out_activation(x)
        return x
