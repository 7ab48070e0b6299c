"""Weights across packages: the JAX parameter tree and the reference's
state-dict names and layouts.

Counterpart of ``reference_state_dict`` / ``load_reference_state_dict`` in
:mod:`tetranerf_tpu.training.checkpoints`. The reference stores the field
``[F, V]`` and torch-Linear weights ``[out, in]``
(``tetranerf/nerfstudio/model.py:249-255``); the JAX package stores
``[V, F]`` and ``[in, out]``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_MLPS = ("mlp_base", "mlp_head")
_HEADS = ("field_output_color", "field_output_density")


def reference_state_dict(model) -> Dict[str, np.ndarray]:
    """The model's parameters under the reference's tensor names."""
    out = {"tetrahedra_field": model.tetrahedra_field.detach().cpu().numpy().T}
    for name in _MLPS:
        for i, layer in enumerate(getattr(model, name).layers):
            out[f"{name}.layers.{2 * i}.weight"] = layer.weight.detach().cpu().numpy()
            out[f"{name}.layers.{2 * i}.bias"] = layer.bias.detach().cpu().numpy()
    for name in _HEADS:
        head = getattr(model, name)
        out[f"{name}.net.weight"] = head.weight.detach().cpu().numpy()
        out[f"{name}.net.bias"] = head.bias.detach().cpu().numpy()
    if hasattr(model, "appearance_embedding"):
        out["appearance_embedding.weight"] = (
            model.appearance_embedding.detach().cpu().numpy()
        )
    return out


@torch.no_grad()
def load_reference_state_dict(model, state_dict: Mapping[str, Any]) -> None:
    """Copy reference-layout tensors into the model's parameters; names
    the dict lacks keep their values."""

    def put(param, value):
        value = torch.from_numpy(np.array(value, np.float32))
        if value.shape != param.shape:
            raise ValueError(
                f"shape {tuple(value.shape)} does not fit {tuple(param.shape)}"
            )
        param.copy_(value)

    if "tetrahedra_field" in state_dict:
        put(model.tetrahedra_field, np.asarray(state_dict["tetrahedra_field"]).T)
    for name in _MLPS:
        for i, layer in enumerate(getattr(model, name).layers):
            for part in ("weight", "bias"):
                key = f"{name}.layers.{2 * i}.{part}"
                if key in state_dict:
                    put(getattr(layer, part), state_dict[key])
    for name in _HEADS:
        for part in ("weight", "bias"):
            key = f"{name}.net.{part}"
            if key in state_dict:
                put(getattr(getattr(model, name), part), state_dict[key])
    if "appearance_embedding.weight" in state_dict:
        put(model.appearance_embedding, state_dict["appearance_embedding.weight"])


def params_from_jax(model, params: Mapping[str, Any]) -> None:
    """Load the JAX package's ``params`` tree (leaves as numpy arrays, e.g.
    after ``jax.tree_util.tree_map(np.asarray, params)``) into ``model``."""
    sd = {"tetrahedra_field": np.asarray(params["tetrahedra_field"]).T}
    for name in _MLPS:
        for i, layer in enumerate(params[name]):
            sd[f"{name}.layers.{2 * i}.weight"] = np.asarray(layer["kernel"]).T
            sd[f"{name}.layers.{2 * i}.bias"] = np.asarray(layer["bias"])
    for name in _HEADS:
        sd[f"{name}.net.weight"] = np.asarray(params[name]["kernel"]).T
        sd[f"{name}.net.bias"] = np.asarray(params[name]["bias"])
    if "appearance_embedding" in params:
        sd["appearance_embedding.weight"] = np.asarray(params["appearance_embedding"])
    load_reference_state_dict(model, sd)
