"""Checkpoints, and weights across packages: the JAX parameter tree and
the reference's state-dict names and layouts.

A checkpoint is a directory (counterpart of the JAX package's
``save_checkpoint`` / ``restore_checkpoint`` and ``Trainer.save_checkpoint``
/ ``restore_checkpoint``, in the port's own format: JAX writes orbax):

- ``state.pt``: the model's and the optimizer's state dicts and the step,
  one ``torch.save`` file;
- ``train_config.json``: the :class:`~.presets.TrainConfig`, written by the
  JAX package's encoder;
- ``occupancy.npy``: the per-cell density EMA, when it exists.

As in JAX, neither the tuned bounds nor the calibrated termination cap are
saved: a trainer restored from a checkpoint tunes on its first step. Across
packages the weights move through :func:`reference_state_dict` and
:func:`params_from_jax`.

:func:`reference_state_dict` / :func:`load_reference_state_dict` are the
counterparts of the JAX package's. The reference stores the field ``[F, V]``
and torch-Linear weights ``[out, in]``
(``tetranerf/nerfstudio/model.py:249-255``); the JAX package stores
``[V, F]`` and ``[in, out]``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

STATE_FILE = "state.pt"
CONFIG_FILE = "train_config.json"
OCCUPANCY_FILE = "occupancy.npy"
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


def _encode(o):
    """JSON-ready copy of a config (the JAX package's encoder)."""
    if dataclasses.is_dataclass(o):
        return {k: _encode(v) for k, v in dataclasses.asdict(o).items()}
    if isinstance(o, dict):
        return {k: _encode(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_encode(v) for v in o]
    if isinstance(o, os.PathLike):
        return str(o)
    return o


def save_checkpoint(path, trainer) -> None:
    """Write ``trainer``'s state into the directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save({"model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "step": int(trainer.step)}, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(_encode(trainer.config), f, indent=2, default=str)
    if trainer.occupancy is not None:
        # The warm EMA: resuming from zeros is exact (zero occupancy never
        # stops a ray) but cold for a few hundred steps.
        np.save(os.path.join(path, OCCUPANCY_FILE), trainer.occupancy.cpu().numpy())


def restore_checkpoint(path, trainer) -> None:
    """Load the directory ``path`` into ``trainer``: the step (which the
    learning-rate schedule and the step's random stream read), the
    parameters, RAdam's state and, with ``use_occupancy_field``, the EMA,
    written into column 24 of the march table, and the skip grid rebuilt
    from it (with ``skip_grid_resolution``)."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, STATE_FILE), map_location=trainer.device,
                       weights_only=True)
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.step = int(state["step"])
    occ = os.path.join(path, OCCUPANCY_FILE)
    if trainer.model.config.use_occupancy_field and os.path.exists(occ):
        trainer.occupancy = torch.from_numpy(np.load(occ)).to(trainer.device)
        trainer._write_occupancy()
        trainer._rebuild_skip_grid()
