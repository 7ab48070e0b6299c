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

A checkpoint always holds the whole field ``[V, F]`` and RAdam's whole
moments of it, whatever the run's model shards: a trainer with model shards
gathers them (:func:`trainer_state`) and keeps its own columns when it
restores, so a checkpoint moves between one process and any ``D x M``
grid.

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


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _field_index(trainer) -> int:
    """The field's index among the optimizer's parameters (it is built over
    ``model.parameters()``, in that order)."""
    field = trainer.model.tetrahedra_field
    return next(i for i, p in enumerate(trainer.model.parameters()) if p is field)


def trainer_state(trainer) -> dict:
    """``{"model", "optimizer", "step"}``: the state dicts with the whole
    field and whole moments. With model shards every rank of the model
    group must call this (one gather of the field and its two moments)."""
    model_sd = trainer.model.state_dict()
    opt_sd = trainer.optimizer.state_dict()
    group = trainer.model.field_group
    if group is not None:
        i = _field_index(trainer)
        # A copy: the packed state shares its per-parameter dicts with the
        # optimizer's own.
        state = dict(opt_sd["state"].get(i, {}))
        names = ["tetrahedra_field"] + [k for k in _MOMENTS if k in state]
        full = group.gather_columns(
            [model_sd["tetrahedra_field"]] + [state[k] for k in names[1:]])
        model_sd["tetrahedra_field"] = full[0]
        state.update(zip(names[1:], full[1:]))
        if i in opt_sd["state"]:
            opt_sd["state"][i] = state
    return {"model": model_sd, "optimizer": opt_sd, "step": int(trainer.step)}


def save_checkpoint(path, trainer, state=None) -> None:
    """Write ``trainer``'s state (``state``: :func:`trainer_state`, taken
    here when None) into the directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(state or trainer_state(trainer), os.path.join(path, STATE_FILE))
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
    from it (with ``skip_grid_resolution``). With model shards the
    trainer keeps its columns of the field and its moments."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, STATE_FILE), map_location=trainer.device,
                       weights_only=True)
    group = trainer.model.field_group
    if group is not None:
        cols = group.field_columns(state["model"]["tetrahedra_field"].shape[1])
        state["model"]["tetrahedra_field"] = state["model"]["tetrahedra_field"][:, cols]
        moments = state["optimizer"]["state"].get(_field_index(trainer), {})
        for k in _MOMENTS:
            if k in moments:
                moments[k] = moments[k][:, cols].contiguous()
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.step = int(state["step"])
    occ = os.path.join(path, OCCUPANCY_FILE)
    if trainer.model.config.use_occupancy_field and os.path.exists(occ):
        trainer.occupancy = torch.from_numpy(np.load(occ)).to(trainer.device)
        trainer._write_occupancy()
        trainer._rebuild_skip_grid()
