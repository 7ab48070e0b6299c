"""The torch serving API over a trained :class:`~.training.trainer.Trainer`.

Counterpart of :mod:`tetranerf_tpu.torch_adapter`. ``ns-eval`` and the
nerfstudio viewer drive a model through chunked ``get_outputs(ray_bundle)``
calls and read ``rgb``/``depth``/``accumulation`` tensors (reference
``tetranerf/nerfstudio/model.py:520-662``); :class:`TorchRenderAdapter`
gives that surface, torch tensors in and torch tensors out. The port is
torch-native, so the rays stay on their device: the adapter chunks and pads
them as :meth:`~.render.Renderer.render_rays` does (the same
:meth:`~.render.Renderer.render_tensors`), and its outputs equal
``trainer.render_rays``'s bit for bit. Parameters move under the
reference's tensor names and layouts
(:func:`~.training.checkpoints.reference_state_dict`).

With model shards the trainer's forwards gather the field's columns over
the model group: every rank of data index 0 (``trainer.evaluates``) makes
the same calls, as eval does, and :meth:`TorchRenderAdapter.state_dict`
returns the whole field, as a checkpoint holds it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _rays(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class TorchRenderAdapter:
    """Chunked torch-tensor render interface of ``trainer``'s model: rays go
    through the model ``chunk`` at a time (the reference's eval path chunks
    the same way through nerfstudio)."""

    def __init__(self, trainer, chunk: int = 8192):
        self.trainer = trainer
        self.chunk = chunk

    # ------------------------------------------------------------- render
    def get_outputs(self, origins, directions, num_samples: Optional[int] = None,
                    num_fine_samples: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Render ``[N, 3]`` rays (tensors, or arrays taken as CPU tensors).

        Returns the keys of ``trainer.render_rays`` (``rgb [N, 3]``,
        ``depth [N, 1]``, ``accumulation [N, 1]``, ``ray_mask [N]``,
        ``traversal_overflow [N]``) as tensors on the input's device."""
        o, d = _rays(origins), _rays(directions)
        if o.ndim != 2 or o.shape[-1] != 3 or o.shape != d.shape:
            raise ValueError(f"expected matching [N, 3] origins/directions, got "
                             f"{tuple(o.shape)} and {tuple(d.shape)}")
        trainer = self.trainer
        with trainer.lock:
            out = trainer.renderer().render_tensors(o, d, self.chunk, num_samples,
                                                    num_fine_samples)
        return {k: v.to(o.device) for k, v in out.items()}

    def render_image(self, origins, directions, **kwargs) -> Dict[str, torch.Tensor]:
        """Render an ``[H, W, 3]`` ray grid; returns ``[H, W, C]`` tensors (the
        viewer and eval image path). ``kwargs`` go to :meth:`get_outputs`."""
        o, d = _rays(origins), _rays(directions)
        if o.ndim != 3 or o.shape[-1] != 3 or o.shape != d.shape:
            raise ValueError(f"expected matching [H, W, 3] origins/directions, got "
                             f"{tuple(o.shape)} and {tuple(d.shape)}")
        h, w = o.shape[:2]
        flat = self.get_outputs(o.reshape(-1, 3), d.reshape(-1, 3), **kwargs)
        return {k: v.reshape(h, w, *v.shape[1:]) for k, v in flat.items()}

    # ------------------------------------------------------- state interop
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Parameters as CPU tensors under the reference's names and layouts
        (``tetrahedra_field [F, V]``, Linear weights ``[out, in]``;
        ``model.py:249-255``). With model shards the field is gathered
        whole: every rank of the model group calls this."""
        from .training.checkpoints import reference_state_dict

        model = self.trainer.model
        with self.trainer.lock:
            out = reference_state_dict(model)
            group = model.field_group
            if group is not None:
                field = group.gather_columns([model.tetrahedra_field.detach()])[0]
                out["tetrahedra_field"] = field.cpu().numpy().T
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}

    def load_state_dict(self, state_dict: Mapping[str, object]) -> None:
        """Copy reference-layout tensors (or arrays) into the live trainer's
        model; with model shards each rank keeps its rows of the whole
        ``[F, V]`` field."""
        from .training.checkpoints import load_reference_state_dict

        model = self.trainer.model
        state = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else
                     np.asarray(v)) for k, v in state_dict.items()}
        group = model.field_group
        if group is not None and "tetrahedra_field" in state:
            field = state["tetrahedra_field"]
            state["tetrahedra_field"] = field[group.field_columns(field.shape[0])]
        with self.trainer.lock:
            load_reference_state_dict(model, state)
