"""nerfstudio-facing ``Model`` over a trained port trainer.

Counterpart of :mod:`tetranerf_tpu.nerfstudio_model`. ``ns-eval`` and the
nerfstudio viewer drive a ``Model`` only through chunked
``get_outputs(ray_bundle)`` / ``get_outputs_for_camera_ray_bundle`` calls
and score each image through ``get_image_metrics_and_images`` (reference
``tetranerf/nerfstudio/model.py:520-713``). :class:`TetraNerfAdapterModel`
gives that surface over :class:`~.torch_adapter.TorchRenderAdapter`, so
torch pipelines evaluate a trained checkpoint through nerfstudio proper.

Without nerfstudio the class derives from a minimal shim with the same
chunked-render contract, so the chunk loop and the metric hook import and
run everywhere; with nerfstudio the inheritance is the real ``Model``.
"""

from __future__ import annotations

import types
from typing import Dict, Optional

import torch

try:  # pragma: no cover - exercised only where nerfstudio is installed
    from nerfstudio.models.base_model import Model as _BaseModel

    HAVE_NERFSTUDIO = True
except Exception:  # nerfstudio absent (or broken): the shim below
    HAVE_NERFSTUDIO = False

    class _BaseModel:  # type: ignore[no-redef]
        """Minimal stand-in for ``nerfstudio.models.base_model.Model``."""

        def __init__(self, *args, **kwargs):
            pass


class TetraNerfAdapterModel(_BaseModel):
    """Chunked torch render ``Model`` over a trained trainer::

        trainer.restore_checkpoint("outputs/final")
        model = TetraNerfAdapterModel(trainer)
        outputs = model.get_outputs_for_camera_ray_bundle(bundle)

    ``bundle`` has ``origins``/``directions`` tensors ``[..., 3]``
    (nerfstudio's ``RayBundle`` qualifies); the outputs are tensors shaped
    like its leading dims, on its device."""

    def __init__(self, trainer, chunk: int = 8192, num_samples: Optional[int] = None,
                 num_fine_samples: Optional[int] = None):
        # nerfstudio's Model.__init__ builds a torch training model; this is
        # a render-only surface over trained parameters, so it is not called.
        from .torch_adapter import TorchRenderAdapter

        self.adapter = TorchRenderAdapter(trainer, chunk=chunk)
        self.chunk = chunk
        self.num_samples = num_samples
        self.num_fine_samples = num_fine_samples
        self._lpips = None

    # -- nerfstudio Model contract ------------------------------------
    def _render(self, origins, directions) -> Dict[str, torch.Tensor]:
        return self.adapter.get_outputs(origins.reshape(-1, 3), directions.reshape(-1, 3),
                                        num_samples=self.num_samples,
                                        num_fine_samples=self.num_fine_samples)

    def get_outputs(self, ray_bundle) -> Dict[str, torch.Tensor]:
        """One chunk: the bundle's rays rendered, shaped like the bundle."""
        lead = ray_bundle.origins.shape[:-1]
        out = self._render(ray_bundle.origins, ray_bundle.directions)
        return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}

    @staticmethod
    def _slice_bundle(bundle, start: int, end: int):
        """Rows ``[start, end)`` of the flattened bundle: nerfstudio's
        ``get_row_major_sliced_ray_bundle`` where the bundle has it."""
        if hasattr(bundle, "get_row_major_sliced_ray_bundle"):
            return bundle.get_row_major_sliced_ray_bundle(start, end)
        return types.SimpleNamespace(origins=bundle.origins.reshape(-1, 3)[start:end],
                                     directions=bundle.directions.reshape(-1, 3)[start:end])

    def get_outputs_for_camera_ray_bundle(self, camera_ray_bundle) -> Dict[str, torch.Tensor]:
        """The ``ns-eval``/viewer entry: the camera's rays in row-major
        chunks of ``chunk``, rendered and put back into image-shaped
        tensors (nerfstudio's base implementation, which the reference's
        eval path relies on, ``model.py:676-713``)."""
        lead = camera_ray_bundle.origins.shape[:-1]
        num = int(torch.tensor(lead).prod()) if lead else 1
        parts = []
        for start in range(0, num, self.chunk):
            sub = self._slice_bundle(camera_ray_bundle, start, min(start + self.chunk, num))
            parts.append(self._render(sub.origins, sub.directions))
        out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}

    def get_image_metrics_and_images(self, outputs, batch):
        """``ns-eval``'s per-image hook (reference ``model.py:676-713``): PSNR,
        the two SSIM protocols and LPIPS where its weights are available
        (:func:`~.training.metrics.compute_image_metrics`, on the outputs'
        device), and the images side by side."""
        from .training import metrics as m

        rgb = outputs["rgb"]
        image = batch["image"].to(rgb.device)
        if self._lpips is None:
            self._lpips = m.Lpips()
        metrics_dict = m.compute_image_metrics(rgb, image, lpips=self._lpips)
        # ns-eval's name for the gaussian-11 protocol (reference
        # model.py:699-707): mipnerf_ssim is that protocol, so the same value
        # serves both keys.
        metrics_dict["nerfstudio_ssim"] = metrics_dict["mipnerf_ssim"]
        acc, depth = outputs["accumulation"], outputs["depth"]
        try:  # colormapped tensors for the viewer (reference model.py:687-692)
            from nerfstudio.utils import colormaps

            acc = colormaps.apply_colormap(acc)
            depth = colormaps.apply_depth_colormap(depth,
                                                   accumulation=outputs["accumulation"])
        except Exception:  # pragma: no cover - nerfstudio absent or an older API
            pass
        images_dict = {"img": torch.cat([image, rgb], dim=1), "accumulation": acc,
                       "depth": depth}
        return metrics_dict, images_dict

    # The torch optimizer and loss hooks of nerfstudio's Model are not
    # supported: training runs through tetranerf-torch-train.
    def get_param_groups(self):  # pragma: no cover - contract stub
        return {}

    def get_loss_dict(self, *a, **k):  # pragma: no cover - contract stub
        raise RuntimeError(
            "TetraNerfAdapterModel is render-only; train with tetranerf-torch-train "
            "(see tetranerf_torch/nerfstudio_compat.py).")
