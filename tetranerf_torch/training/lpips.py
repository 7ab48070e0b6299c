"""LPIPS (Zhang et al., CVPR 2018) as a torch module over offline weights.

Counterpart of :mod:`tetranerf_tpu.training.lpips_jax`, reading the same
npz layout (:func:`load_lpips_params`)::

    conv{i}_kernel  f32[kh, kw, cin, cout]   (HWIO)
    conv{i}_bias    f32[cout]
    lin{i}          f32[c_i]                 per-channel calibration
    net_type        'alex' | 'vgg'

Images in [0, 1] are scaled to [-1, 1], shifted and scaled per channel,
and passed through the frozen backbone; each tap's activations are
unit-normalized over channels, their squared difference is weighted by the
calibration vector and averaged over space, and the taps are summed.

The convolutions run in float32 inside
``torch.backends.cudnn.flags(enabled=True, allow_tf32=False)``: a caller's
global TF32 setting does not reach them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Per-channel input normalization (PerceptualSimilarity's scaling_layer).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (kernel, stride, padding, maxpool_before) per conv layer; taps after
# every ReLU for alex, after each block's last ReLU for vgg.
_ALEX_LAYERS = [(11, 4, 2, False), (5, 1, 2, True), (3, 1, 1, True),
                (3, 1, 1, False), (3, 1, 1, False)]
_ALEX_TAPS = [0, 1, 2, 3, 4]
_VGG_POOL_BEFORE = [False, False, True, False, True, False, False,
                    True, False, False, True, False, False]
_VGG_LAYERS = [(3, 1, 1, p) for p in _VGG_POOL_BEFORE]
_VGG_TAPS = [1, 3, 6, 9, 12]


def _arch(net_type: str):
    if net_type == "alex":
        return _ALEX_LAYERS, _ALEX_TAPS
    if net_type == "vgg":
        return _VGG_LAYERS, _VGG_TAPS
    raise ValueError(f"unknown net_type {net_type!r}")


def load_lpips_params(path) -> Dict[str, np.ndarray]:
    data = np.load(path, allow_pickle=False)
    params = {k: data[k] for k in data.files}
    if "net_type" not in params:
        raise ValueError(f"{path} is not an LPIPS weight file (no net_type)")
    return params


class LPIPS(nn.Module):
    """``LPIPS(params)(image, target)``: the distance of two ``[H, W, 3]``
    images in [0, 1] (numpy arrays or tensors), at least 32x32."""

    def __init__(self, params: Dict[str, np.ndarray]):
        super().__init__()
        self.net_type = str(np.asarray(params["net_type"]))
        layers, self.taps = _arch(self.net_type)
        self.layers = [(stride, pad, pool) for _, stride, pad, pool in layers]
        for i in range(len(layers)):
            w = torch.from_numpy(np.array(params[f"conv{i}_kernel"], np.float32))
            self.register_buffer(f"w{i}", w.permute(3, 2, 0, 1).contiguous())  # OIHW
            self.register_buffer(
                f"b{i}", torch.from_numpy(np.array(params[f"conv{i}_bias"], np.float32)))
        for j in range(len(self.taps)):
            self.register_buffer(
                f"lin{j}", torch.from_numpy(np.array(params[f"lin{j}"], np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def _features(self, x):
        feats = []
        for i, (stride, pad, pool) in enumerate(self.layers):
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(F.conv2d(x, getattr(self, f"w{i}"), getattr(self, f"b{i}"),
                                stride=stride, padding=pad))
            if i in self.taps:
                feats.append(x)
        return feats

    def _prep(self, img):
        img = torch.as_tensor(img, dtype=torch.float32, device=self.shift.device)
        img = img.permute(2, 0, 1)[None] * 2.0 - 1.0
        return (img - self.shift) / self.scale

    @torch.no_grad()
    def forward(self, image, target) -> torch.Tensor:
        if min(image.shape[0], image.shape[1]) < 32:
            raise ValueError(f"LPIPS needs images >= 32x32, got {tuple(image.shape[:2])}")
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            fa = self._features(self._prep(image))
            fb = self._features(self._prep(target))
        total = torch.zeros((), device=self.shift.device)
        for j, (a, b) in enumerate(zip(fa, fb)):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            d = torch.square(a - b) * getattr(self, f"lin{j}").view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d, dim=1))
        return total
