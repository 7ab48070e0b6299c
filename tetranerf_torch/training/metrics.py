"""Image quality metrics: PSNR, SSIM (two protocols), LPIPS (gated).

Counterpart of :mod:`tetranerf_tpu.training.metrics`. The reference
reports PSNR, SSIM in the dm-pix / Mip-NeRF protocol, SSIM in the skimage /
Point-NeRF protocol and LPIPS (``tetranerf/nerfstudio/model.py:41-67,
695-707``):

- :func:`ssim` with ``filter_type='gaussian'`` (11x11 Gaussian window,
  sigma 1.5) is the dm-pix / Mip-NeRF protocol;
- ``filter_type='uniform'`` (7x7 uniform window with sample covariance
  normalization) is the skimage / Point-NeRF protocol.

PSNR and SSIM compute in float64 on the device the image is on. SSIM's
``E[x^2] - E[x]^2`` cancels most of its digits, which a reduced-precision
convolution (TF32, or the bf16 passes the JAX package avoids with
``Precision.HIGHEST``) turns into errors of ~0.05 and values above 1;
float64 never runs at a reduced precision.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _as64(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)


def psnr(image, target, data_range: float = 1.0) -> torch.Tensor:
    image = _as64(image)
    target = _as64(target, image.device)
    mse = torch.mean(torch.square(image - target))
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable filter with valid padding of ``[H, W, C]`` images."""
    k = kernel.numel()
    x = img.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
    x = F.conv2d(x, kernel.view(1, 1, 1, k))
    x = F.conv2d(x, kernel.view(1, 1, k, 1))
    return x[:, 0].permute(1, 2, 0)


def ssim(image, target, data_range: float = 1.0, filter_type: str = "gaussian",
         filter_size: int = 11, sigma: float = 1.5,
         use_sample_covariance: bool = False) -> torch.Tensor:
    """Structural similarity of two ``[H, W, C]`` images.

    ``filter_type='gaussian'`` (11, sigma 1.5) = dm-pix / torchmetrics /
    Mip-NeRF protocol. ``filter_type='uniform'`` with ``filter_size=7`` and
    ``use_sample_covariance=True`` = skimage / Point-NeRF protocol.
    """
    image = _as64(image)
    target = _as64(target, image.device)
    offsets = torch.arange(filter_size, dtype=torch.float64, device=image.device)
    if filter_type == "gaussian":
        kernel = torch.exp(-0.5 * ((offsets - filter_size // 2) / sigma) ** 2)
    elif filter_type == "uniform":
        kernel = torch.ones_like(offsets)
    else:
        raise ValueError(filter_type)
    kernel = kernel / kernel.sum()

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _filter2d(image, kernel)
    mu_y = _filter2d(target, kernel)
    mu_xx = _filter2d(image * image, kernel)
    mu_yy = _filter2d(target * target, kernel)
    mu_xy = _filter2d(image * target, kernel)
    var_x = mu_xx - mu_x**2
    var_y = mu_yy - mu_y**2
    cov = mu_xy - mu_x * mu_y
    if use_sample_covariance:
        npix = filter_size * filter_size
        factor = npix / (npix - 1)
        var_x, var_y, cov = var_x * factor, var_y * factor, cov * factor
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
    return torch.mean(num / den)


def mipnerf_ssim(image, target) -> torch.Tensor:
    """dm-pix-equivalent SSIM (Mip-NeRF comparable; ``model.py:41-54``)."""
    return ssim(image, target, filter_type="gaussian", filter_size=11)


def skimage_ssim(image, target) -> torch.Tensor:
    """skimage-equivalent SSIM (Point-NeRF comparable; ``model.py:61-67``)."""
    return ssim(image, target, filter_type="uniform", filter_size=7,
                use_sample_covariance=True)


class Lpips:
    """LPIPS (alex or vgg) from an offline weight file: ``weights_path`` or
    the ``TETRANERF_LPIPS_WEIGHTS`` environment variable, an npz in the
    layout of :func:`.lpips.load_lpips_params`. Without one, the first call
    raises ``RuntimeError``; PSNR and SSIM stay available. The network runs
    on the device of the images it is given."""

    def __init__(self, net_type: str = "alex", weights_path: Optional[str] = None):
        import os

        self.net_type = net_type
        self.weights_path = weights_path or os.environ.get("TETRANERF_LPIPS_WEIGHTS")
        self._net = None

    def _load(self):
        if not self.weights_path:
            raise RuntimeError(
                "LPIPS needs an offline weight file (weights_path or "
                "TETRANERF_LPIPS_WEIGHTS; see the JAX package's "
                "lpips_jax.export_lpips_weights). PSNR/SSIM metrics remain "
                "available."
            )
        from .lpips import LPIPS, load_lpips_params

        self._net = LPIPS(load_lpips_params(self.weights_path))

    def __call__(self, image, target) -> float:
        if self._net is None:
            self._load()
        device = image.device if isinstance(image, torch.Tensor) else "cpu"
        return float(self._net.to(device)(image, target))


def compute_image_metrics(image, target, lpips: Optional[Lpips] = None) -> dict:
    """The reference's eval metric dict (``model.py:695-707``), as floats."""
    out = {
        "psnr": float(psnr(image, target)),
        "mipnerf_ssim": float(mipnerf_ssim(image, target)),
        "skimage_ssim": float(skimage_ssim(image, target)),
    }
    if lpips is not None:
        try:
            out["lpips"] = lpips(image, target)
        except (RuntimeError, ValueError):
            # Missing weights or an image below the backbone's 32px minimum.
            pass
    return out
