"""The port's image metrics against the JAX package's and a numpy float64
computation: PSNR, both SSIM protocols, LPIPS (alex and vgg) and the
metric dict."""

import numpy as np
import pytest
import torch

from tetranerf_torch.training import metrics as port
from tetranerf_torch.training.lpips import LPIPS, load_lpips_params
from tetranerf_tpu.training import lpips_jax
from tetranerf_tpu.training import metrics as ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's thread pool oversubscribed slows these small ops many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed, h=48, w=40, noise=0.05):
    """A smoothed random image and a noisy copy, in [0, 1], f32."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, size=(h, w, 3))
    k = np.ones((5, 5)) / 25.0
    sm = np.stack([np.real(np.fft.ifft2(np.fft.fft2(img[..., c]) * np.fft.fft2(k, s=(h, w))))
                   for c in range(3)], axis=-1).astype(np.float32)
    noisy = np.clip(sm + rng.normal(scale=noise, size=sm.shape), 0, 1).astype(np.float32)
    return sm, noisy


def _filt64(x, kernel):
    """Valid-mode separable filter in float64, one row/column at a time."""
    k = kernel.size
    out = np.empty((x.shape[0] - k + 1, x.shape[1] - k + 1, x.shape[2]))
    for c in range(x.shape[2]):
        t = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="valid"), 1, x[:, :, c])
        out[:, :, c] = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="valid"), 0, t)
    return out


def _ssim64(a, b, gaussian):
    size = 11 if gaussian else 7
    kernel = (np.exp(-0.5 * ((np.arange(11) - 5) / 1.5) ** 2) if gaussian
              else np.ones(7))
    kernel = kernel / kernel.sum()
    a, b = a.astype(np.float64), b.astype(np.float64)
    ma, mb = _filt64(a, kernel), _filt64(b, kernel)
    va = _filt64(a * a, kernel) - ma * ma
    vb = _filt64(b * b, kernel) - mb * mb
    cov = _filt64(a * b, kernel) - ma * mb
    if not gaussian:
        f = size * size / (size * size - 1)
        va, vb, cov = va * f, vb * f, cov * f
    c1, c2 = 1e-4, 9e-4
    return np.mean(((2 * ma * mb + c1) * (2 * cov + c2))
                   / ((ma**2 + mb**2 + c1) * (va + vb + c2)))


@pytest.mark.parametrize("seed,noise", [(0, 0.05), (1, 0.3), (2, 0.01)])
def test_psnr_and_ssim_match_jax_and_float64(seed, noise):
    a, b = _pair(seed, noise=noise)
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    cases = [
        (port.psnr, ref.psnr, 10.0 * np.log10(1.0 / mse)),
        (port.mipnerf_ssim, ref.mipnerf_ssim, _ssim64(a, b, True)),
        (port.skimage_ssim, ref.skimage_ssim, _ssim64(a, b, False)),
    ]
    for ours_fn, ref_fn, want in cases:
        ours = ours_fn(a, b)
        assert ours.dtype == torch.float64
        assert abs(float(ours) - float(ref_fn(a, b))) <= 1e-5, ours_fn.__name__
        assert abs(float(ours) - want) <= 1e-9, ours_fn.__name__
    # Tensors in, on their own device; the same values.
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(port.mipnerf_ssim(ta, tb)) == float(port.mipnerf_ssim(a, b))


def test_ssim_unknown_filter_raises():
    a, b = _pair(0)
    with pytest.raises(ValueError):
        port.ssim(a, b, filter_type="box")


@pytest.fixture(scope="module", params=["alex", "vgg"])
def lpips_weights(request, tmp_path_factory):
    import jax

    params = lpips_jax.init_lpips_params(jax.random.PRNGKey(3), request.param)
    path = tmp_path_factory.mktemp("lpips") / f"{request.param}.npz"
    np.savez(path, **params)
    return path


def test_lpips_matches_jax(lpips_weights):
    params = load_lpips_params(lpips_weights)
    net = LPIPS(params)
    for seed in (0, 1):
        a, b = _pair(seed, 64, 48, noise=0.1)
        ours = float(net(a, b))
        want = float(lpips_jax.lpips(lpips_jax.load_lpips_params(lpips_weights), a, b))
        assert ours == pytest.approx(want, abs=1e-4, rel=0)
        assert ours > 0
    assert float(net(a, a)) == 0.0
    with pytest.raises(ValueError, match="32x32"):
        net(a[:16], b[:16])


def test_image_metrics_keys_match_jax(lpips_weights):
    a, b = _pair(4, 48, 48)
    for with_lpips in (False, True):
        ours = port.compute_image_metrics(
            a, b, lpips=port.Lpips(weights_path=str(lpips_weights)) if with_lpips else None)
        want = ref.compute_image_metrics(
            a, b, lpips=ref.Lpips(weights_path=str(lpips_weights)) if with_lpips else None)
        assert list(ours) == list(want)
        assert all(isinstance(v, float) for v in ours.values())
        for k in want:
            assert ours[k] == pytest.approx(want[k], abs=1e-4 if k == "lpips" else 1e-5)


def test_lpips_without_weights_raises(monkeypatch):
    monkeypatch.delenv("TETRANERF_LPIPS_WEIGHTS", raising=False)
    metric = port.Lpips()
    with pytest.raises(RuntimeError, match="TETRANERF_LPIPS_WEIGHTS"):
        metric._load()
    a, b = _pair(5, 40, 40)
    # compute_image_metrics drops LPIPS when it cannot run, as JAX's does.
    assert "lpips" not in port.compute_image_metrics(a, b, lpips=metric)
