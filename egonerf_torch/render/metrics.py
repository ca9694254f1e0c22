"""Image quality metrics (counterpart of ``egonerf_tpu/render/metrics.py``):
PSNR, the Gaussian-window SSIM, and the weighted-sphere WS-SSIM and
WS-PSNR of equirectangular panoramas, in numpy and scipy on the host.

``ssim_and_ws_ssim`` takes both SSIM means from one SSIM map, where the
JAX evaluation builds the map twice (once in ``rgb_ssim``, once in
``ws_ssim``); the numbers are the same.  LPIPS is in :mod:`.lpips`.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage
import scipy.signal


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log(mse) / np.log(10.0))


def psnr(img0: np.ndarray, img1: np.ndarray) -> float:
    return mse2psnr(float(np.mean((np.asarray(img0) - np.asarray(img1)) ** 2)))


def _ssim_map(img0: np.ndarray, img1: np.ndarray, max_val: float = 1.0,
              filter_size: int = 11, filter_sigma: float = 1.5,
              k1: float = 0.01, k2: float = 0.03) -> np.ndarray:
    """Per-pixel SSIM of two (h, w, 3) images in float64, with a separable
    Gaussian window over the 'valid' support: odd windows through
    ``scipy.ndimage.convolve1d`` cropped to 'valid', even windows through
    ``scipy.signal.convolve2d`` with the mipnerf half-shift."""
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    assert img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    t = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    win = np.exp(-0.5 * t)
    win /= win.sum()

    if filter_size % 2:
        def blur(z):
            z = scipy.ndimage.convolve1d(z, win, axis=0, mode="constant")
            z = scipy.ndimage.convolve1d(z, win, axis=1, mode="constant")
            return z[hw:-hw or None, hw:-hw or None]
    else:
        def blur(z):
            return np.stack(
                [scipy.signal.convolve2d(
                    scipy.signal.convolve2d(z[..., c], win[:, None], mode="valid"),
                    win[None, :], mode="valid")
                 for c in range(z.shape[-1])], -1)

    mu0, mu1 = blur(img0), blur(img1)
    s00 = np.maximum(blur(img0 ** 2) - mu0 ** 2, 0.0)
    s11 = np.maximum(blur(img1 ** 2) - mu1 ** 2, 0.0)
    s01 = blur(img0 * img1) - mu0 * mu1
    s01 = np.sign(s01) * np.minimum(np.sqrt(s00 * s11), np.abs(s01))
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    return ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / (
        (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))


def _sphere_weights(h: int) -> np.ndarray:
    """(h, 1, 1) cos(latitude) of each row's centre, top to bottom."""
    lat = ((np.arange(h) + 0.5) / h - 0.5) * np.pi
    return np.cos(lat)[:, None, None]


def _ws_mean(smap: np.ndarray) -> float:
    w = _sphere_weights(smap.shape[0])
    return float(np.sum(smap * w) / (np.sum(w) * smap.shape[1] * smap.shape[2]))


def rgb_ssim(img0, img1, max_val: float = 1.0, **kw) -> float:
    return float(np.mean(_ssim_map(img0, img1, max_val, **kw)))


def ws_ssim(img0, img1, max_val: float = 1.0, **kw) -> float:
    """Weighted-sphere SSIM: the SSIM map averaged with cos(latitude)
    weights, so the over-represented poles of an equirectangular image do
    not dominate."""
    return _ws_mean(_ssim_map(img0, img1, max_val, **kw))


def ssim_and_ws_ssim(img0, img1, max_val: float = 1.0, **kw) -> tuple:
    """(``rgb_ssim``, ``ws_ssim``) from one SSIM map."""
    smap = _ssim_map(img0, img1, max_val, **kw)
    return float(np.mean(smap)), _ws_mean(smap)


def ws_psnr(img0: np.ndarray, img1: np.ndarray) -> float:
    """Weighted-sphere PSNR: the squared error averaged with cos(latitude)
    weights."""
    img0, img1 = np.asarray(img0, np.float64), np.asarray(img1, np.float64)
    w = _sphere_weights(img0.shape[0])
    mse = float(np.sum(w * (img0 - img1) ** 2) / (np.sum(w) * img0.shape[1] * img0.shape[2]))
    return mse2psnr(mse)
