"""Image quality metrics (counterpart of ``egonerf_tpu/render/metrics.py``):
PSNR.  SSIM, WS-SSIM and LPIPS wait (ROADMAP.md §1)."""
from __future__ import annotations

import numpy as np


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log(mse) / np.log(10.0))


def psnr(img0: np.ndarray, img1: np.ndarray) -> float:
    return mse2psnr(float(np.mean((np.asarray(img0) - np.asarray(img1)) ** 2)))
