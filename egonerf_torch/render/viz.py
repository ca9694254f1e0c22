"""Visualisation helpers (counterpart of ``egonerf_tpu/render/viz.py``): the
jet colour map of a depth image, evaluated in numpy without OpenCV, and
the uint8 conversion of the written images."""
from __future__ import annotations

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] -> (..., 3) uint8 of the classic jet colour map."""
    x = np.clip(x, 0.0, 1.0)
    four = 4.0 * x
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def visualize_depth(depth: np.ndarray, minmax=None):
    """(h, w) depth -> ((h, w, 3) uint8 jet image, [mi, ma] the range
    used): ``minmax``, else the smallest positive depth and the largest."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    if minmax is None:
        positive = x[x > 0]
        mi = float(positive.min()) if positive.size else 0.0
        ma = float(x.max())
    else:
        mi, ma = float(minmax[0]), float(minmax[1])
    x = (x - mi) / (ma - mi + 1e-8)
    return _jet(x), [mi, ma]


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
