"""Exponential radial grid math (counterpart of ``egonerf_tpu/coords/expgrid.py``).

The radial cells are spaced exponentially so each subtends a roughly
constant solid angle from the egocentric origin; ``interval_th`` clamps the
near-field spacing to a constant ``r0``.  The grids are host numpy
constants; the per-sample normalization runs on tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def index2r(r0: float, ratio: float, index) -> np.ndarray:
    """Radial position of grid index k: 0 -> 0, k>=1 -> r0 * ratio**(k-1)."""
    idx = np.asarray(index, dtype=np.float32)
    r = np.where(idx > 0, r0 * ratio ** (idx - 1.0), 0.0)
    return r.astype(np.float32)


def exp_ratio(r0: float, far: float, n: int) -> float:
    """ratio such that r0 * ratio**(n-1) == far."""
    return float(np.exp(np.log(far / r0) / (n - 1)))


def apply_interval_th(grid: np.ndarray, r0: float) -> np.ndarray:
    """Splice a constant-spacing prefix into an exponential grid: with ``m``
    leading intervals <= r0, g[k] = k*r0 for k <= m and the tail shifts to
    stay continuous."""
    # float32 throughout: the clamp count m hangs on an exact interval <= r0
    # comparison at the first cell, which holds only in float32
    grid = np.asarray(grid, dtype=np.float32).copy()
    r0 = np.float32(r0)
    interval = grid[1:] - grid[:-1]
    m = int(np.sum(interval <= r0))
    out = grid.copy()
    out[: m + 1] = np.arange(m + 1, dtype=np.float32) * r0
    if m < len(grid) - 1:
        out[m + 1 :] = grid[m + 1 :] + (m * r0 - grid[m])
    return out


def make_reference_r_grid(r0: float, far: float, n_r: int) -> np.ndarray:
    """The (n_r+1)-point radial lookup grid of interval_th normalization;
    ratio comes from n_r (not n_r+1), so the last point may pass ``far``."""
    ratio = exp_ratio(r0, far, n_r)
    grid = index2r(r0, ratio, np.arange(n_r + 1))
    return apply_interval_th(grid, r0)


def make_sample_r_grid(r0: float, span: float, n_samples: int) -> np.ndarray:
    """The n_samples-point radial ray-sampling grid of interval_th mode."""
    ratio = exp_ratio(r0, span, n_samples)
    grid = index2r(r0, ratio, np.arange(n_samples))
    return apply_interval_th(grid, r0)


def normalize_r_lookup(r: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Radius -> normalized [0, 1] coordinate on the strictly increasing
    (n_r+1)-entry ``grid``: (cell index + lerp fraction) / n_r."""
    n_r = grid.shape[0] - 1
    hi = torch.searchsorted(grid, r.contiguous(), right=True).clamp(1, n_r)
    lo = hi - 1
    g_lo = grid[lo]
    g_hi = grid[hi]
    t = (r - g_lo) / (g_hi - g_lo)
    return (lo.to(r.dtype) + t) / n_r


def normalize_r_exp(r: torch.Tensor, r0: float, ratio: float, n_r: int) -> torch.Tensor:
    """Closed-form exponential normalization (the path without interval_th):
    k = trunc(log(r/r0)/log(ratio)); cells below r0 lerp over [0, r0]."""
    safe_r = r.clamp_min(1e-12)
    k = (torch.log(safe_r / r0) / float(np.log(ratio))).to(torch.int32)
    kf = k.to(r.dtype)
    below = r < r0
    r_in = torch.where(below, torch.zeros_like(r), r0 * torch.pow(ratio, kf))
    r_out = torch.where(below, torch.full_like(r, r0), r0 * torch.pow(ratio, kf + 1.0))
    t = (r - r_in) / (r_out - r_in)
    norm = torch.where(below, r / r0, 1.0 + kf + t)
    return norm / n_r
