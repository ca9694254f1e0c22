"""The parts of the spherical charts that the yin-yang chart builds on
(counterpart of ``egonerf_tpu/coords/spherical.py``: ``SphericalCoords``
and ``GenericSphericalCoords``).  The other spherical charts wait
(ROADMAP.md §1)."""
from __future__ import annotations

import numpy as np
import torch

from .base import Coordinates
from .expgrid import (apply_interval_th, exp_ratio, index2r, make_reference_r_grid,
                      normalize_r_exp, normalize_r_lookup)


def _safe_acos(num: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """acos(num/r) with r=0 -> acos(0) semantics of the reference's
    nan_to_num_."""
    ratio = torch.where(r > 0, num / r.clamp_min(1e-12), torch.zeros_like(r))
    return torch.acos(ratio.clamp(-1.0, 1.0))


class SphericalCoords(Coordinates):
    """(r, theta, phi) charts centred on the aabb; the yin-yang chart keeps
    only this centre from the uniform chart."""

    def __init__(self, aabb):
        self.center, _ = self._center_and_max_r(aabb)
        super().__init__(aabb)


class GenericSphericalCoords(SphericalCoords):
    """(r, theta, phi) with optional exponential radius and the interval_th
    near-field clamp."""

    name = "generic_sphere"

    def __init__(self, aabb, exp_r=False, N_voxel=None, r0=None, interval_th=False):
        self.exp_r = bool(exp_r)
        self.interval_th = bool(interval_th)
        self.r0 = r0
        self.ratio = None
        self.ref_grid = None
        super().__init__(aabb)
        if N_voxel is not None:
            self.set_resolution(self.N_to_reso(N_voxel), r0=r0)

    @property
    def far_r(self) -> float:
        return float(self.far[0])

    def set_resolution(self, resolution, r0=None):
        super().set_resolution(resolution)
        if self.exp_r:
            self.r0 = float(r0) if r0 is not None else (self.r0 if self.r0 else 0.05)
            self.ratio = exp_ratio(self.r0, self.far_r, self.resolution[0])
            if self.interval_th:
                self.ref_grid = make_reference_r_grid(self.r0, self.far_r, self.resolution[0])

    def axis_positions(self, dim: int, new_size: int):
        """Normalized [-1, 1] positions in the current grid of a new grid's
        nodes (JAX ``coords/spherical.py:128-135``): on the exponential
        radius the new grid's node radii (``index2r`` at the new size's
        ratio, the ``interval_th`` prefix spliced in) through the current
        ``normalize_r``; linear on every other axis.  Called before
        :meth:`set_resolution` takes the new size."""
        if dim != 0 or not self.exp_r:
            return super().axis_positions(dim, new_size)
        grid = index2r(self.r0, exp_ratio(self.r0, self.far_r, new_size), np.arange(new_size))
        if self.interval_th:
            grid = apply_interval_th(grid, self.r0)
        return (self.normalize_r(torch.as_tensor(grid)) * 2.0 - 1.0).numpy()

    def extra_spec(self) -> dict:
        return {"exp_r": self.exp_r, "interval_th": self.interval_th, "r0": self.r0}

    def normalize_r(self, r, downsample=None):
        if self.interval_th:
            # downsample has no effect here: the lookup grid is in
            # resolution-independent [0, 1] (a reference quirk kept)
            return normalize_r_lookup(r, self._const("ref_grid", r.device))
        n_r = self.resolution[0]
        ratio = self.ratio
        if downsample is not None:
            n_r = n_r // downsample
            ratio = exp_ratio(self.r0, self.far_r, n_r)
        return normalize_r_exp(r, self.r0, ratio, n_r)
