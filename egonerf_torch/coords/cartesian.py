"""Cartesian chart, the TensoRF grid (counterpart of
``egonerf_tpu/coords/cartesian.py``): an affine map of the aabb onto
[-1, 1]^3, plain torch (JAX computes it outside any hand op too)."""
from __future__ import annotations

import numpy as np

from .base import Coordinates


class CartesianCoords(Coordinates):
    name = "xyz"

    def from_cartesian(self, xyz):
        return xyz

    def normalize_coord(self, coords, downsample=None):
        lo = self._const("aabb", coords.device)[0]
        inv = self._const("inv_grid_size", coords.device)
        return (coords - lo) * inv * 2.0 - 1.0

    def update_aabb(self, new_aabb):
        self.aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        self.aabb_size = self.aabb[1] - self.aabb[0]
        self.inv_grid_size = 1.0 / self.aabb_size
        self._consts.clear()

    def get_normalized_range(self, new_aabb):
        new_aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        lo = (new_aabb[0] - self.aabb[0]) * self.inv_grid_size
        hi = (new_aabb[1] - self.aabb[0]) * self.inv_grid_size
        return lo, hi

    def N_to_reso(self, n_voxels, aabb=None):
        aabb = self.aabb if aabb is None else np.asarray(aabb, np.float32).reshape(2, 3)
        size = aabb[1] - aabb[0]
        voxel = float(np.prod(size) / n_voxels) ** (1.0 / 3.0)
        return [int(v) for v in (size / voxel)]
