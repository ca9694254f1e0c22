"""Yin-yang balanced spherical chart (counterpart of
``egonerf_tpu/coords/yinyang.py``).

Two lat-long grids rotated 90 degrees from each other cover the sphere
without poles: *yin* covers theta in [pi/4, 3pi/4], phi in [-3pi/4, 3pi/4]
in the normal frame, and every other point falls to *yang*, whose frame
swaps the polar axis (theta_e = acos(y/r), phi_e = atan2(z, -x)).
``from_cartesian`` emits the compact ``[r, theta_sel, phi_sel, flag]``: the
angles in the point's own grid plus a {0, 1} chart flag that the lookups
fold into their row index.
"""
from __future__ import annotations

from math import pi, sqrt

import numpy as np
import torch

from .spherical import GenericSphericalCoords, _safe_acos


class YinYangSphericalCoords(GenericSphericalCoords):
    name = "yinyang"

    def __init__(self, aabb, exp_r=True, N_voxel=None, r0=None, interval_th=False):
        super().__init__(aabb, exp_r=exp_r, N_voxel=N_voxel, r0=r0, interval_th=interval_th)

    def update_aabb(self, new_aabb):
        self.aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        max_r = self._max_r_from_center(self.aabb)
        # both grids share these ranges
        self.near = np.array([0.0, pi / 4.0, -3.0 * pi / 4.0], dtype=np.float32)
        self.far = np.array([max_r, 3.0 * pi / 4.0, 3.0 * pi / 4.0], dtype=np.float32)
        self.inv_diff = 1.0 / (self.far - self.near)
        self._consts.clear()

    def from_cartesian(self, xyz):
        diff = xyz - self._const("center", xyz.device)
        r = torch.sqrt(torch.sum(diff * diff, dim=-1))
        theta_n = _safe_acos(diff[..., 2], r)
        phi_n = torch.atan2(diff[..., 1], diff[..., 0])

        # inclusive bounds on both ends
        is_yin = ((pi / 4.0 <= theta_n) & (theta_n <= 3.0 * pi / 4.0)
                  & (-3.0 * pi / 4.0 <= phi_n) & (phi_n <= 3.0 * pi / 4.0))

        theta_e = _safe_acos(diff[..., 1], r)
        phi_e = torch.atan2(diff[..., 2], -diff[..., 0])

        theta = torch.where(is_yin, theta_n, theta_e)
        phi = torch.where(is_yin, phi_n, phi_e)
        flag = (~is_yin).to(r.dtype)
        return torch.stack([r, theta, phi, flag], dim=-1)

    def normalize_coord(self, coords, downsample=None):
        near = self._const("near", coords.device)
        inv = self._const("inv_diff", coords.device)
        if self.exp_r:
            norm_r = self.normalize_r(coords[..., 0] - near[0], downsample=downsample) * 2.0 - 1.0
        else:
            norm_r = (coords[..., 0] - near[0]) * inv[0] * 2.0 - 1.0
        norm_tp = (coords[..., 1:3] - near[1:3]) * inv[1:3] * 2.0 - 1.0
        return torch.cat([norm_r[..., None], norm_tp, coords[..., 3:4]], dim=-1)

    def N_to_reso(self, n_voxels, aabb=None):
        # N_r : N_theta : N_phi = 1 : 2*sqrt(3)/3 : 2*sqrt(3); each grid
        # holds half the voxel budget
        n_r = int(n_voxels ** (1.0 / 3.0) / 2.0)
        n_theta = int(n_r * 2.0 * sqrt(3.0) / 3.0)
        n_phi = n_theta * 3
        n_r += n_r % 2
        n_theta += n_theta % 2
        n_phi += n_phi % 2
        return [n_r, n_theta, n_phi]
