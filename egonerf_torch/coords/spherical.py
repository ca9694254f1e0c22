"""The spherical chart family (counterpart of
``egonerf_tpu/coords/spherical.py``): every chart of the registry that maps
world xyz onto one (r, a, b) grid.

* ``sphere``: uniform (r, theta, phi) about the aabb's centre;
* ``generic_sphere``: the same with an optional exponential radius and the
  ``interval_th`` near-field clamp (the yin-yang chart builds on it);
* ``directional_sphere``: points with phi < 0 fold onto the half range by
  negating r and theta;
* ``balanced_sphere``: an exponential radius whose ratio follows the
  angular resolution, so cells stay near-cubical;
* ``directional_balanced_sphere``: the two together, the signed radius
  spanning both half-axes (its ``set_resolution`` halves the radius);
* ``euler_sphere``: (r, pitch, yaw);
* ``cylinder``: (rho, phi, z).

The host constants are numpy values, as in JAX; the charts themselves are
tensor functions in JAX's float32 order.  Of them only ``generic_sphere``
under ``interval_th`` is hand-shaped in JAX (the gather-free
``normalize_r_lookup``); the TensoRF models take it through K7s
(``ops.chart.chart_sphere_fwd``) on the card and these plain maps
elsewhere.
"""
from __future__ import annotations

from math import pi, sqrt

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


def _radius(diff: torch.Tensor) -> torch.Tensor:
    """|diff| over the last axis with the sum of squares written out, in
    K7's order ((x x + y y) + z z): a reduction kernel may add in another."""
    parts = diff.unbind(-1)
    sq = parts[0] * parts[0]
    for p in parts[1:]:
        sq = sq + p * p
    return torch.sqrt(sq)


def _fold(phi: torch.Tensor, *signed: torch.Tensor):
    """The directional charts' fold: where phi < 0 (so atan2(-0.0, x < 0)
    = -pi folds, and atan2(+0.0, x < 0) = +pi does not), each of
    ``signed`` negated and phi moved up by pi."""
    neg = phi < 0
    return (torch.where(neg, phi + pi, phi), *(torch.where(neg, -s, s) for s in signed))


class SphericalCoords(Coordinates):
    """Uniform (r, theta, phi) chart centred on the aabb: near [0, 0, -pi],
    far [max_r, pi, pi]."""

    name = "sphere"

    def __init__(self, aabb):
        self.center, _ = self._center_and_max_r(aabb)
        super().__init__(aabb)

    def update_aabb(self, new_aabb):
        self.aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        max_r = self._max_r_from_center(self.aabb)
        self.near = np.array([0.0, 0.0, -pi], dtype=np.float32)
        self.far = np.array([max_r, pi, pi], dtype=np.float32)
        self.inv_diff = 1.0 / (self.far - self.near)
        self._consts.clear()

    def from_cartesian(self, xyz):
        diff = xyz - self._const("center", xyz.device)
        r = _radius(diff)
        theta = _safe_acos(diff[..., 2], r)
        phi = torch.atan2(diff[..., 1], diff[..., 0])
        return torch.stack([r, theta, phi], dim=-1)

    def normalize_coord(self, coords, downsample=None):
        return ((coords - self._const("near", coords.device))
                * self._const("inv_diff", coords.device) * 2.0 - 1.0)

    def get_normalized_range(self, new_aabb):
        max_r = self._max_r_from_center(new_aabb)
        norm_r_max = (max_r - self.near[0]) * self.inv_diff[0]
        return np.zeros(3, np.float32), np.array([norm_r_max, 1.0, 1.0], np.float32)

    def N_to_reso(self, n_voxels, aabb=None):
        n_r = int(n_voxels ** (1.0 / 3.0) / 2.0)
        return [n_r, n_r * 2, n_r * 4]


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

    def N_to_reso(self, n_voxels, aabb=None):
        n_r = int(n_voxels ** (1.0 / 3.0) / 2.0)
        n_theta = n_r * 2
        n_phi = n_theta * 2
        # each forced even
        return [n + n % 2 for n in (n_r, n_theta, n_phi)]

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

    def normalize_coord(self, coords, downsample=None):
        if not self.exp_r:
            return super().normalize_coord(coords)
        near = self._const("near", coords.device)
        inv = self._const("inv_diff", coords.device)
        norm_r = self.normalize_r(coords[..., 0] - near[0], downsample=downsample) * 2.0 - 1.0
        norm_tp = (coords[..., 1:] - near[1:]) * inv[1:] * 2.0 - 1.0
        return torch.cat([norm_r[..., None], norm_tp], dim=-1)


class DirectionalSphericalCoords(SphericalCoords):
    """Folds phi < 0 points onto a half-range chart by negating (r, theta):
    near [0, 0, 0], far [max_r, pi, pi]."""

    name = "directional_sphere"

    def update_aabb(self, new_aabb):
        self.aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        max_r = self._max_r_from_center(self.aabb)
        self.near = np.array([0.0, 0.0, 0.0], dtype=np.float32)
        self.far = np.array([max_r, pi, pi], dtype=np.float32)
        self.inv_diff = 1.0 / (self.far - self.near)
        self._consts.clear()

    def normalize_coord(self, coords, downsample=None):
        phi, r, theta = _fold(coords[..., 2], coords[..., 0], coords[..., 1])
        inv = self._const("inv_diff", coords.device)
        return torch.stack([r * inv[0], theta * inv[1], phi * inv[2] * 2.0 - 1.0], dim=-1)


class BalancedSphericalCoords(SphericalCoords):
    """Exponential radius whose ratio follows the angular resolution, so
    cells stay near-cubical.  ``N_to_reso`` sets ``ratio``, ``r0`` and
    ``coeff`` as a side effect (JAX's, kept: an upsample's
    ``axis_positions`` reads the new constants at the old resolution)."""

    name = "balanced_sphere"

    def __init__(self, aabb):
        self.ratio = None
        self.r0 = None
        self.coeff = None
        super().__init__(aabb)

    def _setup_ratio(self, n_r, n_theta):
        self.ratio = 1.0 + pi / n_theta
        self.r0 = (self.ratio - 1.0) / (self.ratio ** n_r) * float(self.far[0])
        self.coeff = (self.ratio - 1.0) / self.r0

    def N_to_reso(self, n_voxels, aabb=None):
        n_r = int(n_voxels ** (1.0 / 3.0) / 2.0)
        n_theta, n_phi = n_r * 2, n_r * 4
        self._setup_ratio(n_r, n_theta)
        return [n_r, n_theta, n_phi]

    def extra_spec(self) -> dict:
        return {"ratio": self.ratio, "r0": self.r0, "coeff": self.coeff}

    def normalize_r(self, r):
        """(k + t) / n_r of the exponential cell k = trunc(log(r coeff + 1) /
        log(ratio)) and the fraction t within it."""
        k = (torch.log(r * self.coeff + 1.0) / float(np.log(self.ratio))).to(torch.int32)
        kf = k.to(r.dtype)
        r_in = (torch.pow(self.ratio, kf) - 1.0) / self.coeff
        r_out = (torch.pow(self.ratio, kf + 1.0) - 1.0) / self.coeff
        t = (r - r_in) / (r_out - r_in)
        return (kf + t) / self.resolution[0]

    def normalize_coord(self, coords, downsample=None):
        near = self._const("near", coords.device)
        inv = self._const("inv_diff", coords.device)
        norm_r = self.normalize_r(coords[..., 0] - near[0]) * 2.0 - 1.0
        norm_tp = (coords[..., 1:] - near[1:]) * inv[1:] * 2.0 - 1.0
        return torch.cat([norm_r[..., None], norm_tp], dim=-1)

    def _node_radii(self, n: int) -> torch.Tensor:
        """The radii of n exponential nodes, computed in float64 on the host
        and taken as float32, as JAX's ``jnp.asarray`` takes them."""
        grid = (self.ratio ** np.arange(n) - 1.0) / self.coeff
        return torch.as_tensor(grid.astype(np.float32))

    def axis_positions(self, dim, new_size):
        if dim != 0:
            return super().axis_positions(dim, new_size)
        return (self.normalize_r(self._node_radii(new_size)) * 2.0 - 1.0).numpy()


class DirectionalBalancedSphericalCoords(BalancedSphericalCoords):
    """Balanced and directional: the signed radius spans both half-axes,
    so ``set_resolution`` halves the radial size (the model's grid keeps
    ``N_to_reso``'s) and ``axis_positions`` mirrors the radial nodes."""

    name = "directional_balanced_sphere"

    update_aabb = DirectionalSphericalCoords.update_aabb

    def N_to_reso(self, n_voxels, aabb=None):
        n_r = int(n_voxels ** (1.0 / 3.0))
        self.ratio = 1.0 + pi / n_r
        self.r0 = (self.ratio - 1.0) / (self.ratio ** (n_r // 2)) * float(self.far[0])
        self.coeff = (self.ratio - 1.0) / self.r0
        return [n_r, n_r, n_r]

    def set_resolution(self, resolution):
        resolution = list(resolution)
        resolution[0] //= 2  # the signed radius spans both half-axes (reference quirk)
        super().set_resolution(resolution)

    def normalize_coord(self, coords, downsample=None):
        inv = self._const("inv_diff", coords.device)
        near_r = self._const("near", coords.device)[0]
        norm_r = self.normalize_r(coords[..., 0] - near_r)
        phi, norm_r, theta = _fold(coords[..., 2], norm_r, coords[..., 1])
        return torch.stack([norm_r, theta * inv[1], phi * inv[2] * 2.0 - 1.0], dim=-1)

    def axis_positions(self, dim, new_size):
        if dim != 0:
            return Coordinates.axis_positions(self, dim, new_size)
        one_dir = new_size // 2 + (new_size % 2)
        pos = self.normalize_r(self._node_radii(one_dir)).numpy()
        neg = -pos[::-1]
        if new_size % 2:
            neg = neg[:-1]
        return np.concatenate([neg, pos]).astype(np.float32)


class EulerSphericalCoords(Coordinates):
    """(r, pitch, yaw) = (|d|, atan2(z, x), atan2(z, y)) about the aabb's
    centre: near [0, -pi, -pi], far [max_r, pi, pi]."""

    name = "euler_sphere"

    def __init__(self, aabb):
        self.center, _ = self._center_and_max_r(aabb)
        super().__init__(aabb)

    def update_aabb(self, new_aabb):
        self.aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        max_r = self._max_r_from_center(self.aabb)
        self.near = np.array([0.0, -pi, -pi], dtype=np.float32)
        self.far = np.array([max_r, pi, pi], dtype=np.float32)
        self.inv_diff = 1.0 / (self.far - self.near)
        self._consts.clear()

    def from_cartesian(self, xyz):
        diff = xyz - self._const("center", xyz.device)
        r = _radius(diff)
        pitch = torch.atan2(diff[..., 2], diff[..., 0])
        yaw = torch.atan2(diff[..., 2], diff[..., 1])
        return torch.stack([r, pitch, yaw], dim=-1)

    normalize_coord = SphericalCoords.normalize_coord
    get_normalized_range = SphericalCoords.get_normalized_range

    def N_to_reso(self, n_voxels, aabb=None):
        n_r = int(n_voxels ** (1.0 / 3.0) / 2.0)
        n_ang = int(n_r * 2 * sqrt(2))
        return [n_r, n_ang, n_ang]


class CylindricalCoords(Coordinates):
    """(rho, phi, z) about the aabb's vertical axis: near [0, -pi, z_min],
    far [the largest x or y half-extent, pi, z_max]."""

    name = "cylinder"

    def __init__(self, aabb):
        self.center, _ = self._center_and_max_r(aabb)
        super().__init__(aabb)

    def update_aabb(self, new_aabb):
        self.aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        far_rho = float(np.max(self.aabb[1, :2] - self.center[:2]))
        self.near = np.array([0.0, -pi, self.aabb[0, 2]], dtype=np.float32)
        self.far = np.array([far_rho, pi, self.aabb[1, 2]], dtype=np.float32)
        self.inv_diff = 1.0 / (self.far - self.near)
        self._consts.clear()

    def from_cartesian(self, xyz):
        diff = xyz[..., :2] - self._const("center", xyz.device)[:2]
        rho = _radius(diff)
        phi = torch.atan2(diff[..., 1], diff[..., 0])
        return torch.stack([rho, phi, xyz[..., 2]], dim=-1)

    normalize_coord = SphericalCoords.normalize_coord

    def get_normalized_range(self, new_aabb):
        """The normalized range of ``new_aabb``: rho up to its farthest
        vertical edge (of the four corners in x, y), z over its span."""
        new_aabb = np.asarray(new_aabb, dtype=np.float32).reshape(2, 3)
        corners = np.array([[new_aabb[i, 0], new_aabb[j, 1]] for i in range(2) for j in range(2)],
                           dtype=np.float32)
        max_rho = float(np.max(np.linalg.norm(corners - self.center[:2], axis=-1)))
        norm_rho = (max_rho - self.near[0]) * self.inv_diff[0]
        norm_z = (new_aabb[:, 2] - self.near[2]) * self.inv_diff[2]
        return (np.array([0.0, 0.0, norm_z[0]], np.float32),
                np.array([norm_rho, 1.0, norm_z[1]], np.float32))

    def N_to_reso(self, n_voxels, aabb=None):
        return [int(n_voxels ** (1.0 / 3.0))] * 3
