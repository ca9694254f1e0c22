"""Coordinate-system base class (counterpart of ``egonerf_tpu/coords/base.py``).

A ``Coordinates`` object holds static geometry (aabb, resolution, radial
grid constants) as host numpy values; ``from_cartesian`` and
``normalize_coord`` are tensor functions that move those constants to the
input's device once and keep them there.  ``up_sampling_VM`` resamples a
plane or a line of the grid onto a new resolution.
"""
from __future__ import annotations

import numpy as np
import torch


def _linear_resample(arr: torch.Tensor, axis: int, positions: torch.Tensor) -> torch.Tensor:
    """1-D linear resample of ``arr`` along ``axis`` at normalized positions
    in [-1, 1], align_corners=True (index = (p + 1) / 2 * (n - 1)), positions
    out of range clamped to the border (JAX ``coords/base.py:19-33``)."""
    n = arr.shape[axis]
    p = ((positions + 1.0) * 0.5 * (n - 1)).clamp(0.0, float(n - 1))
    if n > 1:
        lo = torch.floor(p).to(torch.int64).clamp(0, n - 2)
    else:
        lo = torch.zeros_like(p, dtype=torch.int64)
    t = p - lo.to(p.dtype)
    a = torch.index_select(arr, axis, lo)
    b = torch.index_select(arr, axis, (lo + 1).clamp_max(n - 1))
    shape = [1] * arr.dim()
    shape[axis] = -1
    t = t.reshape(shape)
    return a * (1.0 - t) + b * t


class Coordinates:
    """Base: subclasses define the chart from world xyz to grid coords
    (``update_aabb``, ``from_cartesian``, ``normalize_coord``,
    ``N_to_reso``)."""

    def __init__(self, aabb):
        self.aabb = np.asarray(aabb, dtype=np.float32).reshape(2, 3)
        self.resolution = None
        self._consts: dict = {}
        self.update_aabb(self.aabb)

    name = "base"

    # -- the chart: each subclass defines these ---------------------------
    def from_cartesian(self, xyz: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def normalize_coord(self, coords: torch.Tensor, downsample=None) -> torch.Tensor:
        raise NotImplementedError

    def update_aabb(self, new_aabb) -> None:
        raise NotImplementedError

    def get_normalized_range(self, new_aabb):
        raise NotImplementedError

    def N_to_reso(self, n_voxels: int, aabb=None):
        raise NotImplementedError

    def set_resolution(self, resolution) -> None:
        self.resolution = [int(v) for v in resolution]
        self._consts.clear()

    def _const(self, name: str, device: torch.device) -> torch.Tensor:
        """The numpy attribute ``name`` as a float32 tensor on ``device``,
        cached; cleared whenever the geometry changes."""
        key = (name, device)
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, name), np.float32),
                                device=device)
            self._consts[key] = t
        return t

    def axis_positions(self, dim: int, new_size: int) -> np.ndarray:
        """Normalized [-1, 1] positions in the current grid at which a new
        grid of ``new_size`` nodes along coordinate ``dim`` places them:
        linear (JAX ``coords/base.py:71-77``)."""
        del dim
        return np.linspace(-1.0, 1.0, new_size, dtype=np.float32)

    def up_sampling_VM(self, weights: torch.Tensor, res_target, ids) -> torch.Tensor:
        """Resample a plane (S, H, W, C) with ids [dim_h, dim_w] or a line
        (S, L, C) with ids [dim] onto ``res_target`` (JAX
        ``coords/base.py:79-90``)."""
        if len(ids) not in (1, 2):
            raise ValueError("len(ids) should be 1 or 2")
        out = weights
        for axis, dim in enumerate(ids, start=1):
            pos = torch.as_tensor(self.axis_positions(dim, int(res_target[dim])),
                                  device=weights.device)
            out = _linear_resample(out, axis, pos)
        return out

    def extra_spec(self) -> dict:
        return {}

    def to_spec(self) -> dict:
        """The checkpoint's ``coords_spec``, as the JAX package writes it."""
        spec = {
            "name": self.name,
            "aabb": np.asarray(self.aabb).tolist(),
            "resolution": list(self.resolution) if self.resolution is not None else None,
        }
        spec.update(self.extra_spec())
        return spec

    @staticmethod
    def _center_and_max_r(aabb):
        aabb = np.asarray(aabb, dtype=np.float32).reshape(2, 3)
        center = aabb.sum(0) / 2.0
        max_r = float(np.linalg.norm(aabb[1] - aabb[0]) / 2.0)
        return center, max_r

    def _max_r_from_center(self, aabb) -> float:
        """Max distance of the aabb's 8 corners from the chart center."""
        aabb = np.asarray(aabb, dtype=np.float32).reshape(2, 3)
        idx = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                   indexing="ij"), -1).reshape(-1, 3)
        corners = aabb[idx, np.arange(3)]
        center = np.asarray(self.center, np.float32)
        return float(np.linalg.norm(corners - center, axis=-1).max())
