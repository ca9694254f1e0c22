"""Coordinate-system base class (counterpart of ``egonerf_tpu/coords/base.py``).

A ``Coordinates`` object holds static geometry (aabb, resolution, radial
grid constants) as host numpy values; ``from_cartesian`` and
``normalize_coord`` are tensor functions that move those constants to the
input's device once and keep them there.
"""
from __future__ import annotations

import numpy as np
import torch


class Coordinates:
    """Base: subclasses define the chart from world xyz to grid coords
    (``update_aabb``, ``from_cartesian``, ``normalize_coord``,
    ``N_to_reso``).  Grid upsampling waits for a later slice (ROADMAP.md)."""

    def __init__(self, aabb):
        self.aabb = np.asarray(aabb, dtype=np.float32).reshape(2, 3)
        self.resolution = None
        self._consts: dict = {}
        self.update_aabb(self.aabb)

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
