"""Ray generation (counterpart of ``egonerf_tpu/data/ray_utils.py``)."""
from __future__ import annotations

import numpy as np


def get_ray_directions_360(h: int, w: int) -> np.ndarray:
    """Equirectangular panorama ray directions, (h, w, 3), axes
    [x, y, z] = [right, up, backward]."""
    i = np.tile(np.arange(w, dtype=np.float32), (h, 1)) + 0.5
    j = np.tile(np.arange(h, dtype=np.float32), (w, 1)).T + 0.5
    phi = (1.0 - 2.0 * i / w) * np.pi        # longitude (pi, -pi)
    theta = (1.0 - 2.0 * j / h) * np.pi / 2  # latitude  (pi/2, -pi/2)
    dirs = np.stack(
        [-np.cos(theta) * np.sin(phi), np.sin(theta), -np.cos(theta) * np.cos(phi)],
        axis=-1,
    )
    return dirs.astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """Rotate camera-frame directions into the world and broadcast the
    origin.  Returns (rays_o, rays_d), each (N, 3) float32."""
    rays_d = directions @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).astype(np.float32), rays_d.reshape(-1, 3).astype(np.float32)
