"""Ray generation and the LLFF pose helpers (a copy of
``egonerf_tpu/data/ray_utils.py``, which the port may not import): the
equirectangular, pinhole and Blender directions, ``get_rays`` with its roi
crop, the NDC projections, the slab test, the legacy ray marcher, the LLFF
pose averaging and spiral, and the PFM reader.  Plain numpy; the loaders
call them once per dataset on the host.  ``ndc_rays`` has no caller, in
JAX as here: no loader converts its rays, and ``ndc_ray`` selects the
TensoRF family's NDC sampling of the rays as they are, in training only.
"""
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


def get_ray_directions(h: int, w: int, focal, center=None) -> np.ndarray:
    """Pinhole directions, +z forward (reference: dataLoader/ray_utils.py:43-61)."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    i, j = i + 0.5, j + 0.5
    cx, cy = center if center is not None else (w / 2.0, h / 2.0)
    dirs = np.stack([(i - cx) / focal[0], (j - cy) / focal[1], np.ones_like(i)], -1)
    return dirs.astype(np.float32)


def get_ray_directions_blender(h: int, w: int, focal, center=None) -> np.ndarray:
    """Pinhole directions, blender convention (-y up, -z forward)
    (reference: dataLoader/ray_utils.py:64-82)."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    i, j = i + 0.5, j + 0.5
    cx, cy = center if center is not None else (w / 2.0, h / 2.0)
    dirs = np.stack([(i - cx) / focal[0], -(j - cy) / focal[1], -np.ones_like(i)], -1)
    return dirs.astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray, roi=None):
    """Rotate camera-frame directions into the world and broadcast the
    origin; optional ROI crop in fractional image coords
    (reference: dataLoader/ray_utils.py:85-113)."""
    if roi is not None:
        h0, h1, w0, w1 = roi
        h, w, _ = directions.shape
        directions = directions[int(h0 * h) : int(h1 * h), int(w0 * w) : int(w1 * w)]
    rays_d = directions @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).astype(np.float32), rays_d.reshape(-1, 3).astype(np.float32)


def ndc_rays_blender(h, w, focal, near, rays_o, rays_d):
    """(reference: dataLoader/ray_utils.py:116-133)"""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def ndc_rays(h, w, focal, near, rays_o, rays_d):
    """OpenGL-convention NDC projection (reference: dataLoader/ray_utils.py:135-152)."""
    t = (near - rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = 1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = 1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 - 2.0 * near / rays_o[..., 2]
    d0 = 1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = 1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = 2.0 * near / rays_o[..., 2]
    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def ndc_bbox(all_rays: np.ndarray) -> np.ndarray:
    """Bounding box of NDC ray endpoints (reference: dataLoader/ray_utils.py:285-291)."""
    near = all_rays[..., :3].reshape(-1, 3)
    far = (all_rays[..., :3] + all_rays[..., 3:6]).reshape(-1, 3)
    lo = np.minimum(near.min(0), far.min(0))
    hi = np.maximum(near.max(0), far.max(0))
    return np.stack([lo, hi])


def aabb_intersect(rays_o: np.ndarray, rays_d: np.ndarray, aabb: np.ndarray):
    """Slab-test entry/exit distances (reference: dataLoader/ray_utils.py:190-197)."""
    inv_d = 1.0 / (rays_d + 1e-6)
    t0 = (aabb[0] - rays_o) * inv_d
    t1 = (aabb[1] - rays_o) * inv_d
    t_min = np.max(np.minimum(t0, t1), axis=-1, keepdims=True)
    t_max = np.min(np.maximum(t0, t1), axis=-1, keepdims=True)
    return t_min, t_max


def depth2dist(z_vals: np.ndarray, cos_angle: np.ndarray) -> np.ndarray:
    """(reference: dataLoader/ray_utils.py:9-15)"""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = np.concatenate([dists, np.full_like(dists[..., :1], 1e10)], -1)
    return dists * cos_angle[..., None]


def ray_marcher(rays: np.ndarray, n_samples=64, lindisp=False, perturb=0.0,
                bbox_3d=None, rng=None):
    """Legacy uniform/disparity ray marcher kept for API parity
    (reference: dataLoader/ray_utils.py:200-244)."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    if bbox_3d is not None:
        near, far = aabb_intersect(rays_o, rays_d, bbox_3d)
    steps = np.linspace(0, 1, n_samples, dtype=np.float32)
    if not lindisp:
        z_vals = near * (1 - steps) + far * steps
    else:
        z_vals = 1.0 / (1.0 / near * (1 - steps) + 1.0 / far * steps)
    z_vals = np.broadcast_to(z_vals, (rays.shape[0], n_samples)).copy()
    if perturb > 0:
        rng = rng or np.random.default_rng()
        mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = np.concatenate([mid, z_vals[:, -1:]], -1)
        lower = np.concatenate([z_vals[:, :1], mid], -1)
        z_vals = lower + (upper - lower) * perturb * rng.uniform(size=z_vals.shape)
    pts = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    return pts, rays_o, rays_d, z_vals


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average c2w pose for LLFF centering (reference: dataLoader/dataset_llff.py:18-52)."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(z, y_))
    y = np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, blender2opencv: np.ndarray):
    """(reference: dataLoader/dataset_llff.py:55-79)"""
    poses = poses @ blender2opencv
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    return poses_centered[:, :3], pose_avg_homo


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([-vec0, vec1, vec2, pos], 1)
    return m


def render_path_spiral(c2w, up, rads, focal, zrate=0.5, n_rots=2, n=120):
    """(reference: dataLoader/dataset_llff.py:92-100)"""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(viewmatrix(z, up, c))
    return render_poses


def get_spiral(c2ws_all, near_fars, rads_scale=1.0, n_views=120):
    """(reference: dataLoader/dataset_llff.py:103-120)"""
    c2w = average_poses(c2ws_all)
    up = normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close_depth, inf_depth = near_fars.min() * 0.9, near_fars.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = c2ws_all[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0) * rads_scale
    return np.stack(render_path_spiral(c2w, up, rads, focal, zrate=0.5, n=n_views))


def read_pfm(filename):
    """Portable float map reader (reference: dataLoader/ray_utils.py:247-282)."""
    import re

    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale
