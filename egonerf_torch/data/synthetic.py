"""Procedural egocentric test scene (a copy of
``egonerf_tpu/data/synthetic.py``, which the port may not import).

An analytic multi-view-consistent world (textured wall sphere + a few solid
spheres for parallax) rendered to equirectangular images by closed-form ray
casting.  Gives the framework a self-contained dataset for unit tests,
end-to-end smoke training, and benchmarking — no external downloads.
"""
from __future__ import annotations

import numpy as np

from .ray_utils import get_ray_directions_360, get_rays

_SPHERES = np.array([
    # x, y, z, radius
    [1.5, 0.3, -1.0, 0.55],
    [-1.2, -0.4, 1.3, 0.45],
    [0.2, 1.4, 0.8, 0.35],
], dtype=np.float32)
_SPHERE_COLORS = np.array([
    [0.9, 0.25, 0.2],
    [0.2, 0.55, 0.9],
    [0.95, 0.8, 0.25],
], dtype=np.float32)


def _scene_spheres(background: str):
    """Solid spheres for a scene variant.  ``cluttered`` adds 24 deterministic
    spheres spread over radii ~1.2-5.5 in all directions — occupied space is
    distributed through the volume instead of concentrated at the wall, the
    adversarial regime for empty-space culling (a top-K keep must then split
    its budget across several candidate surfaces per ray)."""
    if background != "cluttered":
        return _SPHERES, _SPHERE_COLORS
    rng = np.random.default_rng(7)
    n = 24
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    radii = rng.uniform(1.2, 5.5, size=(n, 1))
    sizes = rng.uniform(0.15, 0.6, size=(n, 1))
    extra = np.concatenate([u * radii, sizes], axis=-1).astype(np.float32)
    colors = rng.uniform(0.15, 0.95, size=(n, 3)).astype(np.float32)
    return (np.concatenate([_SPHERES, extra]),
            np.concatenate([_SPHERE_COLORS, colors]))


def _wall_color(p: np.ndarray) -> np.ndarray:
    """Smooth banded texture on the wall sphere as a function of hit point."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = np.linalg.norm(p, axis=-1) + 1e-9
    u = np.arctan2(y, x)
    v = z / r
    c0 = 0.5 + 0.45 * np.sin(3.0 * u) * np.cos(4.0 * v * np.pi)
    c1 = 0.5 + 0.45 * np.sin(5.0 * v * np.pi + 1.0)
    c2 = 0.5 + 0.45 * np.cos(2.0 * u + 3.0 * v)
    return np.stack([c0, c1, c2], axis=-1).astype(np.float32)


def trace_rays(rays_o: np.ndarray, rays_d: np.ndarray, wall_radius: float = 8.0,
               background: str = "wall"):
    """Closed-form ray cast. Returns (rgb (N,3), depth (N,)).

    ``background='wall'`` closes the scene with a textured sphere of radius
    ``wall_radius`` (everything is in-volume — the default).
    ``background='env'`` puts the same texture at infinity instead: rays
    that miss every solid sphere see a direction-only color with depth 0
    (= "no depth supervision" sentinel), which is exactly the environment-
    map factorization the use_envmap model family learns (reference
    composite: models/EgoNeRF.py:586-591).
    ``background='cluttered'`` keeps the wall but fills the volume with 24
    extra spheres (see _scene_spheres) — the cull-adversarial variant.
    """
    n = rays_o.shape[0]
    best_t = np.full(n, np.inf, np.float32)
    rgb = np.zeros((n, 3), np.float32)

    spheres, sphere_colors = _scene_spheres(background)
    for sph, col in zip(spheres, sphere_colors):
        oc = rays_o - sph[:3]
        b = np.sum(oc * rays_d, -1)
        c = np.sum(oc * oc, -1) - sph[3] ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        valid = hit & (t > 1e-3) & (t < best_t)
        # simple lambert-ish shading from the hit normal for trainable detail
        p = rays_o + t[..., None] * rays_d
        normal = (p - sph[:3]) / sph[3]
        shade = 0.6 + 0.4 * np.clip(normal[..., 1], -1, 1)
        rgb[valid] = col[None] * shade[valid, None]
        best_t[valid] = t[valid]

    if background == "env":
        # texture at infinity: direction-only color, depth-0 sentinel
        miss = ~np.isfinite(best_t)
        rgb[miss] = _wall_color(rays_d[miss])
        best_t[miss] = 0.0
        return rgb, best_t

    # wall sphere centered at origin
    b = np.sum(rays_o * rays_d, -1)
    c = np.sum(rays_o * rays_o, -1) - wall_radius ** 2
    t = -b + np.sqrt(np.maximum(b * b - c, 0.0))
    valid = t < best_t
    p = rays_o + t[..., None] * rays_d
    rgb[valid] = _wall_color(p[valid])
    best_t[valid] = t[valid]
    return rgb, best_t


def make_poses(n: int, radius: float = 0.35) -> np.ndarray:
    """Small circular camera trajectory near the origin (egocentric)."""
    poses = []
    for k in range(n):
        a = 2.0 * np.pi * k / max(n, 1)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [radius * np.cos(a), 0.05 * np.sin(2 * a), radius * np.sin(a)]
        poses.append(c2w)
    return np.stack(poses)


def render_views(poses: np.ndarray, h: int, w: int, wall_radius: float = 8.0,
                 background: str = "wall"):
    """Render (n, h*w, 6) rays, (n, h*w, 3) colors and (n, h*w) ground-truth
    depths for each pose."""
    dirs = get_ray_directions_360(h, w)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    all_rays, all_rgbs, all_depths = [], [], []
    for c2w in poses:
        rays_o, rays_d = get_rays(dirs, c2w)
        rgb, depth = trace_rays(rays_o, rays_d, wall_radius, background)
        all_rays.append(np.concatenate([rays_o, rays_d], -1))
        all_rgbs.append(rgb)
        all_depths.append(depth)
    return np.stack(all_rays), np.stack(all_rgbs), np.stack(all_depths)
