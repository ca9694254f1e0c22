"""The benchmark's scenes, written from the seed in the loaders' layouts.

Frozen copies of the procedural world (a textured wall sphere with three
solid spheres), its equirectangular camera, the OmniBlender-layout writer
and the Ricoh-layout capture writer (COLMAP poses) that the program's
tools use, so that a change to the program cannot move what the benchmark
feeds it.  The PNGs are written by a plain zlib encoder of this file.

Every scene is drawn from the seed: the trajectory's yaw and phase (the
OmniBlender layout) or its wobble (the Ricoh layout), and so the pixels.
The work a training step or a view does depends on the shapes alone.
"""
from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
from scipy.spatial.transform import Rotation

_SPHERES = np.array([[1.5, 0.3, -1.0, 0.55], [-1.2, -0.4, 1.3, 0.45], [0.2, 1.4, 0.8, 0.35]],
                    dtype=np.float32)
_SPHERE_COLORS = np.array([[0.9, 0.25, 0.2], [0.2, 0.55, 0.9], [0.95, 0.8, 0.25]],
                          dtype=np.float32)
WALL_RADIUS = 8.0


def ray_directions_360(h: int, w: int) -> np.ndarray:
    """Unit equirectangular directions (h, w, 3), axes [right, up,
    backward], pixel centres at +0.5."""
    i = np.tile(np.arange(w, dtype=np.float32), (h, 1)) + 0.5
    j = np.tile(np.arange(h, dtype=np.float32), (w, 1)).T + 0.5
    phi = (1.0 - 2.0 * i / w) * np.pi
    theta = (1.0 - 2.0 * j / h) * np.pi / 2
    dirs = np.stack([-np.cos(theta) * np.sin(phi), np.sin(theta),
                     -np.cos(theta) * np.cos(phi)], axis=-1).astype(np.float32)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def rays_of(dirs: np.ndarray, c2w: np.ndarray):
    """(origins, directions) (N, 3) float32 of a camera pose."""
    rays_d = dirs.reshape(-1, 3) @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def _wall_color(p: np.ndarray) -> np.ndarray:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = np.linalg.norm(p, axis=-1) + 1e-9
    u = np.arctan2(y, x)
    v = z / r
    c0 = 0.5 + 0.45 * np.sin(3.0 * u) * np.cos(4.0 * v * np.pi)
    c1 = 0.5 + 0.45 * np.sin(5.0 * v * np.pi + 1.0)
    c2 = 0.5 + 0.45 * np.cos(2.0 * u + 3.0 * v)
    return np.stack([c0, c1, c2], axis=-1).astype(np.float32)


def trace_rays(rays_o: np.ndarray, rays_d: np.ndarray) -> np.ndarray:
    """Closed-form ray cast of the procedural world: (N, 3) colours."""
    n = rays_o.shape[0]
    best_t = np.full(n, np.inf, np.float32)
    rgb = np.zeros((n, 3), np.float32)
    for sph, col in zip(_SPHERES, _SPHERE_COLORS):
        oc = rays_o - sph[:3]
        b = np.sum(oc * rays_d, -1)
        c = np.sum(oc * oc, -1) - sph[3] ** 2
        disc = b * b - c
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        valid = (disc > 0) & (t > 1e-3) & (t < best_t)
        p = rays_o + t[..., None] * rays_d
        shade = 0.6 + 0.4 * np.clip((p[..., 1] - sph[1]) / sph[3], -1, 1)
        rgb[valid] = col[None] * shade[valid, None]
        best_t[valid] = t[valid]
    b = np.sum(rays_o * rays_d, -1)
    c = np.sum(rays_o * rays_o, -1) - WALL_RADIUS ** 2
    t = -b + np.sqrt(np.maximum(b * b - c, 0.0))
    valid = t < best_t
    p = rays_o + t[..., None] * rays_d
    rgb[valid] = _wall_color(p[valid])
    return rgb


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG, every row with filter 0, zlib level 1."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


def omniblender_poses(n: int, rng: np.random.Generator, radius: float = 0.35) -> np.ndarray:
    """A small circular trajectory near the origin, its phase and yaw
    drawn from ``rng`` (float32 c2w, (n, 4, 4))."""
    phase = rng.uniform(0.0, 2.0 * np.pi)
    yaw = Rotation.from_euler("y", rng.uniform(0.0, 360.0), degrees=True).as_matrix()
    poses = []
    for k in range(n):
        a = phase + 2.0 * np.pi * k / n
        c2w = np.eye(4)
        c2w[:3, :3] = yaw
        c2w[:3, 3] = [radius * np.cos(a), 0.05 * np.sin(2 * a), radius * np.sin(a)]
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def ricoh_poses(n: int, rng: np.random.Generator) -> np.ndarray:
    """An egocentric loop (yaw along the path, pitch and roll wobble) with
    jittered centres of exactly zero mean and unit mean radius, so that the
    loader's pose normalisation is the identity (float64 c2w)."""
    a = 2.0 * np.pi * np.arange(n) / n
    centers = np.stack([np.cos(a), 0.12 * np.sin(2 * a), np.sin(a)], -1)
    centers = centers + rng.normal(scale=0.02, size=centers.shape)
    centers -= centers.mean(0)
    centers /= np.linalg.norm(centers, axis=-1).mean()
    poses = []
    for k in range(n):
        rot = (Rotation.from_euler("y", np.degrees(a[k]), degrees=True)
               * Rotation.from_euler("x", 6.0 * np.sin(3 * a[k]), degrees=True)
               * Rotation.from_euler("z", 4.0 * np.cos(2 * a[k]), degrees=True))
        c2w = np.eye(4)
        c2w[:3, :3] = rot.as_matrix()
        c2w[:3, 3] = centers[k]
        poses.append(c2w)
    return np.stack(poses)


def _colmap_line(idx: int, c2w: np.ndarray, name: str) -> str:
    """The images.txt line whose COLMAP pose the loader maps back to
    ``c2w`` (world_align @ inv(w2c) @ rays2cam)."""
    world_align = np.array([[1.0, 0, 0, 0], [0, 0, 1.0, 0], [0, -1.0, 0, 0], [0, 0, 0, 1.0]])
    rays2cam = np.diag([1.0, -1.0, -1.0, 1.0])
    w2c = np.linalg.inv(world_align.T @ c2w @ rays2cam)
    q = Rotation.from_matrix(w2c[:3, :3]).as_quat()
    t = w2c[:3, 3]
    return (f"{idx} {q[3]:.17g} {q[0]:.17g} {q[1]:.17g} {q[2]:.17g} "
            f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} 1 {name}")


def trajectory(layout: str, n: int, seed: int) -> np.ndarray:
    """The scene's float32 camera poses (n, 4, 4) for ``seed``."""
    rng = np.random.default_rng(seed)
    if layout == "omniblender":
        return omniblender_poses(n, rng)
    if layout == "ricoh":
        return ricoh_poses(n, rng).astype(np.float32)
    raise ValueError(f"unknown scene layout {layout!r}")


def scene_aabb(poses: np.ndarray, far: float) -> np.ndarray:
    """The loaders' scene box: the camera centres' mean, widened by half
    their extent's diagonal and the far plane (float32 (2, 3))."""
    cam = poses[:, :3, 3]
    center = cam.mean(0)
    radius = np.linalg.norm(cam.max(0) - cam.min(0)) / 2.0
    return np.stack([center - radius - far, center + radius + far]).astype(np.float32)


class Scene:
    """A scene written to ``root``: its poses (float32), the test frame
    indices, the train frames in the loader's order and their pixels."""

    def __init__(self, root, layout, poses, train_idx, test_idx, images):
        self.root, self.layout, self.poses = root, layout, poses
        self.train_idx, self.test_idx, self.images = train_idx, test_idx, images

    @property
    def train_poses(self) -> np.ndarray:
        return self.poses[self.train_idx]

    def train_pixels(self) -> np.ndarray:
        """uint8 (n_train, h * w, 3) in the loader's order."""
        return np.stack([self.images[k].reshape(-1, 3) for k in self.train_idx])


def write_scene(root: str, layout: str, n_train: int, n_test: int, height: int, width: int,
                seed: int) -> Scene:
    """Write ``n_train + n_test`` equirect frames of the procedural world
    under ``root`` in ``layout`` ("omniblender": transform.json, images/,
    train.txt, test.txt; "ricoh": imgs/, COLMAP images.txt, train.txt,
    test.txt); frame 0 is the test frame when there is one."""
    n = n_train + n_test
    poses = trajectory(layout, n, seed)
    dirs = ray_directions_360(height, width)
    test_idx = list(range(n_test))
    train_idx = list(range(n_test, n))
    if layout == "omniblender":
        img_dir, names = os.path.join(root, "images"), [f"cam_{k:03d}" for k in range(n)]
    else:
        img_dir, names = os.path.join(root, "imgs"), [f"frame_{k:04d}" for k in range(n)]
    os.makedirs(img_dir, exist_ok=True)
    images = []
    for k in range(n):
        rgb = trace_rays(*rays_of(dirs, poses[k]))
        img = (np.clip(rgb.reshape(height, width, 3), 0, 1) * 255 + 0.5).astype(np.uint8)
        write_png(os.path.join(img_dir, f"{names[k]}.png"), img)
        images.append(img)
    if layout == "omniblender":
        frames = [{"file_path": f"{nm}.png", "transform_matrix": p.tolist()}
                  for nm, p in zip(names, poses)]
        with open(os.path.join(root, "transform.json"), "w") as f:
            json.dump({"indoor": True, "frames": frames}, f)
    else:
        os.makedirs(os.path.join(root, "output_dir", "colmap"), exist_ok=True)
        lines = ["# Image list with two lines of data per image:",
                 "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
                 "#   POINTS2D[] as (X, Y, POINT3D_ID)", "# Number of images: synthetic"]
        for k, nm in enumerate(names):
            lines += [_colmap_line(k + 1, poses[k].astype(np.float64), f"{nm}.jpg"), ""]
        with open(os.path.join(root, "output_dir", "colmap", "images.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    for split, idx in (("train", train_idx), ("test", test_idx)):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names[k] for k in idx) + "\n")
    return Scene(root, layout, poses, train_idx, test_idx, images)


def view_poses(layout: str, n_views: int, seed: int) -> np.ndarray:
    """Full-frame poses of the views a render run draws: the scene's
    trajectory (its frame 0 and on, cycled) each turned by a yaw drawn
    from ``seed`` (float32 (n_views, 4, 4))."""
    rng = np.random.default_rng([seed, 1])
    base = trajectory(layout, max(n_views, 4), seed)
    out = []
    for k in range(n_views):
        c2w = base[k % len(base)].astype(np.float64)
        yaw = Rotation.from_euler("y", rng.uniform(0.0, 360.0), degrees=True).as_matrix()
        c2w[:3, :3] = yaw @ c2w[:3, :3]
        out.append(c2w)
    return np.stack(out).astype(np.float32)
