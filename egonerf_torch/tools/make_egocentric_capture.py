"""Synthesize a Ricoh-style egocentric capture ON DISK from the procedural
scene (the port's copy of ``egonerf_tpu/tools/make_egocentric_capture.py``,
which it may not import) — the full real-data layout the reference's
egocentric-video path consumes (reference:
dataLoader/dataset_egocentric_video.py:13-136,
dataLoader/pose_descriptor.py:20-139), so the
``EgocentricVideoDataset -> train -> eval`` pipeline can run end to end
without downloadable captures.  The PNGs go through the port's own codec
(``data/png.py``), the pose files through the JAX writer's format strings,
so both match what the JAX tool writes for the same arguments.

Writes, under ``out_dir``:
  * ``imgs/frame_%04d.png``           equirect renders of the procedural scene
  * ``train.txt`` / ``test.txt``      frame-name splits (no extension)
  * ``output_dir/colmap/images.txt``  COLMAP pose file (4 header lines,
                                      image/points2D line alternation,
                                      wxyz quaternions of the w2c)
  * ``openvslam/frame_trajectory_with_file_name.txt``  the same trajectory
                                      in OpenVSLAM frame format (xyzw)

The written poses are EXACT inverses of the dataset's descriptor math:
``world_align @ inv(w2c) @ rays2cam`` recovers the render pose, and the
trajectory is pre-centered to zero mean / unit mean radius so
``normalize_pose`` is the identity — what the loader yields equals what
the images were rendered with.

Usage:
    python -m egonerf_torch.tools.make_egocentric_capture out_dir \
        [n_frames] [height]
"""
from __future__ import annotations

import os
import sys

import numpy as np
from scipy.spatial.transform import Rotation as R


def make_trajectory(n_frames: int, seed: int = 0) -> np.ndarray:
    """Egocentric loop with real rotations: yaw follows the path, small
    pitch/roll wobble.  Centers are exactly zero-mean with unit mean
    radius (so the loader's normalize_pose is the identity)."""
    rng = np.random.default_rng(seed)
    a = 2.0 * np.pi * np.arange(n_frames) / max(n_frames, 1)
    centers = np.stack([np.cos(a), 0.12 * np.sin(2 * a), np.sin(a)], -1)
    centers = centers + rng.normal(scale=0.02, size=centers.shape)
    centers -= centers.mean(0)
    centers /= np.linalg.norm(centers, axis=-1).mean()
    poses = []
    for k in range(n_frames):
        rot = (R.from_euler("y", np.degrees(a[k]), degrees=True)
               * R.from_euler("x", 6.0 * np.sin(3 * a[k]), degrees=True)
               * R.from_euler("z", 4.0 * np.cos(2 * a[k]), degrees=True))
        c2w = np.eye(4)
        c2w[:3, :3] = rot.as_matrix()
        c2w[:3, 3] = centers[k]
        poses.append(c2w)
    return np.stack(poses)


def _colmap_line(idx: int, c2w: np.ndarray, name: str) -> str:
    """Invert ColmapPoseDescriptor: find (qw qx qy qz, t) whose descriptor
    output is exactly ``c2w`` (descriptor: world_align @ inv(w2c) @
    rays2cam, data/pose_descriptor.py:49-87)."""
    world_align = np.array([[1.0, 0, 0, 0], [0, 0, 1.0, 0],
                            [0, -1.0, 0, 0], [0, 0, 0, 1.0]])
    rays2cam = np.diag([1.0, -1.0, -1.0, 1.0])
    c2w_colmap = world_align.T @ c2w @ rays2cam  # both factors self-inverse^T
    w2c = np.linalg.inv(c2w_colmap)
    q = R.from_matrix(w2c[:3, :3]).as_quat()  # xyzw
    t = w2c[:3, 3]
    return (f"{idx} {q[3]:.17g} {q[0]:.17g} {q[1]:.17g} {q[2]:.17g} "
            f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} 1 {name}")


def _openvslam_line(c2w: np.ndarray, name: str) -> str:
    """Invert OpenVSlamPoseDescriptor (data/pose_descriptor.py:89-116)."""
    world_align = np.array([[0, 1.0, 0, 0], [0, 0, 1.0, 0],
                            [-1.0, 0, 0, 0], [0, 0, 0, 1.0]])
    rays2cam = np.array([[0, 0, -1.0, 0], [1.0, 0, 0, 0],
                         [0, 1.0, 0, 0], [0, 0, 0, 1.0]])
    c2w_vslam = world_align.T @ c2w @ rays2cam.T
    w2c = np.linalg.inv(c2w_vslam)
    q = R.from_matrix(w2c[:3, :3]).as_quat()  # xyzw, written verbatim
    t = w2c[:3, 3]
    return (f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} "
            f"{q[0]:.17g} {q[1]:.17g} {q[2]:.17g} {q[3]:.17g} 0 {name}")


def make_capture(out_dir: str, n_frames: int = 10, height: int = 240,
                 n_test: int = 2, seed: int = 0, wall_radius: float = 8.0):
    """Render + write the full capture; returns the exact render poses."""
    from ..data.png import write_png
    from ..data.ray_utils import get_ray_directions_360, get_rays
    from ..data.synthetic import trace_rays

    width = 2 * height
    poses = make_trajectory(n_frames, seed=seed)
    dirs = get_ray_directions_360(height, width)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    img_dir = os.path.join(out_dir, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "output_dir", "colmap"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "openvslam"), exist_ok=True)

    names = [f"frame_{k:04d}" for k in range(n_frames)]
    colmap_lines = ["# Image list with two lines of data per image:",
                    "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
                    "#   POINTS2D[] as (X, Y, POINT3D_ID)",
                    "# Number of images: synthetic"]
    vslam_lines = []
    for k, name in enumerate(names):
        c2w32 = poses[k].astype(np.float32)
        rays_o, rays_d = get_rays(dirs, c2w32)
        rgb, _ = trace_rays(rays_o, rays_d, wall_radius, "wall")
        img = (np.clip(rgb.reshape(height, width, 3), 0, 1)
               * 255 + 0.5).astype(np.uint8)
        write_png(os.path.join(img_dir, f"{name}.png"), img)
        colmap_lines.append(_colmap_line(k + 1, poses[k], f"{name}.jpg"))
        colmap_lines.append("")  # empty points2D line (zero observations)
        vslam_lines.append(_openvslam_line(poses[k], f"{name}.jpg"))

    with open(os.path.join(out_dir, "output_dir", "colmap", "images.txt"), "w") as f:
        f.write("\n".join(colmap_lines) + "\n")
    with open(os.path.join(out_dir, "openvslam",
                           "frame_trajectory_with_file_name.txt"), "w") as f:
        f.write("\n".join(vslam_lines) + "\n")

    # every-Nth test split like real captures; remaining frames train
    test_idx = set(np.linspace(0, n_frames - 1, n_test).astype(int).tolist())
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(n for k, n in enumerate(names) if k not in test_idx) + "\n")
    with open(os.path.join(out_dir, "test.txt"), "w") as f:
        f.write("\n".join(n for k, n in enumerate(names) if k in test_idx) + "\n")
    return poses


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    if not args:
        raise SystemExit(__doc__)
    out_dir = args[0]
    n_frames = int(args[1]) if len(args) > 1 else 10
    height = int(args[2]) if len(args) > 2 else 240
    poses = make_capture(out_dir, n_frames=n_frames, height=height)
    print(f"wrote {n_frames} frames ({2 * height}x{height}) + colmap/openvslam "
          f"poses under {out_dir}")
    return poses


if __name__ == "__main__":
    main()
