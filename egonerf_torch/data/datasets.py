"""Dataset loaders (counterpart of ``egonerf_tpu/data/datasets.py``):
host-side numpy pipelines with the flat interface the trainer consumes.

* ``all_rays``: (N, 6) float32 [origin | direction], or (n_img, h*w, 6)
  when ``is_stack`` (eval);
* ``all_rgbs``: matching colors;
* ``scene_bbox`` (2, 3), ``near_far``, ``img_wh``, ``roi``, ``white_bg``.

The port carries the procedural scene; the loaders of captured data
(OmniBlender, Ricoh360, OmniScenes, LLFF, egocentric video) need files the
repository does not hold and wait (ROADMAP.md §1).
"""
from __future__ import annotations

import numpy as np

from .ray_utils import get_ray_directions_360
from .synthetic import make_poses, render_views


class EgoNeRFDataset:
    """Common state and the trajectory-sphere scene bbox rule."""

    def __init__(self, data_dir, split="train", is_stack=False, downsample=1.0,
                 near_far=(0.1, 15.0), roi=(0.0, 1.0, 0.0, 1.0),
                 localization_method="colmap", skip=1, use_gt_depth=False, **_):
        self.root_dir = data_dir
        self.split = split
        self.is_stack = is_stack
        self.downsample = downsample
        self.near_far = [float(near_far[0]), float(near_far[1])]
        self.roi = list(roi) if roi is not None else [0.0, 1.0, 0.0, 1.0]
        self.localization_method = localization_method
        self.skip = int(skip)
        self.use_gt_depth = use_gt_depth

        self.white_bg = False
        self.img_wh = (0, 0)
        self.poses = None
        self.all_rays = None
        self.all_rgbs = None
        self.all_depths = None
        self.center = None
        self.scene_bbox = None

    def get_scene_bbox(self) -> np.ndarray:
        cam_pos = self.poses[:, :3, 3]
        self.center = cam_pos.mean(0)
        traj_radius = np.linalg.norm(cam_pos.max(0) - cam_pos.min(0)) / 2.0
        return np.stack([
            self.center - traj_radius - self.near_far[1],
            self.center + traj_radius + self.near_far[1],
        ]).astype(np.float32)

    def _finalize(self, rays_list, rgbs_list):
        if self.is_stack:
            self.all_rays = np.stack(rays_list).astype(np.float32)
            w, h = self.img_wh
            self.all_rgbs = np.stack(rgbs_list).reshape(-1, h, w, 3).astype(np.float32)
        else:
            self.all_rays = np.concatenate(rays_list).astype(np.float32)
            self.all_rgbs = np.concatenate(rgbs_list).astype(np.float32)

    def __len__(self):
        return len(self.all_rgbs)


class SyntheticEgoDataset(EgoNeRFDataset):
    """Procedural analytic scene (see .synthetic): needs no files on disk.
    Every ``n // n_test``-th pose is a test view, the others train."""

    def __init__(self, n_train=8, n_test=2, height=100, width=200, wall_radius=8.0,
                 background="wall", **kwargs):
        kwargs.setdefault("data_dir", "<synthetic>")
        kwargs.setdefault("near_far", (0.05, float(wall_radius) * 1.05))
        super().__init__(**kwargs)
        self.img_wh = (width, height)
        n = n_train + n_test
        poses = make_poses(n)
        test_idx = np.arange(0, n, max(n // max(n_test, 1), 1))[:n_test]
        idx = (test_idx if self.split == "test"
               else np.asarray(sorted(set(range(n)) - set(test_idx.tolist()))))
        self.poses = poses[idx]
        dirs = get_ray_directions_360(height, width)
        self.directions = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        rays, rgbs, depths = render_views(self.poses, height, width, wall_radius, background)
        self._finalize(list(rays), list(rgbs))
        # analytic ground-truth depth
        self.all_depths = (np.stack(depths).astype(np.float32) if self.is_stack
                           else np.concatenate(depths).astype(np.float32))
        self.scene_bbox = self.get_scene_bbox()


dataset_dict = {"synthetic": SyntheticEgoDataset}


def dataset_class(name: str):
    if name not in dataset_dict:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md §1); the port "
            f"carries {sorted(dataset_dict)}")
    return dataset_dict[name]
