"""Dataset loaders (counterpart of ``egonerf_tpu/data/datasets.py``):
host-side numpy pipelines with the flat interface the trainer consumes.

* ``all_rays``: (N, 6) float32 [origin | direction], or (n_img, h*w, 6)
  when ``is_stack`` (eval);
* ``all_rgbs``: matching colors;
* ``scene_bbox`` (2, 3), ``near_far``, ``img_wh``, ``roi``, ``white_bg``;
  the equirectangular loaders also ``img_wh_origin``, the full frame
  before the roi crop, which the theta-importance sampler needs.

The registry holds JAX's five: OmniBlender (``transform.json`` and
equirect renders), the egocentric video loader (Ricoh360 captures with
COLMAP, OpenVSLAM or Pix4D poses), OmniScenes, LLFF and the procedural
scene.  Images decode once at startup through ``png.read_image`` (the
port's PNG codec; PIL for other formats and for a resize); JAX's
departures from upstream are kept: OmniBlender crops its images by the
roi with its rays, and ``img_wh`` is taken from the crop bounds.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .png import read_image
from .pose_descriptor import pose_descriptor_dict
from .ray_utils import (
    center_poses,
    get_ray_directions_360,
    get_ray_directions_blender,
    get_rays,
    get_spiral,
)
from .synthetic import make_poses, render_views


def _parallel_map(fn, items, workers: int = 16) -> list:
    """Decode and ray generation in a thread pool (zlib and large numpy
    ops release the GIL); the results keep the order of ``items``, so the
    rays stay in the order the samplers' ids assume."""
    if len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(workers, len(items))) as ex:
        return list(ex.map(fn, items))


def _load_image(path, resize_wh=None) -> np.ndarray:
    """Decode to float32 (h, w, c) in [0, 1]; RGBA blended onto white."""
    arr = read_image(path, resize_wh).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3] * arr[..., 3:4] + (1.0 - arr[..., 3:4])
    return arr


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
        self.pose_descriptor = pose_descriptor_dict[localization_method]()

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


class OmniBlenderDataset(EgoNeRFDataset):
    """Synthetic equirect renders with transform.json + train/test split
    files (reference: dataLoader/dataset_omniblender.py)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # same cropped-img_wh convention as the Ricoh/OmniScenes loaders:
        # img_wh is the roi raster, img_wh_origin the full frame (identical
        # when roi is the default full frame).  The reference's omniblender
        # loader crops rays by roi but NOT images (dataset_omniblender.py:
        # 70-84), silently misaligning every ray/rgb pair at roi != full —
        # a latent upstream bug its configs never hit; fixed here.
        self.img_wh_origin = (int(2000 / self.downsample),
                              int(1000 / self.downsample))
        w0, h0 = self.img_wh_origin
        r0_, r1_, c0_, c1_ = self.roi
        self.img_wh = (int(c1_ * w0) - int(c0_ * w0),
                       int(r1_ * h0) - int(r0_ * h0))
        self.read_meta()
        self.scene_bbox = self.get_scene_bbox()

    def read_meta(self):
        with open(os.path.join(self.root_dir, "transform.json")) as f:
            meta = json.load(f)
        self.indoor = meta.get("indoor", True)
        w, h = self.img_wh_origin

        directions = get_ray_directions_360(h, w)
        directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
        r0_, r1_, c0_, c1_ = self.roi
        self.directions = directions[int(r0_ * h) : int(r1_ * h), int(c0_ * w) : int(c1_ * w)]

        with open(os.path.join(self.root_dir, f"{self.split}.txt")) as f:
            img_list = [line.strip() for line in f if line.strip()]
        if self.split == "train":
            assert self.skip == 1, "skip must be 1 for training"
        img_list = img_list[:: self.skip]

        frame_names = [fr["file_path"].split(".")[0] for fr in meta["frames"]]

        def load_one(name):
            frame = meta["frames"][frame_names.index(name)]
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            img = _load_image(
                os.path.join(self.root_dir, "images", frame["file_path"]),
                resize_wh=self.img_wh_origin if self.downsample != 1.0 else None,
            )
            img = img[int(r0_ * h) : int(r1_ * h), int(c0_ * w) : int(c1_ * w)]
            rays_o, rays_d = get_rays(directions, c2w, self.roi)
            return c2w, img.reshape(-1, 3), np.concatenate([rays_o, rays_d], -1)

        loaded = _parallel_map(load_one, img_list)
        self.poses = np.stack([l[0] for l in loaded])
        self._finalize([l[2] for l in loaded], [l[1] for l in loaded])


class EgocentricVideoDataset(EgoNeRFDataset):
    """Real 360 captures (Ricoh360) with SLAM/SfM poses from a pluggable
    descriptor (reference: dataLoader/dataset_egocentric_video.py)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.img_wh_origin = (int(1920 / self.downsample), int(960 / self.downsample))
        # derived from the CROP BOUNDS, not int(size * roi_span): the
        # reference computes these with different truncations
        # (dataset_egocentric_video.py:17 vs :77) and crashes reshaping
        # whenever a fractional roi rounds them apart — identical values
        # wherever the reference works
        w0, h0 = self.img_wh_origin
        self.img_wh = (
            int(self.roi[3] * w0) - int(self.roi[2] * w0),
            int(self.roi[1] * h0) - int(self.roi[0] * h0),
        )
        self.read_meta()
        self.scene_bbox = self.get_scene_bbox()

    def read_meta(self):
        img_dir = os.path.join(self.root_dir, "imgs")
        with open(os.path.join(self.root_dir, f"{self.split}.txt")) as f:
            img_list = [os.path.join(img_dir, line.strip() + ".png") for line in f if line.strip()]

        w, h = self.img_wh_origin
        directions = get_ray_directions_360(h, w)
        directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
        r0_, r1_, c0_, c1_ = self.roi
        self.directions = directions[int(r0_ * h) : int(r1_ * h), int(c0_ * w) : int(c1_ * w)]

        self.pose_descriptor.read_pose_file(self.root_dir, img_ext=".png")
        self.pose_descriptor.normalize_pose()

        def load_one(fname):
            img = _load_image(fname, resize_wh=self.img_wh_origin if self.downsample != 1.0 else None)
            r0, r1, c0, c1 = self.roi
            img = img[int(r0 * h) : int(r1 * h), int(c0 * w) : int(c1 * w)]
            c2w = np.asarray(self.pose_descriptor.poses_dict[os.path.basename(fname)], np.float32)
            rays_o, rays_d = get_rays(directions, c2w, roi=self.roi)
            return c2w, img.reshape(-1, 3), np.concatenate([rays_o, rays_d], -1)

        loaded = _parallel_map(load_one, img_list)
        self.poses = np.stack([l[0] for l in loaded])
        self._finalize([l[2] for l in loaded], [l[1] for l in loaded])


class OmniscenesDataset(EgoNeRFDataset):
    """Turtlebot panoramas with per-frame pose txt; fixed roi crops the
    robot body out of the frame (reference: dataLoader/dataset_omniscenes.py)."""

    RAYS2CAM = np.array([
        [0.0, 0.0, -1.0, 0.0],
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ], dtype=np.float32)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.roi = [0.0, 0.9, 0.0, 1.0]
        self.img_wh_origin = (int(1920 / self.downsample), int(960 / self.downsample))
        # crop-bound-derived for the same reason as EgocentricVideoDataset
        w0, h0 = self.img_wh_origin
        self.img_wh = (
            int(self.roi[3] * w0) - int(self.roi[2] * w0),
            int(self.roi[1] * h0) - int(self.roi[0] * h0),
        )
        self.read_meta()
        self.scene_bbox = self.get_scene_bbox()

    def _load_pose(self, filename) -> np.ndarray:
        nums = open(filename).read().split()
        c2w = np.asarray(nums, np.float32).reshape(3, 4)
        c2w[:3, :3] = np.linalg.inv(c2w[:3, :3])
        c2w4 = np.eye(4, dtype=np.float32)
        c2w4[:3] = c2w
        return c2w4 @ self.RAYS2CAM

    def read_meta(self):
        room = os.path.basename(self.root_dir.rstrip("/"))
        base = os.path.dirname(self.root_dir.rstrip("/"))
        img_dir = os.path.join(base, "turtlebot_pano", room)
        pose_dir = os.path.join(base, "turtlebot_pose", room)
        # filter BEFORE sorting: the numeric-parse key would raise on any
        # stray file (.DS_Store, backups) in the capture directories
        key = lambda f: int(os.path.splitext(f)[0][4:])
        img_files = [os.path.join(img_dir, f) for f in
                     sorted((f for f in os.listdir(img_dir) if f.endswith(".jpg")), key=key)]
        pose_files = [os.path.join(pose_dir, f) for f in
                      sorted((f for f in os.listdir(pose_dir) if f.endswith(".txt")), key=key)]
        assert len(img_files) == len(pose_files)

        if self.split == "train":
            img_files, pose_files = img_files[-31:-1], pose_files[-31:-1]
        elif self.split == "test":
            img_files, pose_files = img_files[-1:], pose_files[-1:]

        w, h = self.img_wh_origin
        directions = get_ray_directions_360(h, w)
        directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
        r0_, r1_, c0_, c1_ = self.roi
        self.directions = directions[int(r0_ * h) : int(r1_ * h), int(c0_ * w) : int(c1_ * w)]

        def load_one(paths):
            img_path, pose_path = paths
            c2w = self._load_pose(pose_path)
            img = _load_image(img_path, resize_wh=self.img_wh_origin if self.downsample != 1.0 else None)
            r0, r1, c0, c1 = self.roi
            img = img[int(r0 * h) : int(r1 * h), int(c0 * w) : int(c1 * w)]
            rays_o, rays_d = get_rays(directions, c2w, self.roi)
            return c2w, img.reshape(-1, 3), np.concatenate([rays_o, rays_d], -1)

        loaded = _parallel_map(load_one, list(zip(img_files, pose_files)))
        self.poses = np.stack([l[0] for l in loaded])
        self._finalize([l[2] for l in loaded], [l[1] for l in loaded])


class LLFFDataset(EgoNeRFDataset):
    """Forward-facing perspective scenes — the plain-TensoRF baseline path
    (reference: dataLoader/dataset_llff.py:122-267)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.read_meta()
        self.scene_bbox = self.get_scene_bbox()

    def read_meta(self):
        import glob

        poses_bounds = np.load(os.path.join(self.root_dir, "poses_bounds.npy"))
        img_dir = "images" if self.downsample == 1.0 else f"images_{int(self.downsample)}"
        self.image_paths = sorted(glob.glob(os.path.join(self.root_dir, img_dir, "*")))
        if self.split in ("train", "test"):
            assert len(poses_bounds) == len(self.image_paths), (
                f"poses_bounds.npy has {len(poses_bounds)} poses but "
                f"{img_dir}/ holds {len(self.image_paths)} images")

        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.near_fars = poses_bounds[:, -2:]
        h0, w0, focal0 = poses[0, :, -1]
        self.img_wh = (int(round(w0 / self.downsample)), int(round(h0 / self.downsample)))
        self.focal = [focal0 * self.img_wh[0] / w0, focal0 * self.img_wh[1] / h0]

        # "down right back" -> "right up back"
        poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses, np.eye(4))
        # SIGNED max, matching the reference exactly (dataset_llff.py:182):
        # near/far and voxel configs are tuned against that world scale
        self.poses[..., 3] /= self.poses[..., 3].max()

        self.render_path = get_spiral(self.poses, self.near_fars, n_views=120)

        i_test = np.arange(0, self.poses.shape[0], 8)
        img_list = (i_test if self.split != "train"
                    else sorted(set(range(len(self.poses))) - set(i_test.tolist())))

        rays_list, rgbs_list = [], []
        for i in img_list:
            c2w = self.poses[i].astype(np.float32)
            img = _load_image(self.image_paths[i])
            h, w = img.shape[:2]
            self.img_wh = (w, h)
            directions = get_ray_directions_blender(h, w, self.focal)
            self.directions = directions
            rgbs_list.append(img.reshape(-1, 3))
            rays_o, rays_d = get_rays(directions, c2w)
            rays_list.append(np.concatenate([rays_o, rays_d], -1))
        self.poses = self.poses[np.asarray(img_list)]
        self._finalize(rays_list, rgbs_list)


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


dataset_dict = {
    "llff": LLFFDataset,
    "egocentric": EgocentricVideoDataset,
    "omniblender": OmniBlenderDataset,
    "omniscenes": OmniscenesDataset,
    "synthetic": SyntheticEgoDataset,
}


def dataset_class(name: str):
    if name not in dataset_dict:
        raise ValueError(f"unknown dataset {name!r}; the registry holds {sorted(dataset_dict)}")
    return dataset_dict[name]
