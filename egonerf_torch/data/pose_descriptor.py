"""Pluggable SfM/SLAM pose readers (a copy of
``egonerf_tpu/data/pose_descriptor.py``, which the port may not import).

Each descriptor parses a localization tool's output (COLMAP's
``images.txt``, an OpenVSLAM trajectory, Pix4D's calibrated camera
parameters) into a dict of image-filename -> 4x4 c2w pose in the
framework's ray convention, and can normalize the trajectory to zero mean
and unit mean radius.
"""
from __future__ import annotations

import os

import numpy as np
from scipy.spatial.transform import Rotation as R


class PoseDescriptorBase:
    def __init__(self):
        self.poses_dict: dict[str, np.ndarray] = {}

    @property
    def rays2cam(self) -> np.ndarray:
        return np.eye(4)

    @property
    def world_align(self) -> np.ndarray:
        return np.eye(4)

    def read_pose_file(self, root_dir, sub_path=None, img_ext=None):
        raise NotImplementedError

    def normalize_pose(self):
        """Center the trajectory and scale it to unit mean radius
        (reference: dataLoader/pose_descriptor.py:20-40)."""
        if not self.poses_dict:
            return
        centers = np.stack([p[:3, 3] for p in self.poses_dict.values()])
        mean = centers.mean(0)
        dist = np.linalg.norm(centers - mean, axis=-1).mean()
        for pose in self.poses_dict.values():
            pose[:3, 3] = (pose[:3, 3] - mean) / dist

    @staticmethod
    def _w2c_to_c2w(rot: np.ndarray, t: np.ndarray) -> np.ndarray:
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = t
        return np.linalg.inv(w2c)


class ColmapPoseDescriptor(PoseDescriptorBase):
    """COLMAP images.txt: every other line is QW QX QY QZ TX TY TZ CAM NAME
    (reference: dataLoader/pose_descriptor.py:43-92)."""

    @property
    def rays2cam(self):
        return np.diag([1.0, -1.0, -1.0, 1.0])

    @property
    def world_align(self):
        return np.array([[1.0, 0, 0, 0], [0, 0, 1.0, 0], [0, -1.0, 0, 0], [0, 0, 0, 1.0]])

    def read_pose_file(self, root_dir, sub_path=None, img_ext=None):
        if not sub_path:
            sub_path = os.path.join("output_dir", "colmap", "images.txt")
        path = os.path.join(root_dir, sub_path)
        i = 0
        with open(path) as f:
            for line in f.readlines()[4:]:
                if line.startswith("#"):
                    continue
                # count EVERY non-comment line, blank ones included: an
                # image with zero observations has an EMPTY points2D line,
                # and skipping it uncounted would flip the image/points2D
                # alternation for all following entries
                i += 1
                if i % 2 == 0:
                    continue
                tokens = line.split()
                if not tokens:
                    continue  # trailing blank line
                quat = np.array(list(map(float, tokens[1:5])))[[1, 2, 3, 0]]  # wxyz->xyzw
                t = np.array(list(map(float, tokens[5:8])))
                img_fname = tokens[9]
                if img_ext:
                    img_fname = img_fname.split(".")[0] + img_ext
                c2w = self._w2c_to_c2w(R.from_quat(quat).as_matrix(), t)
                self.poses_dict[img_fname] = self.world_align @ c2w @ self.rays2cam


class OpenVSlamPoseDescriptor(PoseDescriptorBase):
    """OpenVSLAM frame trajectory: TX TY TZ QX QY QZ QW ... NAME
    (reference: dataLoader/pose_descriptor.py:95-139)."""

    @property
    def rays2cam(self):
        return np.array([[0, 0, -1.0, 0], [1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0]])

    @property
    def world_align(self):
        return np.array([[0, 1.0, 0, 0], [0, 0, 1.0, 0], [-1.0, 0, 0, 0], [0, 0, 0, 1.0]])

    def read_pose_file(self, root_dir, sub_path=None, img_ext=None):
        if not sub_path:
            sub_path = os.path.join("openvslam", "frame_trajectory_with_file_name.txt")
        path = os.path.join(root_dir, sub_path)
        with open(path) as f:
            for line in f:
                tokens = line.split()
                if not tokens or tokens[0] == "#":
                    continue
                t = np.array(list(map(float, tokens[0:3])))
                quat = np.array(list(map(float, tokens[3:7])))
                img_fname = tokens[8]
                if img_ext:
                    img_fname = img_fname.split(".")[0] + img_ext
                c2w = self._w2c_to_c2w(R.from_quat(quat).as_matrix(), t)
                self.poses_dict[img_fname] = self.world_align @ c2w @ self.rays2cam


class Pix4dPoseDescriptor(PoseDescriptorBase):
    """Pix4D calibrated_camera_parameters.txt: 5-line blocks of
    name / T / 3 rotation rows (reference: dataLoader/pose_descriptor.py:142-183)."""

    @property
    def rays2cam(self):
        return np.diag([1.0, -1.0, -1.0, 1.0])

    def read_pose_file(self, root_dir, sub_path=None, img_ext=None):
        if not sub_path:
            sub_path = os.path.join("pix4d", "calibrated_camera_parameters.txt")
        path = os.path.join(root_dir, sub_path)
        with open(path) as f:
            lines = f.readlines()[3:]
        for idx in range(len(lines) // 5):
            img_fname = lines[idx * 5].split()[0]
            if img_ext:
                img_fname = img_fname.split(".")[0] + img_ext
            t = np.array(list(map(float, lines[idx * 5 + 1].split())))
            rot = np.array([list(map(float, lines[idx * 5 + k].split())) for k in (2, 3, 4)])
            c2w = self._w2c_to_c2w(rot, t)
            self.poses_dict[img_fname] = self.world_align @ c2w @ self.rays2cam


pose_descriptor_dict = {
    "colmap": ColmapPoseDescriptor,
    "openvslam": OpenVSlamPoseDescriptor,
    "pix4d": Pix4dPoseDescriptor,
}
