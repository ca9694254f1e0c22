"""The port's loaders and pose readers against the JAX package's, on fixture
scenes in each real on-disk layout (built as ``tests/test_loaders.py``
builds them, images written by PIL): OmniBlender with and without a
fractional roi, the egocentric loader under COLMAP, OpenVSLAM and Pix4D
poses, OmniScenes with ``.jpg`` frames, and LLFF.  Every output is held
equal bit for bit: the rays, colours, poses, bbox and sizes, for the train
split and the stacked test split, at downsample 1 (full-size frames) and
at the tiny downsample of JAX's tests, also where both sides resize
through PIL."""
import json

import numpy as np
import pytest
from PIL import Image

from egonerf_torch.data import datasets as port
from egonerf_torch.data import pose_descriptor as port_pd
from egonerf_tpu.data import datasets as ref
from egonerf_tpu.data import pose_descriptor as ref_pd

FIELDS = ("all_rays", "all_rgbs", "poses", "scene_bbox", "img_wh", "img_wh_origin",
          "near_far", "roi", "white_bg")


def _img(path, w, h, seed):
    """A smooth gradient with noise: PIL's per-row filter choice then mixes
    all five filter types."""
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h), 2 * np.arange(w))[..., None] * np.array([1, 2, 3])
    arr = ((base + rng.integers(0, 40, (h, w, 3))) % 256).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _same(got, want, fields=FIELDS):
    for name in fields:
        a, b = getattr(got, name, None), getattr(want, name, None)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def _both(cls_name, **kw):
    """(port, JAX) datasets of one class for the train split and the
    stacked test split."""
    out = []
    for split, stack in (("train", False), ("test", True)):
        args = dict(kw, split=split, is_stack=stack)
        out.append((getattr(port, cls_name)(**args), getattr(ref, cls_name)(**args)))
    return out


# -- OmniBlender ---------------------------------------------------------------
def _omniblender(root, w, h, n=4):
    (root / "images").mkdir(parents=True)
    frames = []
    names = [f"cam_{i:03d}.png" for i in range(n)]
    for i, name in enumerate(names):
        _img(root / "images" / name, w, h, seed=i)
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0.0, 0.05 * i]
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    (root / "transform.json").write_text(json.dumps({"indoor": True, "frames": frames}))
    (root / "train.txt").write_text("\n".join(n.split(".")[0] for n in names[:-1]))
    (root / "test.txt").write_text(names[-1].split(".")[0])
    return str(root)


@pytest.mark.parametrize("roi", [None, [0.0, 0.8, 0.0, 1.0], [0.13, 0.77, 0.21, 0.9]])
@pytest.mark.parametrize("size,downsample", [((20, 10), 100.0), ((40, 20), 100.0)],
                         ids=["tiny", "resized"])
def test_omniblender(tmp_path, roi, size, downsample):
    root = _omniblender(tmp_path / "scene", *size)
    kw = dict(data_dir=root, downsample=downsample, near_far=[0.1, 5.0])
    if roi is not None:
        kw["roi"] = roi
    for got, want in _both("OmniBlenderDataset", **kw):
        _same(got, want)
        assert got.indoor == want.indoor


def test_omniblender_full_size(tmp_path):
    root = _omniblender(tmp_path / "scene", 2000, 1000, n=3)
    for got, want in _both("OmniBlenderDataset", data_dir=root, downsample=1.0,
                           near_far=[0.1, 5.0], roi=[0.05, 0.95, 0.0, 1.0]):
        _same(got, want)


# -- egocentric: COLMAP, OpenVSLAM, Pix4D -------------------------------------
def _egocentric(root, w, h, n=3):
    from scipy.spatial.transform import Rotation as R

    (root / "imgs").mkdir(parents=True)
    names = [f"f{i:04d}" for i in range(n)]
    rng = np.random.default_rng(11)
    colmap, vslam = ["# c1", "# c2", "# c3", "# c4"], []
    pix4d = ["# p1", "# p2", "# p3"]
    for i, name in enumerate(names):
        _img(root / "imgs" / f"{name}.png", w, h, seed=i)
        q = R.from_rotvec(rng.normal(scale=0.3, size=3)).as_quat()  # xyzw
        t = rng.normal(size=3)
        colmap += [f"{i + 1} {q[3]} {q[0]} {q[1]} {q[2]} {t[0]} {t[1]} {t[2]} 1 {name}.jpg",
                   "0 0 -1"]
        vslam.append(f"{t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]} 0 {name}.jpg")
        rot = R.from_quat(q).as_matrix()
        pix4d += [f"{name}.jpg {w} {h}", " ".join(map(str, t))]
        pix4d += [" ".join(map(str, row)) for row in rot]
    for sub, lines in ((("output_dir", "colmap", "images.txt"), colmap),
                       (("openvslam", "frame_trajectory_with_file_name.txt"), vslam),
                       (("pix4d", "calibrated_camera_parameters.txt"), pix4d)):
        path = root.joinpath(*sub)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines) + "\n")
    (root / "train.txt").write_text("\n".join(names[:-1]))
    (root / "test.txt").write_text(names[-1])
    return str(root)


@pytest.mark.parametrize("method", ["colmap", "openvslam", "pix4d"])
@pytest.mark.parametrize("roi", [None, [0.05, 0.95, 0.0, 1.0], [0.13, 0.77, 0.21, 0.9]])
def test_egocentric(tmp_path, method, roi):
    root = _egocentric(tmp_path / "rico", 1920 // 96, 960 // 96)
    kw = dict(data_dir=root, downsample=96.0, near_far=[0.1, 10.0], localization_method=method)
    if roi is not None:
        kw["roi"] = roi
    for got, want in _both("EgocentricVideoDataset", **kw):
        _same(got, want)
        assert got.pose_descriptor.poses_dict.keys() == want.pose_descriptor.poses_dict.keys()
        for k, v in want.pose_descriptor.poses_dict.items():
            np.testing.assert_array_equal(got.pose_descriptor.poses_dict[k], v)


def test_egocentric_resized_and_full_size(tmp_path):
    root = _egocentric(tmp_path / "small", 40, 20)  # PIL resizes to 20x10 on both sides
    for got, want in _both("EgocentricVideoDataset", data_dir=root, downsample=96.0,
                           near_far=[0.1, 10.0], roi=[0.05, 0.95, 0.0, 1.0]):
        _same(got, want)
    root = _egocentric(tmp_path / "full", 1920, 960)
    for got, want in _both("EgocentricVideoDataset", data_dir=root, downsample=1.0,
                           near_far=[0.1, 10.0], roi=[0.05, 0.95, 0.0, 1.0],
                           localization_method="openvslam"):
        _same(got, want)


# -- OmniScenes ------------------------------------------------------------------
def _omniscenes(base, w, h, n):
    room = "room1"
    (base / "turtlebot_pano" / room).mkdir(parents=True)
    (base / "turtlebot_pose" / room).mkdir(parents=True)
    for i in range(n):
        _img(base / "turtlebot_pano" / room / f"pano{i}.jpg", w, h, seed=i)
        pose = np.hstack([np.eye(3), [[0.01 * i], [0.0], [0.02 * i]]])
        np.savetxt(base / "turtlebot_pose" / room / f"pose{i}.txt", pose)
    (base / "turtlebot_pano" / room / ".DS_Store").write_text("x")
    return str(base / room)


@pytest.mark.parametrize("size,downsample,n", [((20, 10), 96.0, 33), ((1920, 960), 1.0, 3)],
                         ids=["tiny", "full"])
def test_omniscenes(tmp_path, size, downsample, n):
    root = _omniscenes(tmp_path, *size, n)
    for got, want in _both("OmniscenesDataset", data_dir=root, downsample=downsample,
                           near_far=[0.1, 10.0]):
        _same(got, want)


# -- LLFF --------------------------------------------------------------------
def _llff(root, n=10):
    (root / "images").mkdir(parents=True)
    (root / "images_2").mkdir()
    h, w, focal = 12.0, 16.0, 20.0
    poses_bounds = np.zeros((n, 17))
    rng = np.random.default_rng(5)
    for i in range(n):
        m = np.eye(4)[:3]
        m[:3, 3] = [0.05 * i, 0.02 * i, rng.normal(scale=0.01)]
        pose = np.concatenate([m, np.array([[h], [w], [focal]])], axis=1)
        poses_bounds[i, :15] = pose.reshape(-1)
        poses_bounds[i, 15:] = [1.0 + 0.1 * i, 10.0 - 0.2 * i]
        _img(root / "images" / f"img_{i:03d}.png", int(w), int(h), seed=i)
        _img(root / "images_2" / f"img_{i:03d}.png", int(w) // 2, int(h) // 2, seed=i)
    np.save(root / "poses_bounds.npy", poses_bounds)
    return str(root)


@pytest.mark.parametrize("downsample", [1.0, 2.0])
def test_llff(tmp_path, downsample):
    root = _llff(tmp_path / "fern")
    for got, want in _both("LLFFDataset", data_dir=root, near_far=[1.0, 10.0],
                           downsample=downsample):
        _same(got, want, FIELDS + ("render_path", "near_fars", "focal", "pose_avg"))


def test_registry_holds_the_five_loaders():
    assert sorted(port.dataset_dict) == sorted(ref.dataset_dict)
    for name, cls in port.dataset_dict.items():
        assert cls.__name__ == ref.dataset_dict[name].__name__
    with pytest.raises(ValueError, match="unknown dataset"):
        port.dataset_class("blender")


def test_colmap_zero_observation_images(tmp_path):
    """An EMPTY points2D line (a registered image with no observations)
    keeps the image/points2D alternation, as in JAX
    (tests/test_loaders.py:163)."""
    body = ("1 0.99 0.01 0.02 0.03 0.1 0.2 0.3 1 img_a.png\n"
            "\n"
            "2 0.98 0.02 0.03 0.04 0.4 0.5 0.6 1 img_b.png\n"
            "100.5 200.3 17 300.1 400.2 18\n"
            "3 0.97 0.03 0.04 0.05 0.7 0.8 0.9 1 img_c.png\n"
            "1.0 2.0 3\n")
    sub = tmp_path / "output_dir" / "colmap"
    sub.mkdir(parents=True)
    (sub / "images.txt").write_text("# h\n# h\n# h\n# h\n" + body)
    got, want = port_pd.ColmapPoseDescriptor(), ref_pd.ColmapPoseDescriptor()
    for pd in (got, want):
        pd.read_pose_file(str(tmp_path))
        pd.normalize_pose()
    assert sorted(got.poses_dict) == ["img_a.png", "img_b.png", "img_c.png"]
    for k, v in want.poses_dict.items():
        np.testing.assert_array_equal(got.poses_dict[k], v)
