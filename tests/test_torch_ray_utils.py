"""The port's ``data/ray_utils.py`` against the JAX package's: every function
bit for bit on inputs from numpy seeds (both are numpy; the port's is a
copy, so any difference is a transcription fault)."""
import numpy as np
import pytest

from egonerf_torch.data import ray_utils as port
from egonerf_tpu.data import ray_utils as ref


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _c2w(rng):
    from scipy.spatial.transform import Rotation as R

    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R.from_rotvec(rng.normal(size=3)).as_matrix()
    m[:3, 3] = rng.normal(size=3)
    return m


@pytest.mark.parametrize("hw", [(7, 13), (24, 48)])
def test_directions(hw):
    h, w = hw
    rng = np.random.default_rng(h)
    _equal(port.get_ray_directions_360(h, w), ref.get_ray_directions_360(h, w))
    focal = rng.uniform(5, 30, size=2).astype(np.float32)
    center = (rng.uniform(0, w), rng.uniform(0, h))
    for c in (None, center):
        _equal(port.get_ray_directions(h, w, focal, c), ref.get_ray_directions(h, w, focal, c))
        _equal(port.get_ray_directions_blender(h, w, focal, c),
               ref.get_ray_directions_blender(h, w, focal, c))


@pytest.mark.parametrize("roi", [None, (0.0, 1.0, 0.0, 1.0), (0.05, 0.95, 0.0, 1.0),
                                 (0.13, 0.77, 0.21, 0.9)])
def test_get_rays(roi):
    rng = np.random.default_rng(1)
    dirs = port.get_ray_directions_360(30, 60)
    c2w = _c2w(rng)
    _equal(port.get_rays(dirs, c2w, roi), ref.get_rays(dirs, c2w, roi))
    if roi is None:  # the signature the port had before the roi
        _equal(port.get_rays(dirs, c2w), ref.get_rays(dirs, c2w))


def test_ndc():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    for fn in ("ndc_rays_blender", "ndc_rays"):
        args = (12, 16, 20.0, 1.0, o, d)
        _equal(getattr(port, fn)(*args), getattr(ref, fn)(*args))
    rays = rng.normal(size=(4, 9, 6)).astype(np.float32)
    _equal(port.ndc_bbox(rays), ref.ndc_bbox(rays))


def test_slab_depth_and_marcher():
    rng = np.random.default_rng(3)
    o = rng.normal(size=(40, 3)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    aabb = np.array([[-1.5, -1.0, -2.0], [1.0, 2.0, 1.5]], np.float32)
    _equal(port.aabb_intersect(o, d, aabb), ref.aabb_intersect(o, d, aabb))
    z = np.sort(rng.uniform(0, 5, size=(40, 16)).astype(np.float32), -1)
    cos = rng.uniform(0.5, 1, size=40).astype(np.float32)
    _equal(port.depth2dist(z, cos), ref.depth2dist(z, cos))
    rays = np.concatenate([o, d, np.full((40, 1), 0.1, np.float32),
                           np.full((40, 1), 4.0, np.float32)], -1)
    for kw in (dict(), dict(lindisp=True), dict(bbox_3d=aabb)):
        _equal(port.ray_marcher(rays, 12, **kw), ref.ray_marcher(rays, 12, **kw))
    got = port.ray_marcher(rays, 12, perturb=1.0, rng=np.random.default_rng(9))
    want = ref.ray_marcher(rays, 12, perturb=1.0, rng=np.random.default_rng(9))
    _equal(got, want)


def test_llff_pose_helpers():
    rng = np.random.default_rng(4)
    poses = np.stack([_c2w(rng)[:3] for _ in range(9)]).astype(np.float64)
    near_fars = rng.uniform(1, 10, size=(9, 2))
    _equal(port.normalize(poses[0, :, 0]), ref.normalize(poses[0, :, 0]))
    _equal(port.average_poses(poses), ref.average_poses(poses))
    b2o = np.diag([1.0, -1.0, -1.0, 1.0])
    _equal(port.center_poses(poses, b2o), ref.center_poses(poses, b2o))
    _equal(port.viewmatrix(poses[0, :, 2], poses[0, :, 1], poses[0, :, 3]),
           ref.viewmatrix(poses[0, :, 2], poses[0, :, 1], poses[0, :, 3]))
    c2w = ref.average_poses(poses)
    _equal(port.render_path_spiral(c2w, poses[0, :, 1], [0.3, 0.2, 0.1], 4.0, n=10),
           ref.render_path_spiral(c2w, poses[0, :, 1], [0.3, 0.2, 0.1], 4.0, n=10))
    _equal(port.get_spiral(poses, near_fars, n_views=17), ref.get_spiral(poses, near_fars,
                                                                       n_views=17))


@pytest.mark.parametrize("color,scale", [(True, -1.0), (False, 2.5)])
def test_read_pfm(tmp_path, color, scale):
    rng = np.random.default_rng(5)
    shape = (6, 5, 3) if color else (6, 5)
    data = rng.normal(size=shape).astype("<f4" if scale < 0 else ">f4")
    path = tmp_path / "x.pfm"
    with open(path, "wb") as f:
        f.write((b"PF\n" if color else b"Pf\n") + b"5 6\n" + f"{scale}\n".encode())
        f.write(np.flipud(data).tobytes())
    got, want = port.read_pfm(path), ref.read_pfm(path)
    _equal(got[0], want[0])
    assert got[1] == want[1] == abs(scale)
