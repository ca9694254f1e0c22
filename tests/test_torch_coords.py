"""The port's coordinate systems against the JAX package, on the CPU."""
from math import pi

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords import expgrid as jexp
from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_torch.coords import coords_from_spec
from egonerf_torch.coords import expgrid as texp
from egonerf_torch.coords.yinyang import YinYangSphericalCoords

AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)


@pytest.mark.parametrize("r0,far,n", [(0.05, 8.5, 12), (0.03, 15.0, 150), (0.01, 25.98, 64)])
def test_radial_grids_bit_exact(r0, far, n):
    # the same float32 numpy arithmetic on both sides
    np.testing.assert_array_equal(texp.make_reference_r_grid(r0, far, n),
                                  jexp.make_reference_r_grid(r0, far, n))
    np.testing.assert_array_equal(texp.make_sample_r_grid(r0, far, n),
                                  jexp.make_sample_r_grid(r0, far, n))
    assert texp.exp_ratio(r0, far, n) == jexp.exp_ratio(r0, far, n)


def test_normalize_r_lookup_matches():
    grid = jexp.make_reference_r_grid(0.03, 15.0, 150)
    r = np.random.default_rng(0).uniform(0.0, 16.0, 4096).astype(np.float32)
    r[:4] = [0.0, grid[1], grid[-1], 20.0]  # on the grid and past its end
    got = texp.normalize_r_lookup(torch.from_numpy(r), torch.from_numpy(grid)).numpy()
    want = np.asarray(jexp.normalize_r_lookup(jnp.asarray(r), grid))
    # searchsorted picks the same bracket as the masked reductions; the
    # lerp is the same float32 arithmetic
    np.testing.assert_array_equal(got, want)


def test_normalize_r_exp_matches():
    ratio = jexp.exp_ratio(0.05, 8.5, 12)
    r = np.random.default_rng(1).uniform(0.0, 9.0, 4096).astype(np.float32)
    got = texp.normalize_r_exp(torch.from_numpy(r), 0.05, ratio, 12).numpy()
    want = np.asarray(jexp.normalize_r_exp(jnp.asarray(r), 0.05, ratio, 12))
    # log and pow come from two libraries: float32 ulps of the result
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _points():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(4096, 3)).astype(np.float32)
    pts *= rng.uniform(0.0, 9.0, (4096, 1)).astype(np.float32) / np.linalg.norm(
        pts, axis=-1, keepdims=True)
    # r = 0, and points at the chart boundaries theta = pi/4, 3pi/4 and
    # phi = +-3pi/4 in the yin frame
    special = [[0.0, 0.0, 0.0]]
    for th in (pi / 4, 3 * pi / 4):
        for ph in (-3 * pi / 4, 0.3, 3 * pi / 4):
            for r in (0.5, 4.0):
                special.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                                r * np.cos(th)])
    return np.concatenate([pts, np.asarray(special, np.float32)])


def _boundary_distance(pts):
    """Radians from each point to the nearest yin boundary."""
    r = np.linalg.norm(pts.astype(np.float64), axis=-1)
    th = np.arccos(np.clip(pts[:, 2] / np.maximum(r, 1e-12), -1, 1))
    ph = np.arctan2(pts[:, 1], pts[:, 0])
    return np.minimum(np.minimum(np.abs(th - pi / 4), np.abs(th - 3 * pi / 4)),
                      np.minimum(np.abs(ph + 3 * pi / 4), np.abs(ph - 3 * pi / 4)))


@pytest.mark.parametrize("interval_th", [True, False])
@pytest.mark.parametrize("downsample", [None, 2])
def test_yinyang_chart_matches(interval_th, downsample):
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=interval_th)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05,
                                interval_th=interval_th)
    pts = _points()
    want_c = np.asarray(jc.from_cartesian(jnp.asarray(pts)))
    want_n = np.asarray(jc.normalize_coord(jnp.asarray(want_c), downsample=downsample))
    got_c = tc.from_cartesian(torch.from_numpy(pts))
    got_n = tc.normalize_coord(got_c, downsample=downsample).numpy()
    got_c = got_c.numpy()

    # acos and atan2 differ by ulps between the libraries, so a point within
    # 1e-6 rad of a chart boundary may fall to the other chart; only those
    # may differ
    flip = got_c[:, 3] != want_c[:, 3]
    assert np.all(_boundary_distance(pts[flip]) < 1e-6), pts[flip]
    assert flip.sum() <= 12
    same = ~flip
    np.testing.assert_array_equal(got_c[:, 3], got_n[:, 3])
    np.testing.assert_allclose(got_c[same], want_c[same], rtol=0, atol=2e-6)
    # the radial normalization scales r errors by ~2/(n_r * cell)
    np.testing.assert_allclose(got_n[same], want_n[same], rtol=0, atol=2e-5)
    # r = 0 -> theta = acos(0), phi = atan2(0, 0) = 0: the yin chart
    np.testing.assert_array_equal(got_c[4096], [0.0, np.float32(pi / 2), 0.0, 0.0])


def test_n_to_reso_production():
    tc = YinYangSphericalCoords(AABB, exp_r=True, r0=0.03, interval_th=True)
    assert tc.N_to_reso(27_000_000) == [150, 172, 516]
    jc = JaxYinYang(AABB, exp_r=True, r0=0.03, interval_th=True)
    for n in (24 ** 3, 64_000, 27_000_000):
        assert tc.N_to_reso(n) == jc.N_to_reso(n)


def test_coords_from_spec_round_trip():
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    tc = coords_from_spec(jc.to_spec())
    np.testing.assert_array_equal(tc.aabb, jc.aabb)
    assert tc.resolution == jc.resolution
    assert (tc.exp_r, tc.interval_th, tc.r0) == (jc.exp_r, jc.interval_th, jc.r0)
    assert tc.ratio == jc.ratio
    np.testing.assert_array_equal(tc.ref_grid, jc.ref_grid)
    # every chart of JAX's registry is built now (tests/test_torch_charts.py
    # holds each against JAX's)
    cyl = coords_from_spec({"name": "cylinder", "aabb": AABB.tolist()})
    assert cyl.name == "cylinder" and cyl.resolution is None
