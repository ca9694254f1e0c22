"""K7s with the in-box mask on the CPU: ``generic_sphere``'s chart under
``interval_th`` and the TensoRF samplers' ``in_box`` of the same points,
the plain version (the path CPU tensors take) against eager JAX's
``sample_ray`` and ``sample_ray_exp``; the radial bucket table the kernel
starts its cell search from, against ``searchsorted`` over seeded and
generated grids; and the TensoRF forward, filter and step on the chart,
which take the mask from K7s and form no points of their own.  Inputs come
from numpy seeds and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from egonerf_tpu.models.alphamask import AlphaGridMask as JaxMask
from egonerf_torch import ops
from egonerf_torch.coords.expgrid import make_reference_r_grid
from egonerf_torch.models.alphamask import AlphaGridMask
from egonerf_torch.ops import chart

from test_torch_charts import ATOL, _tensorf_pair

LOOKUP = dict(exp_r=True, interval_th=True)
N_SAMPLES = 24
KINDS = ("inside", "outside", "away", "face")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _tensorf_pair("generic_sphere", LOOKUP)


def _kind_rays(kind, near, n=96, seed=0):
    """(origins, unit directions) float32 of one kind about the [-1.5, 1.5]^3
    box: from inside it; from 2.7-6 away heading at it; from as far out
    heading away; or axis-aligned from a face's plane less ``near``, so the
    sample at depth ``near`` (the first of either sampler) lies exactly on
    that face, the other two coordinates inside the box, on its edges or an
    ulp outside."""
    rng = np.random.default_rng(seed + KINDS.index(kind))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if kind == "inside":
        o = rng.uniform(-1.4, 1.4, (n, 3))
    elif kind == "outside":
        o = -d * rng.uniform(2.7, 6.0, (n, 1)) + rng.uniform(-0.3, 0.3, (n, 3))
    elif kind == "away":
        o = d * rng.uniform(2.7, 6.0, (n, 1))
    else:
        axis = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        edge = np.float32(1.5)
        o = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
        pick = rng.integers(0, 4, (n, 3))
        o = np.where(pick == 1, edge, np.where(pick == 2, -edge, o))
        o = np.where(pick == 3, np.nextafter(edge, np.float32(2)), o)
        d = np.zeros((n, 3), np.float32)
        d[np.arange(n), axis] = sign
        o[np.arange(n), axis] = -sign * (edge + np.float32(near))
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("sampler", ["sample_ray", "sample_ray_exp"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_k7s_mask_matches_jax_samplers(pair, kind, sampler):
    """K7s's plain version with the aabb on eager JAX's depths: the mask
    bit for bit with JAX's ``in_box`` of its own points (eager, so the
    product and the sum round apart, as torch's and the kernel's do); the
    coords within the chart maps' 2e-6 of JAX's chart of those points, the
    flag column 0; the wrapper on CPU tensors gives the same."""
    jm, _, tm = pair
    o, d = _kind_rays(kind, tm.near_far[0])
    pts, z, in_box = getattr(jm, sampler)(jnp.asarray(o), jnp.asarray(d), None, N_SAMPLES)
    want_mask = np.asarray(in_box).reshape(-1)
    want = np.asarray(jm.coordinates.normalize_coord(jm.coordinates.from_cartesian(pts)))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(np.array(z)),
            tm.coordinates)
    norm, mask = ops.PLAIN.chart_sphere(*args, tm.aabb)
    assert mask.dtype == torch.bool and mask.shape == (o.shape[0] * N_SAMPLES,)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_allclose(norm[:, :3].numpy(), want.reshape(-1, 3), rtol=0, atol=ATOL)
    assert not norm[:, 3].any()
    if kind == "face":
        # the first sample of every ray lies on a face: in the box exactly
        # where its other two coordinates are
        first = np.asarray(pts)[:, 0]
        assert np.all(np.abs(first).max(-1) >= 1.5)
        assert want_mask.reshape(-1, N_SAMPLES)[:, 0].any()
        assert not want_mask.reshape(-1, N_SAMPLES)[:, 0].all()
    elif kind == "away":
        assert not want_mask.any()
    else:
        assert 0 < want_mask.mean() < 1
    got = chart.chart_sphere_fwd(*args, aabb=torch.from_numpy(tm.aabb))
    assert all(torch.equal(g, w) for g, w in zip(got, (norm, mask)))
    assert torch.equal(chart.chart_sphere_fwd(*args), norm)


def test_chart_sphere_fwd_refuses_a_bad_aabb(pair):
    _, _, tm = pair
    o, d = _kind_rays("inside", tm.near_far[0], n=4)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.ones(4, 3), tm.coordinates)
    with pytest.raises(ValueError, match="aabb"):
        chart.chart_sphere_fwd(*args, aabb=torch.zeros(6))


# ---------------------------------------------------------------------------
# the radial bucket table
# ---------------------------------------------------------------------------
def _bucket(r, table):
    """K7s's bucket of each float32 radius: the float32 product with
    inv_w, truncated (a NaN to 0, as the card converts it), clamped."""
    q = np.asarray(r, np.float32) * np.float32(table.inv_w)
    with np.errstate(invalid="ignore"):
        b = np.where(np.isnan(q), 0.0, np.minimum(np.trunc(q), len(table.start) - 1))
    return b.astype(np.int64)


def _binary_search(grid, r):
    """The index the binary search of K7 and K4 (and of K7s before its
    bucket table) ends on: the first entry not <= r (0 for a NaN)."""
    lo, hi = 0, len(grid)
    while lo < hi:
        mid = (lo + hi) // 2
        if grid[mid] <= r:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _walk(grid, start, r):
    """K7s's walk: up from ``start`` while the entry is <= r; the NaN after
    the last entry stops it.  Returns (index, steps)."""
    i = start
    while i < len(grid) and grid[i] <= r:
        i += 1
    return i, i - start


def _edge_radii(grid, rng):
    up, down = np.float32(np.inf), np.float32(0)
    return np.concatenate([
        grid, np.nextafter(grid, up), np.nextafter(grid[1:], down),
        np.float32([0.0, np.inf, np.nan, 2 * grid[-1], 1e30, np.finfo(np.float32).tiny]),
        rng.uniform(0, 1.2 * grid[-1], 512).astype(np.float32)]).astype(np.float32)


def _check_table(grid, rng):
    table = chart.radial_buckets(grid)
    assert table.start.dtype == np.int32 and 1 <= len(table.start) <= chart.MAX_BUCKETS
    assert table.start[0] == 0 and np.all(np.diff(table.start) >= 0)
    for r in _edge_radii(grid, rng):
        start = int(table.start[_bucket(r, table)])
        want = _binary_search(grid, r)
        if not np.isnan(r):
            assert want == np.searchsorted(grid, r, side="right")
        got, steps = _walk(grid, start, r)
        assert start <= want and got == want and steps <= table.walk, (r, start, want)
    return table


@pytest.mark.parametrize("r0, far, n_r", [(0.03, 1.7320508, 128), (0.05, 2.598076, 64),
                                          (0.03, 4.5, 128), (0.05, 8.5, 256)])
def test_radial_buckets_on_the_configs_grids(r0, far, n_r):
    """The bucket table of grids at the configs' r0, the cube's and the
    smoke scene's reach and n_r: every grid entry, an ulp either side, 0,
    inf, NaN and past the last entry start at or below searchsorted(right)
    and walk onto it (a NaN onto 0, as the binary search ends) within the
    table's bound, one step on these grids."""
    table = _check_table(make_reference_r_grid(r0, far, n_r), np.random.default_rng(n_r))
    assert table.walk == 1


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(r0=st.floats(0.001, 0.4), far=st.floats(0.5, 80.0), n_r=st.integers(2, 700))
def test_radial_buckets_hold_on_any_reference_grid(r0, far, n_r):
    """The same over grids from ``make_reference_r_grid`` at generated r0,
    far and n_r (the tables capped at MAX_BUCKETS there walk further; the
    bound is the table's own)."""
    grid = make_reference_r_grid(r0, far, n_r)
    if not np.all(np.diff(grid) > 0):
        with pytest.raises(ValueError):
            chart.radial_buckets(grid)
        return
    table = _check_table(grid, np.random.default_rng(n_r))
    assert table.walk <= len(grid)


def test_radial_buckets_refuse_grids_they_cannot_bound():
    for grid in ([0.0], [0.1, 0.2, 0.3], [0.0, 0.2, 0.2, 0.3], [0.0, 0.3, 0.2]):
        with pytest.raises(ValueError):
            chart.radial_buckets(np.float32(grid))


# ---------------------------------------------------------------------------
# the TensoRF paths on the chart
# ---------------------------------------------------------------------------
class _NoPoints:
    """The K7s path's guard: the samplers' points and ``in_box`` must not
    run; the chart records its calls."""

    def __init__(self, tm, monkeypatch):
        self.calls = []
        for name in ("_points", "_in_box"):
            monkeypatch.setattr(tm, name, self._refuse(name))

        def sphere(*args):
            self.calls.append((args[2].shape, len(args) == 5))
            return ops.PLAIN.chart_sphere(*args)
        tm.ops = ops.KERNELS._replace(chart_sphere=sphere)

    @staticmethod
    def _refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} ran on the K7s path")
        return fn


@pytest.mark.parametrize("exp", [False, True], ids=["uniform", "exp"])
def test_forward_with_a_mask_on_generic_sphere_matches_jax(exp, monkeypatch):
    """TensorVMSplit.forward at key=None on generic_sphere under
    interval_th with a 16^3 mask of about half occupancy, against JAX's:
    rgb abs 1e-5, depth abs 1e-4 (as the xyz chart's eval test); the
    in-box mask from K7s's one call a chunk, no point formed in torch."""
    jm, jp, tm = _tensorf_pair("generic_sphere", LOOKUP)
    vol = (np.random.default_rng(7).uniform(size=(16, 16, 16)) > 0.5).astype(np.float32)
    jm.alpha_mask, tm.alpha_mask = JaxMask(vol), AlphaGridMask(vol)
    guard = _NoPoints(tm, monkeypatch)
    rng = np.random.default_rng(8)
    rays = np.concatenate(_kind_rays("inside", 0.5, n=48, seed=8), -1)
    rays[:24, :3] = np.concatenate(_kind_rays("outside", 0.5, n=24, seed=9), -1)[:, :3] * 0.5
    rays[:, :3] += rng.uniform(-0.05, 0.05, (48, 3)).astype(np.float32)
    want = jax.jit(lambda p, r: jm.forward(p, r, n_coarse=40, exp_sampling=exp))(
        jp, jnp.asarray(rays))
    with torch.no_grad():
        params = tm.params()
        got = tm.forward(params, torch.from_numpy(rays), n_coarse=40, exp_sampling=exp,
                         tables=tm.lookup_tables(params))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)
    assert guard.calls == [((48, 40), True)]


def test_filter_on_generic_sphere_matches_jax(monkeypatch):
    """``filtering_rays`` with a mask on generic_sphere under interval_th:
    the kept rays JAX's, the coords from K7s alone (no mask asked, no
    point formed in torch)."""
    jm, jp, tm = _tensorf_pair("generic_sphere", LOOKUP)
    vol = np.zeros((16, 16, 16), np.float32)
    vol[3:9, 5:12, 2:7] = 1.0
    jm.alpha_mask, tm.alpha_mask = JaxMask(vol), AlphaGridMask(vol)
    guard = _NoPoints(tm, monkeypatch)
    rays = np.concatenate([np.concatenate(_kind_rays(k, 0.5, n=32, seed=3), -1)
                           for k in KINDS]).astype(np.float32)
    rgbs = np.random.default_rng(4).uniform(size=(rays.shape[0], 3)).astype(np.float32)
    want = jm.filtering_rays(jp, rays, rgbs, n_samples=48, chunk=64)
    got = tm.filtering_rays(tm.params(), rays, rgbs, n_samples=48, chunk=64)
    assert 0 < len(want[0]) < len(rays)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert guard.calls == [((64, 48), False)] * 2
