"""K4 with its fine-chart epilogue (``ops.pdf.resample_chart``) and the
properties its kernel rests on, on the CPU: the plain version against the
JAX forward's composition, the fine draws' order on hard cdfs, the merge's
ties, and the wrapper taking the plain version for CPU tensors."""
from math import pi

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.egonerf import feature2density as jax_feature2density
from egonerf_tpu.ops import merge as jmerge
from egonerf_tpu.ops import pdf as jpdf
from egonerf_tpu.ops import volrend as jvol
from egonerf_torch import ops
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.models.egonerf import _dists
from egonerf_torch.ops import chart, pdf

AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
NEAR, FAR = 0.05, 8.5
R, S, F = 48, 16, 16
ACT = (-8.0, 25.0, "softplus")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _exp_depths(n_rays, n, near=NEAR, far=FAR):
    """Sorted coarse depths spaced as the exponential sampler spaces them
    (each interval a constant ratio times the last), from ``near``."""
    ratio = 1.0 + (pi / 2.0) / n
    r0 = (far - near) * (ratio - 1.0) / (ratio ** n - 1.0)
    steps = r0 * ratio ** np.arange(n)
    z = near + np.concatenate([[0.0], np.cumsum(steps)[:-1]])
    return np.broadcast_to(z.astype(np.float32), (n_rays, n)).copy()


def _rays(rng, n):
    """Origins off the chart centre (so the angles move along a ray) and
    unit directions."""
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _boundary_distance(pts):
    """Radians from each point to the nearest yin boundary."""
    r = np.linalg.norm(pts.astype(np.float64), axis=-1)
    th = np.arccos(np.clip(pts[:, 2] / np.maximum(r, 1e-12), -1, 1))
    ph = np.arctan2(pts[:, 1], pts[:, 0])
    return np.minimum(np.minimum(np.abs(th - pi / 4), np.abs(th - 3 * pi / 4)),
                      np.minimum(np.abs(ph + 3 * pi / 4), np.abs(ph - 3 * pi / 4)))


def _jax_fused(feat, z, d, o, dirs, jc, u_key, use_coarse_sample):
    """The JAX forward's resampling and fine chart
    (egonerf_tpu/models/egonerf.py:389-406): sample_pdf with sorted draws,
    merge_sorted, from_cartesian and normalize_coord."""
    cfg = JaxFieldConfig()
    sigma = jax_feature2density(jnp.asarray(feat), cfg)
    _, cw, _ = jvol.raw2alpha(sigma, jnp.asarray(d) * cfg.distance_scale)
    zj = jnp.asarray(z)
    fine = jpdf.sample_pdf(0.5 * (zj[:, 1:] + zj[:, :-1]), cw[:, 1:-1], F, key=u_key,
                           sorted_draws=True)
    z_vals = jmerge.merge_sorted(zj, fine) if use_coarse_sample else fine
    xyz = jnp.asarray(o)[:, None, :] + jnp.asarray(dirs)[:, None, :] * z_vals[..., None]
    norm = jc.normalize_coord(jc.from_cartesian(xyz))
    return np.asarray(z_vals), np.asarray(norm).reshape(-1, 4), np.asarray(xyz).reshape(-1, 3)


@pytest.mark.parametrize("use_coarse_sample", [True, False])
@pytest.mark.parametrize("interval_th", [True, False])
@pytest.mark.parametrize("draws", ["linspace", "sorted"])
def test_resample_chart_matches_jax_composition(interval_th, use_coarse_sample, draws):
    """The fused op's plain version (the ``Ops`` entry on CPU tensors)
    against JAX's composition.  Depths: cumsum and cumprod in another
    association, float32 ulps (rtol 1e-5).  Coords: the angles and r of
    points whose depths differ by those ulps, and acos/atan2 from two
    libraries: 2e-5 (tests/test_torch_coords.py's bound for the radial
    normalization's scaling of r's ulps); a point within 1e-5 rad of a
    chart boundary may take the other chart, and only those may differ."""
    rng = np.random.default_rng(7)
    z = _exp_depths(R, S)
    d = np.asarray(_dists(_t(z)))
    # moderate densities: every interior bin keeps a mass well above the
    # 1e-5 floor, so no draw sits at the reference's denom-guard jump
    feat = rng.normal(4.0, 0.5, (R, S)).astype(np.float32)
    o, dirs = _rays(rng, R)
    key = None if draws == "linspace" else jax.random.PRNGKey(3)
    u = None if key is None else _t(jmerge.sorted_uniform(key, (R, F)))
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=interval_th)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05,
                                interval_th=interval_th)
    want_z, want_c, xyz = _jax_fused(feat, z, d, o, dirs, jc, key, use_coarse_sample)
    got_z, got_d, got_c = ops.KERNELS.resample_chart(_t(feat), _t(z), _t(d), F, u,
                                                     use_coarse_sample, *ACT, _t(o), _t(dirs),
                                                     tc)
    n_out = S + F if use_coarse_sample else F
    assert got_z.shape == got_d.shape == (R, n_out) and got_c.shape == (R * n_out, 4)
    np.testing.assert_allclose(got_z.numpy(), want_z, rtol=1e-5, atol=1e-6)
    got_c = got_c.numpy()
    flip = got_c[:, 3] != want_c[:, 3]
    assert np.all(_boundary_distance(xyz[flip]) < 1e-5)
    np.testing.assert_allclose(got_c[~flip], want_c[~flip], rtol=0, atol=2e-5)
    # the same as the unfused plain versions, bit for bit
    pz, pd = pdf.resample_plain(_t(feat), _t(z), _t(d), F, u, use_coarse_sample, *ACT)
    assert torch.equal(got_z, pz) and torch.equal(got_d, pd)
    assert torch.equal(_t(got_c), chart.chart_fwd_plain(_t(o), _t(dirs), pz, tc))


def _hard_cases(rng):
    """(label, c_feat, u) on the exponential depths: an all-zero density
    (the 1e-5 floor alone, near-degenerate brackets), a single spike, u on
    the cdf's own entries, and u at and past cdf[-1]."""
    zero = np.full((R, S), -1e4, np.float32)  # softplus(-1e4 - 8) is 0
    spike = zero.copy()
    spike[np.arange(R), rng.integers(1, S - 1, R)] = 30.0
    mixed = rng.normal(2.0, 3.0, (R, S)).astype(np.float32)
    z = _exp_depths(R, S)
    d = np.asarray(_dists(_t(z)))
    cdf = pdf._warp_cdf(pdf._warp_weights(ops.volrend.raw2alpha(
        ops.volrend.density_activation(_t(mixed), ACT[0], ACT[2]),
        _t(d) * ACT[1])[0])[:, 1:-1])
    on_edges = cdf[:, (np.arange(F) * (S - 2)) // (F - 1)].contiguous()
    near_one = (1.0 - torch.arange(F - 1, -1, -1, dtype=torch.float32) * 2.0 ** -24)
    past_end = torch.linspace(0.999, 1.0, F).clamp_min(cdf[:, -1:].max())
    return z, d, [("zero density", zero, None), ("one spike", spike, None),
                  ("u on the cdf's edges", mixed, on_edges),
                  ("u near 1", mixed, near_one.expand(R, F).contiguous()),
                  ("u past cdf[-1]", mixed, past_end.expand(R, F).contiguous())]


@pytest.mark.parametrize("case", range(5))
def test_plain_fine_draws_are_non_decreasing(case):
    """On the sampler's depths (each bin edge above half the next, so the
    bracket's end rounds back onto its edge, resample.cu's note) and
    sorted u, the fine draws are non-decreasing on hard cdfs: the merge
    path of K4 rests on it.  The merged depths equal torch.sort of the
    concatenation."""
    z, d, cases = _hard_cases(np.random.default_rng(case))
    label, feat, u = cases[case]
    fine, _ = pdf.resample_plain(_t(feat), _t(z), _t(d), F, u, False, *ACT)
    assert (fine[:, 1:] >= fine[:, :-1]).all(), label
    merged, _ = pdf.resample_plain(_t(feat), _t(z), _t(d), F, u, True, *ACT)
    assert torch.equal(merged, torch.sort(torch.cat([_t(z), fine], -1), -1).values)


def test_bracket_end_passes_its_edge_only_below_half():
    """resample.cu's note, in float32: b_lo + (b_hi - b_lo) gives b_hi
    exactly where b_lo >= b_hi / 2 (Sterbenz: the difference is exact),
    but may pass b_hi by an ulp where b_lo < b_hi / 2; so a draw at t = 1
    can step past the next bracket's first draw, and K4 votes on the
    order of each ray's draws."""
    rng = np.random.default_rng(0)
    b_hi = torch.from_numpy(rng.uniform(0.05, 9.0, 200_000).astype(np.float32))
    frac = torch.from_numpy(rng.uniform(0.0, 1.0, 200_000).astype(np.float32))
    b_lo = b_hi * frac
    end = b_lo + (b_hi - b_lo)
    half = b_lo >= b_hi / 2
    assert torch.equal(end[half], b_hi[half])
    assert (end[~half] > b_hi[~half]).any()
    assert (end[~half] - b_hi[~half]).abs().max() <= torch.finfo(torch.float32).eps * 9.0


def test_merge_ties_with_repeated_coarse_depths_match_jax():
    """Every coarse depth twice and no density: the bin edges equal coarse
    depths, draws at t = 0 land on them, and the merged depths hold
    coarse/fine ties.  The plain merge equals JAX's bitonic merge_sorted of
    the same draws bit for bit, and torch.sort of the concatenation."""
    z = np.repeat(_exp_depths(R, S // 2), 2, axis=1)
    d = np.asarray(_dists(_t(z)))
    feat = np.full((R, S), -1e4, np.float32)  # softplus(-1e4 - 8) is 0
    # u on the uniform cdf's entries: every draw at t = 0, on a bin edge
    u = np.broadcast_to(np.arange(F, dtype=np.float32) / np.float32(S - 2), (R, F)).copy()
    got, _ = pdf.resample_plain(_t(feat), _t(z), _t(d), F, _t(u), True, *ACT)
    fine, _ = pdf.resample_plain(_t(feat), _t(z), _t(d), F, _t(u), False, *ACT)
    want = np.asarray(jmerge.merge_sorted(jnp.asarray(z), jnp.asarray(fine.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, torch.sort(torch.cat([_t(z), fine], -1), -1).values)
    ties = (got[:, 1:] == got[:, :-1]).sum()
    assert ties >= R * S // 2  # the repeated coarse depths and the draws on them


def test_cpu_tensors_take_the_plain_fused_op():
    """``device="cpu"``: the wrapper gives CPU tensors the plain version of
    the fused op, launches nothing, and ``Ops`` carries it in both
    registries."""
    assert ops.KERNELS.resample_chart is pdf.resample_chart
    assert ops.PLAIN.resample_chart is pdf.resample_chart_plain
    rng = np.random.default_rng(1)
    z = _exp_depths(R, S)
    d = np.asarray(_dists(_t(z)))
    feat = rng.normal(2.0, 3.0, (R, S)).astype(np.float32)
    o, dirs = _rays(rng, R)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    before = (pdf.resample.launches, chart.chart_fwd.launches)
    rays = _t(np.concatenate([o, dirs], -1))
    got = pdf.resample_chart(_t(feat), _t(z), _t(d), F, None, True, *ACT, rays[:, :3],
                             rays[:, 3:6], tc)
    want = pdf.resample_chart_plain(_t(feat), _t(z), _t(d), F, None, True, *ACT, _t(o),
                                    _t(dirs), tc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (pdf.resample.launches, chart.chart_fwd.launches) == before


def _fused(**over):
    args = dict(c_feat=torch.zeros(8, 16), coarse_z=torch.zeros(8, 16),
                coarse_dists=torch.zeros(8, 16), n_fine=16, rays_o=torch.zeros(8, 3),
                viewdirs=torch.ones(8, 3),
                coords=YinYangSphericalCoords(AABB, exp_r=True, N_voxel=12 ** 3, r0=0.05,
                                              interval_th=True))
    args.update(over)
    return pdf.resample_chart(**args)


@pytest.mark.parametrize("case", ["not yin-yang", "rays rows", "rays (R, 4)", "too many samples",
                                  "activation"])
def test_fused_op_rejects_bad_arguments(case):
    """The shapes the kernel cannot take raise, on any device: a block's
    shared memory holds 4 warps x (3S - 1 + F + T) floats and the radial
    grid, at most 227 KB."""
    big = 5000
    call, error = {
        "not yin-yang": (lambda: _fused(coords=object()), TypeError),
        "rays rows": (lambda: _fused(rays_o=torch.zeros(7, 3)), ValueError),
        "rays (R, 4)": (lambda: _fused(viewdirs=torch.ones(8, 4)), ValueError),
        "too many samples": (lambda: _fused(c_feat=torch.zeros(1, big),
                                            coarse_z=torch.zeros(1, big),
                                            coarse_dists=torch.zeros(1, big),
                                            rays_o=torch.zeros(1, 3),
                                            viewdirs=torch.ones(1, 3)), ValueError),
        "activation": (lambda: _fused(act="exp"), ValueError),
    }[case]
    with pytest.raises(error):
        call()
