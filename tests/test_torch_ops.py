"""The port's ops (plain versions) against the JAX package, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.egonerf import feature2density as jax_feature2density
from egonerf_tpu.ops import merge as jmerge
from egonerf_tpu.ops import pdf as jpdf
from egonerf_tpu.ops import pe as jpe
from egonerf_tpu.ops import vm_lookup as jvm
from egonerf_tpu.ops import volrend as jvol
from egonerf_torch.ops import merge, pdf, pe, vm_lookup, volrend

S, H, W, L, C = 2, 7, 9, 11, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.numpy()


def _coords(n, rng, lo_cells=None):
    """Normalized coords in range, exactly at +-1, one cell below -1 and
    beyond +-1, on both charts."""
    c = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    c[:8] = [-1.0, 1.0, -1.05, -1.3, 1.2, 1.0001, -0.99999, 0.0]
    if lo_cells:
        # p in (-1, 0): the coord lies within one cell below -1
        c[8:16] = -1.0 - rng.uniform(0.01, 0.99, 8) * 2.0 / (lo_cells - 1)
    return c


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("chart", [0, 1, "mixed"])
def test_sample_plane_matches(rng, chart):
    n = 512
    plane = rng.normal(size=(S, H, W, C)).astype(np.float32)
    x = _coords(n, rng, W)
    y = _coords(n, np.random.default_rng(1), H)
    sel = (np.full(n, chart) if chart != "mixed" else rng.integers(0, 2, n)).astype(np.int32)
    want = np.asarray(jvm.sample_plane_packed(jnp.asarray(plane), jnp.asarray(x),
                                              jnp.asarray(y), jnp.asarray(sel)))
    got = vm_lookup.sample_plane(_t(plane).to(torch.bfloat16), _t(x), _t(y), _t(sel))
    # bf16 table values, float32 corner weights, the same order of the four
    # products: bit for bit
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("chart", [0, 1, "mixed"])
def test_sample_line_matches(rng, chart):
    n = 512
    line = rng.normal(size=(S, L, C)).astype(np.float32)
    z = _coords(n, rng, L)
    sel = (np.full(n, chart) if chart != "mixed" else rng.integers(0, 2, n)).astype(np.int32)
    want = np.asarray(jvm.sample_line_packed(jnp.asarray(line), jnp.asarray(z),
                                             jnp.asarray(sel)))
    got = vm_lookup.sample_line(_t(line).to(torch.bfloat16), _t(z), _t(sel))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("small_cap", [False, True])
def test_line_hat_gate_both_sides(rng, monkeypatch, small_cap):
    """Under the byte cap the fine line lookup takes the bf16 hat weights;
    past it (shown by lowering the cap on both sides) the float32 ones."""
    n = 512
    if small_cap:
        monkeypatch.setattr(jvm, "_ONEHOT_MAX_BYTES", 1.0)
        monkeypatch.setattr(vm_lookup, "_ONEHOT_MAX_BYTES", 1.0)
    hat = vm_lookup.line_hat_ok(S * L, n)
    assert hat == jvm._onehot_ok(S * L, n, jvm._ONEHOT_FWD_MAX_ROWS) == (not small_cap)
    line = rng.normal(size=(S, L, C)).astype(np.float32)
    z = _coords(n, rng, L)
    sel = rng.integers(0, 2, n).astype(np.int32)
    want = np.asarray(jvm.sample_line_hat(jnp.asarray(line), jnp.asarray(z),
                                          jnp.asarray(sel)))
    fn = vm_lookup.sample_line_hat if hat else vm_lookup.sample_line
    got = fn(_t(line).to(torch.bfloat16), _t(z), _t(sel))
    # the tent at pos = p + sel*L rounded to bf16 as _hat_matrix does: exact
    np.testing.assert_array_equal(_np(got), want)
    if not small_cap:
        # and the hat weights really differ from the float32 ones somewhere
        f32 = vm_lookup.sample_line(_t(line).to(torch.bfloat16), _t(z), _t(sel))
        assert not torch.equal(f32, got)


def test_line_hat_ok_production_gate():
    # 4096 rays x 256 samples on the 1,032-row table: 2.16e9 bytes, hat path
    assert vm_lookup.line_hat_ok(1032, 4096 * 256)
    # 8192 rays per chunk: 4.3e9 bytes, float32 weights as in JAX
    assert not vm_lookup.line_hat_ok(1032, 8192 * 256)
    assert not vm_lookup.line_hat_ok(1153, 10)
    for rows, n in ((1032, 4096 * 256), (1032, 8192 * 256), (1153, 10), (300, 10)):
        assert vm_lookup.line_hat_ok(rows, n) == jvm._onehot_ok(rows, n, 1152)


def _pdf_inputs(rng, n=64, b=17):
    bins = np.sort(rng.uniform(0.05, 8.5, (n, b)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(n, b - 1)).astype(np.float32)
    w[:4] = 0.0  # all-zero rays: the pdf is the 1e-5 floor
    w[4:8, 3:] = 0.0
    return bins, w


def _assert_pdf_draws_close(got, want, u, w):
    """The cdf is a cumsum, which XLA associates otherwise than torch: the
    depths agree to float32 ulps, except where u lies within a few ulps of
    a cdf entry.  There the bracket may differ, and next to a bin of mass
    under 1e-5 the reference's denom guard makes the draw jump."""
    wt = jnp.asarray(w) + 1e-5
    cdf = np.asarray(jnp.cumsum(wt / jnp.sum(wt, -1, keepdims=True), -1))
    cdf = np.concatenate([np.zeros_like(cdf[:, :1]), cdf], -1)
    u = np.broadcast_to(np.asarray(u), got.shape)
    ambiguous = np.abs(u[:, :, None] - cdf[:, None, :]).min(-1) <= 5e-7
    np.testing.assert_allclose(got[~ambiguous], want[~ambiguous], rtol=1e-5, atol=1e-6)


def test_sample_pdf_linspace_matches(rng):
    bins, w = _pdf_inputs(rng)
    want = np.asarray(jpdf.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, key=None))
    got = _np(pdf.sample_pdf(_t(bins), _t(w), 24))
    _assert_pdf_draws_close(got, want, jnp.linspace(0.0, 1.0, 24), w)
    # the ambiguous draws are only u = 0 (= cdf[0]) and u = 1 (~ cdf[-1])
    assert np.array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[8:, :-1], want[8:, :-1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sorted_draws", [False, True])
def test_sample_pdf_injected_uniforms_match(rng, sorted_draws):
    bins, w = _pdf_inputs(rng)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpdf.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, key=key,
                                      sorted_draws=sorted_draws))
    # the same uniforms the JAX function draws from that key
    u = (jmerge.sorted_uniform(key, (64, 24)) if sorted_draws
         else jax.random.uniform(key, (64, 24)))
    got = pdf.sample_pdf(_t(bins), _t(w), 24, u=_t(u))
    _assert_pdf_draws_close(_np(got), want, u, w)


def test_linspace_bit_exact():
    for n in (1, 2, 16, 128, 129):
        np.testing.assert_array_equal(_np(pdf.linspace01(n)),
                                      np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def test_merge_sorted_matches(rng):
    a = np.sort(rng.uniform(0, 9, (64, 16)), -1).astype(np.float32)
    b = np.sort(rng.uniform(0, 9, (64, 16)), -1).astype(np.float32)
    b[:, :4] = a[:, :4]  # ties
    b = np.sort(b, -1)
    want = np.asarray(jmerge.merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_np(merge.merge_sorted(_t(a), _t(b))), want)


def test_raw2alpha_matches(rng):
    sigma = rng.exponential(0.5, (64, 32)).astype(np.float32)
    dist = rng.uniform(0.0, 0.5, (64, 32)).astype(np.float32)
    want = jvol.raw2alpha(jnp.asarray(sigma), jnp.asarray(dist))
    got = volrend.raw2alpha(_t(sigma), _t(dist))
    for g, w in zip(got, want):
        # cumprod in another association: float32 ulps
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("act", ["softplus", "relu"])
def test_feature2density_matches(rng, act):
    feat = rng.normal(0.0, 10.0, 4096).astype(np.float32)
    cfg = JaxFieldConfig(fea2dense_act=act)
    want = np.asarray(jax_feature2density(jnp.asarray(feat), cfg))
    got = volrend.density_activation(_t(feat), cfg.density_shift, act)
    # exp and log1p from two libraries
    np.testing.assert_allclose(_np(got), want, rtol=2e-6, atol=1e-7)


def test_positional_encoding_matches(rng):
    x = rng.normal(size=(256, 5)).astype(np.float32)
    want = np.asarray(jpe.positional_encoding(jnp.asarray(x), 3))
    got = pe.positional_encoding(_t(x), 3)
    # sin and cos from two libraries on arguments up to |4x|
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6)


def test_resample_plain_matches_jax_composition(rng):
    """K4's plain version against the JAX forward's own steps."""
    r, s, f = 32, 16, 16
    z = np.sort(rng.uniform(0.05, 8.5, (r, s)), -1).astype(np.float32)
    d = np.concatenate([np.diff(z), np.diff(z)[:, -1:]], -1).astype(np.float32)
    # moderate densities: every interior bin keeps a mass well above the
    # 1e-5 floor, so no draw sits at the reference's denom-guard jump
    feat = rng.normal(4.0, 0.5, (r, s)).astype(np.float32)
    cfg = JaxFieldConfig()
    sigma = jax_feature2density(jnp.asarray(feat), cfg)
    _, cw, _ = jvol.raw2alpha(sigma, jnp.asarray(d) * cfg.distance_scale)
    fine = jpdf.sample_pdf(0.5 * (jnp.asarray(z)[:, 1:] + jnp.asarray(z)[:, :-1]),
                           cw[:, 1:-1], f, key=None, sorted_draws=True)
    want_z = np.asarray(jmerge.merge_sorted(jnp.asarray(z), fine))
    want_d = np.concatenate([np.diff(want_z), np.diff(want_z)[:, -1:]], -1)
    got_z, got_d = pdf.resample_plain(_t(feat), _t(z), _t(d), f)
    # cumsum and cumprod in another association: float32 ulps of the depths
    np.testing.assert_allclose(_np(got_z), want_z, rtol=1e-5, atol=1e-6)
    # dists are differences of two such depths (up to 8.5): 2 x 1e-5 x 8.5
    np.testing.assert_allclose(_np(got_d), want_d, rtol=0, atol=2e-4)
    # the wrapper on CPU tensors is the plain version
    for g, p in zip(pdf.resample(_t(feat), _t(z), _t(d), f), (got_z, got_d)):
        assert torch.equal(g, p)


def test_composite_plain_matches_jax_composition(rng):
    """K6's plain version against the JAX forward's composite."""
    r, s = 32, 24
    z = np.sort(rng.uniform(0.05, 8.5, (r, s)), -1).astype(np.float32)
    d = np.concatenate([np.diff(z), np.diff(z)[:, -1:]], -1).astype(np.float32)
    feat = rng.normal(7.0, 2.0, (r, s)).astype(np.float32)
    rgb = rng.uniform(0, 1, (r, s, 3)).astype(np.float32)
    dz = rng.uniform(-1, 1, r).astype(np.float32)
    cfg = JaxFieldConfig()
    sigma = jax_feature2density(jnp.asarray(feat), cfg)
    _, w, bg = jvol.raw2alpha(sigma, jnp.asarray(d) * cfg.distance_scale)
    acc = jnp.sum(w, -1)
    want = (np.asarray(jnp.clip(jnp.sum(w[..., None] * rgb, -2), 0.0, 1.0)),
            np.asarray(jnp.sum(w * z, -1) + (1.0 - acc) * dz), np.asarray(acc),
            np.asarray(bg))
    got = volrend.composite(_t(feat), _t(d), _t(z), _t(rgb), _t(dz))
    for g, wnt in zip(got, want):
        # sums and cumprod in another order: float32 ulps
        np.testing.assert_allclose(_np(g), wnt, rtol=1e-5, atol=1e-6)
