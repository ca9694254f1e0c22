"""The port's image metrics, depth colour map and LPIPS graph against the JAX
package, on the CPU, on images made from numpy seeds.  SSIM, WS-SSIM,
WS-PSNR, ``visualize_depth`` and ``to_uint8`` are numpy and scipy on both
sides, so they agree bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.render import lpips_jax
from egonerf_tpu.render import metrics as jax_metrics
from egonerf_tpu.render import viz as jax_viz
from egonerf_torch.render import lpips, metrics, viz


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, h=24, w=48):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _cases():
    a, b = _images(0)
    c = np.full((20, 40, 3), 0.5, np.float32)
    return {"noisy": (a, b), "constant": (c, c.copy()),
            "constant vs noisy": (c, _images(1, 20, 40)[0]),
            "float64": (a.astype(np.float64), b.astype(np.float64))}


@pytest.mark.parametrize("filter_size", [11, 7, 5])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_ssim_family_matches_jax_bit_for_bit(case, filter_size):
    """Odd windows: the ``convolve1d`` path, cropped to 'valid'."""
    a, b = _cases()[case]
    kw = dict(filter_size=filter_size)
    want_map = jax_metrics._ssim_map(a, b, 1.0, **kw)
    got_map = metrics._ssim_map(a, b, 1.0, **kw)
    np.testing.assert_array_equal(got_map, want_map)
    want = (jax_metrics.rgb_ssim(a, b, 1.0, **kw), jax_metrics.ws_ssim(a, b, 1.0, **kw))
    assert (metrics.rgb_ssim(a, b, 1.0, **kw), metrics.ws_ssim(a, b, 1.0, **kw)) == want
    # the single map gives both means
    assert metrics.ssim_and_ws_ssim(a, b, 1.0, **kw) == want


def _ssim_map_2d(a, b, filter_size, sigma=1.5, k1=0.01, k2=0.03):
    """The SSIM map with the window's outer product in one 2-D 'valid'
    convolution per channel: an independent form of the separable blur."""
    from scipy.signal import convolve2d

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    win = np.exp(-0.5 * ((np.arange(filter_size) - hw + shift) / sigma) ** 2)
    win2 = np.outer(win, win) / win.sum() ** 2

    def blur(z):
        return np.stack([convolve2d(z[..., c], win2, mode="valid") for c in range(3)], -1)

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mu0, mu1 = blur(a), blur(b)
    s00 = np.maximum(blur(a * a) - mu0 ** 2, 0.0)
    s11 = np.maximum(blur(b * b) - mu1 ** 2, 0.0)
    s01 = blur(a * b) - mu0 * mu1
    s01 = np.sign(s01) * np.minimum(np.sqrt(s00 * s11), np.abs(s01))
    c1, c2 = k1 ** 2, k2 ** 2
    return ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / (
        (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))


@pytest.mark.parametrize("filter_size", [11, 8, 4])
@pytest.mark.parametrize("case", ["noisy", "constant vs noisy"])
def test_ssim_map_against_a_2d_convolution(case, filter_size):
    """Both window paths (odd: ``convolve1d``, even: two ``convolve2d`` with
    the mipnerf half-shift) against the 2-D form: float64 sums in another
    order, abs 1e-12.  JAX's even path cannot be called: its
    ``import scipy.ndimage`` inside the odd branch makes ``scipy`` a local
    name of ``_ssim_map``, unbound on the even branch, so it raises
    NameError (pinned here)."""
    a, b = _cases()[case]
    got = metrics._ssim_map(a, b, 1.0, filter_size=filter_size)
    want = _ssim_map_2d(a, b, filter_size)
    assert got.shape == want.shape == (a.shape[0] - filter_size + 1,
                                       a.shape[1] - filter_size + 1, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if filter_size % 2 == 0:
        with pytest.raises(NameError):
            jax_metrics._ssim_map(a, b, 1.0, filter_size=filter_size)
        assert metrics.ssim_and_ws_ssim(a, b, filter_size=filter_size) == (
            metrics.rgb_ssim(a, b, filter_size=filter_size),
            metrics.ws_ssim(a, b, filter_size=filter_size))


@pytest.mark.parametrize("case", ["noisy", "constant vs noisy", "float64"])
def test_psnr_and_ws_psnr_match_jax_bit_for_bit(case):
    a, b = _cases()[case]
    assert metrics.psnr(a, b) == jax_metrics.psnr(a, b)
    assert metrics.ws_psnr(a, b) == jax_metrics.ws_psnr(a, b)
    assert metrics.mse2psnr(0.01) == jax_metrics.mse2psnr(0.01)


def test_ws_psnr_weights_the_equator():
    """An error on the equator rows costs more than the same error at a pole."""
    a = np.zeros((32, 64, 3))
    pole, equator = a.copy(), a.copy()
    pole[0] = 0.5
    equator[16] = 0.5
    assert metrics.ws_psnr(a, equator) < metrics.ws_psnr(a, pole)
    assert metrics.psnr(a, equator) == metrics.psnr(a, pole)


def _depths():
    rng = np.random.default_rng(2)
    d = rng.uniform(0.1, 8.0, (12, 20)).astype(np.float32)
    holes = d.copy()
    holes[::3] = 0.0
    holes[0, 0] = np.nan
    return {"random": d, "zeros": np.zeros((6, 10), np.float32), "holes and nan": holes}


@pytest.mark.parametrize("minmax", [None, (0.05, 8.5)])
@pytest.mark.parametrize("case", sorted(_depths()))
def test_visualize_depth_matches_jax(case, minmax):
    d = _depths()[case]
    got, got_range = viz.visualize_depth(d, minmax)
    want, want_range = jax_viz.visualize_depth(d, minmax)
    assert got.dtype == np.uint8 and got.shape == d.shape + (3,)
    np.testing.assert_array_equal(got, want)
    assert got_range == want_range


def test_jet_and_to_uint8_match_jax():
    x = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(viz._jet(x), jax_viz._jet(x))
    img = np.random.default_rng(3).uniform(-0.3, 1.3, (9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(viz.to_uint8(img), jax_viz.to_uint8(img))


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------
def _jax_params(arrays, net):
    """JAX's weight pytree of the same arrays."""
    return {"convs": [(jnp.asarray(arrays[f"conv{i}_w"]), jnp.asarray(arrays[f"conv{i}_b"]))
                      for i in range(len(lpips.NETS[net]["convs"]))],
            "lins": [jnp.asarray(arrays[f"lin{j}_w"])
                     for j in range(len(lpips.NETS[net]["taps"]))]}


def test_nets_match_jax():
    assert lpips.NETS["alex"] == lpips_jax._ALEX and lpips.NETS["vgg"] == lpips_jax._VGG
    np.testing.assert_array_equal(lpips._SHIFT, lpips_jax._SHIFT)
    np.testing.assert_array_equal(lpips._SCALE, lpips_jax._SCALE)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_graph_matches_jax(net):
    """Random weights, 64x64.  Both sides sum the convolutions in float32 in
    their own orders (oneDNN here, XLA's CPU convolution there): rel 1e-5."""
    arrays = lpips.random_arrays(net, seed=0)
    im0, im1 = _images(4, 64, 64)
    want = float(lpips_jax._lpips_pair(_jax_params(arrays, net), jnp.asarray(im0),
                                       jnp.asarray(im1), net=net))
    params = lpips.params_from_arrays(arrays, net, "cpu")
    got = float(lpips.lpips_pair(params, torch.from_numpy(im0), torch.from_numpy(im1), net))
    assert got > 0.0
    assert got == pytest.approx(want, rel=1e-5)
    assert float(lpips.lpips_pair(params, torch.from_numpy(im0), torch.from_numpy(im0),
                                  net)) == 0.0


def test_rgb_lpips_without_weights_is_none(tmp_path, monkeypatch):
    monkeypatch.setenv("EGONERF_LPIPS_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(lpips, "_PARAM_CACHE", {})
    monkeypatch.setattr(lpips_jax, "_PARAM_CACHE", {})
    im0, im1 = _images(5, 40, 40)
    assert lpips.rgb_lpips(im0, im1, "alex") is None
    assert lpips.rgb_lpips(im0, im1, "vgg") is None
    assert jax_metrics.rgb_lpips(im0, im1, "alex") is None


def test_rgb_lpips_reads_a_file_that_appears(tmp_path, monkeypatch):
    """A miss is not cached: the file written after the first call is read
    by the next, from the same discovery path as JAX's; both packages give
    the same distance (rel 1e-5, as above)."""
    monkeypatch.setenv("EGONERF_LPIPS_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(lpips, "_PARAM_CACHE", {})
    monkeypatch.setattr(lpips_jax, "_PARAM_CACHE", {})
    im0, im1 = _images(6, 40, 40)
    assert lpips.rgb_lpips(im0, im1, "alex") is None
    np.savez(tmp_path / "lpips_alex.npz", **lpips.random_arrays("alex", seed=1))
    assert lpips.weights_path("alex") == lpips_jax.weights_path("alex")
    got = lpips.rgb_lpips(im0, im1, "alex")
    want = lpips_jax.rgb_lpips_jax(im0, im1, "alex")
    assert got is not None and got > 0
    assert got == pytest.approx(want, rel=1e-5)
    assert lpips.rgb_lpips(im0, im1, "vgg") is None


def test_weights_path_default(monkeypatch):
    monkeypatch.delenv("EGONERF_LPIPS_WEIGHTS_DIR", raising=False)
    assert lpips.weights_path("vgg") == lpips_jax.weights_path("vgg")
    assert lpips.weights_path("vgg").endswith("egonerf_tpu/lpips_vgg.npz")
