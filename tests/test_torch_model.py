"""The port's model, weight converter and renderer against the JAX package,
on the CPU, at a small shape (N_voxel 24^3, n_lamb 4/8, app_dim 12,
featureC 32, 16 + 16 samples)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models import model_meta
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.render.renderer import Renderer as JaxRenderer
from egonerf_tpu.train.checkpoint import _flatten, save_checkpoint
from egonerf_torch import ops
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.data.ray_utils import get_ray_directions_360, get_rays
from egonerf_torch.models import (EgoNeRF, FieldConfig, load_jax_checkpoint,
                                  params_from_jax, params_to_jax)
from egonerf_torch.render.renderer import Renderer

AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
NEAR_FAR = (0.05, 8.5)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32)
RENDER = dict(n_coarse=16, n_fine=16)


def _pair(interval_th):
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=interval_th)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05,
                                interval_th=interval_th)
    jm = JaxEgoNeRF(AABB, jc.resolution, jc, JaxFieldConfig(**SHAPE), near_far=NEAR_FAR)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**SHAPE), near_far=NEAR_FAR,
                 device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    flat = _flatten(jp)
    tm.load_state_dict(params_from_jax(flat, device="cpu"))
    return jm, jp, flat, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(True)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    return np.concatenate([o, d], -1)


def _norm_coords(n, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    sel = rng.integers(0, 2, (n, 1)).astype(np.float32)
    return np.concatenate([xyz, sel], -1)


def test_params_round_trip_bit_exact(pair):
    _, _, flat, tm = pair
    back = params_to_jax(params_from_jax(flat, device="cpu"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype and back[k].shape == flat[k].shape, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # JAX MLP weights are (n_in, n_out); nn.Linear keeps (out, in)
    assert tuple(tm.shader.l1.weight.shape) == flat["shader/l1/w"].shape[::-1]
    assert tuple(tm.basis.shape) == flat["basis"].shape == (2, 24, 12)


def test_compute_field_matches(pair):
    jm, jp, _, tm = pair
    coords = _norm_coords(2048)
    # eager, not jitted: under jit XLA fuses the hat index arithmetic into
    # FMAs, which moves a bf16 hat-weight rounding here and there (the
    # reference then differs from itself by ~4e-6); eager JAX runs the same
    # float32 operations as the port
    want_d, want_a = jm.compute_field(jp, jnp.asarray(coords))
    with torch.no_grad():
        got_d, got_a = tm.compute_field(tm.params(), torch.from_numpy(coords))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # the basis matmul adds in another order: float32 ulps
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6, atol=1e-8)


def test_derive_coarse_and_density_feature_match(pair):
    jm, jp, _, tm = pair
    want_p, want_l = jm.derive_coarse(jp)
    got_p, got_l = tm.derive_coarse(tm.params())
    for g, w in zip(got_p + got_l, want_p + want_l):
        assert tuple(g.shape) == w.shape
        # a mean of 4 (or 2) float32 values summed in another order
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)
    coords = _norm_coords(2048, seed=1)
    want = jax.jit(jm.compute_density_feature)(want_p, want_l, jnp.asarray(coords))
    same_p = [torch.from_numpy(np.array(p)) for p in want_p]
    same_l = [torch.from_numpy(np.array(l)) for l in want_l]
    with torch.no_grad():
        got = tm.compute_density_feature(same_p, same_l, torch.from_numpy(coords))
    # same pooled grids on both sides; the channel sums add in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("interval_th", [True, False])
def test_forward_eval_matches(pair, interval_th):
    jm, jp, _, tm = pair if interval_th else _pair(False)
    rays = _rays(64)
    want = jax.jit(lambda p, r: jm.forward(p, r, key=None, is_train=False, **RENDER))(
        jp, jnp.asarray(rays))
    with torch.no_grad():  # an eval caller, as the Renderer
        got = tm.forward(tm.params(), torch.from_numpy(rays), **RENDER)
    # float32 sums in another order through the cdf, composite and MLP;
    # measured ~1e-7 on rgb and ~1e-6 on depth
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=0, atol=1e-4)
    assert got["bg"] is None and want["bg"] is None


def test_render_rays_ragged_tail_matches(pair):
    jm, jp, _, tm = pair
    rays = _rays(80, seed=2)  # three chunks of 32, the last padded by 16
    want = JaxRenderer(jm, chunk=32, **RENDER).render_rays(jp, rays)
    got = Renderer(tm, chunk=32, **RENDER).render_rays(tm.params(), rays)
    assert sorted(got) == sorted(want) == ["depth", "rgb"]
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"], rtol=0, atol=1e-4)


def test_render_view_matches_host_rays(pair):
    """Rays made on the device from the resident directions give the same
    image as host-made rays."""
    _, _, _, tm = pair
    dirs = get_ray_directions_360(6, 12)
    c2w = np.array([[0.0, -1.0, 0.0, 0.1], [1.0, 0.0, 0.0, -0.2], [0.0, 0.0, 1.0, 0.05]],
                   np.float32)
    renderer = Renderer(tm, chunk=32, **RENDER)
    renderer.set_directions(dirs)
    view = renderer.render_view(tm.params(), c2w)
    rays_o, rays_d = get_rays(dirs, c2w)
    host = renderer.render_rays(tm.params(), np.concatenate([rays_o, rays_d], -1))
    assert view["rgb"].shape == (72, 3) and view["depth"].shape == (72,)
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(view[k].numpy(), host[k].numpy(), rtol=0, atol=1e-6)


def test_kernels_and_plain_ops_agree_on_cpu(pair):
    _, _, _, tm = pair
    rays = torch.from_numpy(_rays(32, seed=3))
    got = tm.forward(tm.params(), rays, **RENDER)
    tm.ops = ops.PLAIN
    try:
        want = tm.forward(tm.params(), rays, **RENDER)
    finally:
        tm.ops = ops.KERNELS
    for k in ("rgb", "depth", "acc"):
        assert torch.equal(got[k], want[k])


def test_load_jax_checkpoint(pair, tmp_path):
    jm, jp, flat, _ = pair
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, jp, global_step=7, coords_spec=jm.coordinates.to_spec(),
                    model_meta=model_meta(None, jm))
    model, params, header = load_jax_checkpoint(path, near_far=NEAR_FAR, device="cpu")
    assert header["global_step"] == 7
    assert model.grid_size == jm.grid_size
    assert tuple(model.cfg.density_n_comp) == (4, 4, 4) and model.cfg.app_dim == 12
    back = params_to_jax(params)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("kwargs", [dict(is_train=True, exp_sampling=False), dict(eval_keep=8),
                                    dict(exp_sampling=False), dict(ndc_ray=True)])
def test_unported_options_raise(pair, kwargs):
    _, _, _, tm = pair
    with pytest.raises(NotImplementedError):
        tm.forward(tm.params(), torch.from_numpy(_rays(4)), **RENDER, **kwargs)
