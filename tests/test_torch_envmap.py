"""The port's outdoor (envmap) path against the JAX package, on the CPU, at a
small shape (N_voxel 24^3, n_lamb 4/8, app_dim 12, featureC 32, 16 + 16
samples, an envmap of h = 5): the chart prologue K7, the envmap lookup K8
and its VJP K8b, the composite K6/K6b with the background blend, the model's
eval and pretrain forwards, one envmap training step, the pretrain phase of
the trainer, and checkpoints with an envmap.  The wrappers take their plain
versions on the CPU."""
import os
from math import pi

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models import model_meta as jax_model_meta
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.envmap import envmap_radiance as jax_envmap_radiance
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.ops.volrend import raw2alpha as jax_raw2alpha
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch import ops
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.models import (EgoNeRF, FieldConfig, load_jax_checkpoint, params_from_jax,
                                  params_to_jax)
from egonerf_torch.models.envmap import envmap_radiance, init_envmap
from egonerf_torch.ops import chart, envmap, volrend
from egonerf_torch.render.renderer import Renderer
from egonerf_torch.train import optim
from egonerf_torch.train.checkpoint import load_checkpoint, save_checkpoint
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer

AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
NEAR_FAR = (0.05, 8.5)
H_ENV = 5  # odd: the table's middle column is a texel centre at z = 0
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32, use_envmap=True, envmap_res_h=H_ENV)
RENDER = dict(n_coarse=16, n_fine=16)
N_RAYS = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K7: the chart prologue
# ---------------------------------------------------------------------------
def _boundary_rays():
    """Rays from the chart centre whose points lie on the yin boundaries
    theta = pi/4, 3pi/4 and phi = +-3pi/4, and random rays off it."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(40, 3))
    special = [[np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)]
               for th in (pi / 4, 3 * pi / 4, pi / 2, 0.3)
               for ph in (-3 * pi / 4, 3 * pi / 4, 0.3, pi)]
    d = np.concatenate([d, special])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros_like(d)
    o[:40] = rng.uniform(-0.3, 0.3, (40, 3))
    return o.astype(np.float32), d.astype(np.float32)


def _boundary_distance(pts):
    """Radians from each point to the nearest yin boundary."""
    r = np.linalg.norm(pts.astype(np.float64), axis=-1)
    th = np.arccos(np.clip(pts[:, 2] / np.maximum(r, 1e-12), -1, 1))
    ph = np.arctan2(pts[:, 1], pts[:, 0])
    return np.minimum(np.minimum(np.abs(th - pi / 4), np.abs(th - 3 * pi / 4)),
                      np.minimum(np.abs(ph + 3 * pi / 4), np.abs(ph - 3 * pi / 4)))


@pytest.mark.parametrize("interval_th", [True, False])
@pytest.mark.parametrize("downsample", [None, 2])
def test_chart_matches_jax(interval_th, downsample):
    """K7's plain version (the ``ops.chart`` wrapper on CPU tensors) against
    JAX's ``from_cartesian`` + ``normalize_coord`` of o + d z.  acos and
    atan2 differ by ulps between the libraries, so a point within 1e-6 rad
    of a chart boundary may fall to the other chart; only those may differ.
    Elsewhere the coords agree to 2e-5 (the radial normalization scales r's
    ulps by ~2 / (n_r * cell), as tests/test_torch_coords.py)."""
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=interval_th)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05,
                                interval_th=interval_th)
    o, d = _boundary_rays()
    z = np.random.default_rng(1).uniform(0.0, 9.0, (o.shape[0], 12)).astype(np.float32)
    z[:, 0] = 0.0  # the chart centre itself for the rays from the origin
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    want = np.asarray(jc.normalize_coord(jc.from_cartesian(jnp.asarray(xyz)),
                                         downsample=downsample)).reshape(-1, 4)
    got = ops.KERNELS.chart(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(z), tc,
                            downsample).numpy()
    assert got.shape == want.shape
    flip = got[:, 3] != want[:, 3]
    assert np.all(_boundary_distance(xyz.reshape(-1, 3)[flip]) < 1e-6)
    assert flip.sum() <= 16
    np.testing.assert_allclose(got[~flip], want[~flip], rtol=0, atol=2e-5)
    # the boundary points themselves (theta = pi/4, phi = +-3pi/4, ...) are
    # mostly kept by both: the inclusive bounds are tested there
    n_special = (o.shape[0] - 40) * 12
    assert (~flip[-n_special:]).sum() >= n_special - 16


def test_chart_takes_strided_rows():
    """The (R, 6) rays' column slices and a broadcast depth row give the
    contiguous inputs' coords bit for bit."""
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    o, d = _boundary_rays()
    rays = torch.from_numpy(np.concatenate([o, d], -1))
    row = torch.linspace(0.0, 8.0, 10)
    got = chart.chart_fwd(rays[:, :3], rays[:, 3:6], row.expand(rays.shape[0], 10), tc, 2)
    want = chart.chart_fwd_plain(torch.from_numpy(o), torch.from_numpy(d),
                                 row.repeat(rays.shape[0], 1), tc, 2)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K8 / K8b: the envmap lookup and its VJP
# ---------------------------------------------------------------------------
def _env_dirs():
    """Random directions (not unit length), the seam (atan2 = +-pi: v = 1
    and 0), the poles (u = 1 and 0, atan2(0, 0) = 0) and directions at
    z = 0, where u = 1/2 is a texel centre of the odd-width table."""
    rng = np.random.default_rng(2)
    d = rng.normal(size=(64, 3)) * rng.uniform(0.5, 3.0, (64, 1))
    special = [[-1.0, 0.0, 0.3], [-1.0, -0.0, -0.4], [-2.0, 0.0, 0.0], [-1.0, 1e-30, 0.2],
               [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 5.0],
               [3.0, 4.0, 0.0], [-4.0, 3.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
    return np.concatenate([d, special]).astype(np.float32)


def _table(seed=3):
    return np.random.default_rng(seed).normal(size=(2 * H_ENV, H_ENV, 3)).astype(np.float32)


def test_envmap_corners_at_the_seam_and_poles():
    """The seam pads with zeros rather than wrapping, and the poles sit on
    the table's edge columns: there one corner of each pair has weight 0."""
    dirs = torch.tensor([[-1.0, 0.0, 0.3], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [3.0, 4.0, 0.0]])
    (i00, w00), (i01, w01), (i10, w10), (i11, w11) = envmap.envmap_corners(dirs, H_ENV)
    w_, h_ = H_ENV, 2 * H_ENV
    # atan2(0, -1) = pi: v = 1, the last row; the next row is off the table
    assert int(i00[0]) // w_ == h_ - 1 and w10[0] == 0 and w11[0] == 0
    # z = 1: u = 1, the last column, its right neighbour off the table
    assert int(i00[1]) % w_ == w_ - 1 and w01[1] == 0 and w11[1] == 0
    # z = -1: u = 0, the first column, weight on it alone
    assert int(i00[2]) % w_ == 0 and w01[2] == 0
    # z = 0 on the odd-width table: the middle column exactly
    assert int(i00[3]) % w_ == w_ // 2 and w01[3] == 0 and w11[3] == 0


def test_envmap_matches_jax():
    """K8's and K8b's plain versions (the wrappers on CPU tensors) against
    JAX's ``envmap_radiance`` and ``jax.vjp`` of it in the table.  The
    port multiplies by float32(1 / 2pi) where JAX divides by 2pi, one ulp
    of v apart at most, which moves a lookup by ~1e-7 texel: radiance to
    2e-6, gradients to 2e-6 of the largest cell."""
    dirs, table = _env_dirs(), _table()
    g = np.random.default_rng(4).normal(size=(dirs.shape[0], 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda e: jax_envmap_radiance(e, jnp.asarray(dirs)), jnp.asarray(table))
    (want_g,) = vjp(jnp.asarray(g))
    got = ops.KERNELS.envmap(torch.from_numpy(table), torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    got_g = ops.KERNELS.envmap_bwd(torch.from_numpy(dirs), got, torch.from_numpy(g), H_ENV)
    want_g = np.asarray(want_g)
    assert got_g.shape == want_g.shape == (2 * H_ENV, H_ENV, 3)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=2e-6 * np.abs(want_g).max())


def test_envmap_function_backward_is_k8b():
    """``envmap_radiance`` differentiates through the Ops pair: its table
    gradient is K8b's plain version of its own output."""
    dirs, table = torch.from_numpy(_env_dirs()), torch.from_numpy(_table(5))
    t = table.clone().requires_grad_(True)
    env = envmap_radiance(t, dirs)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=env.shape).astype(np.float32))
    env.backward(g)
    assert torch.equal(t.grad, envmap.envmap_bwd_plain(dirs, env.detach(), g, H_ENV))


def test_init_envmap():
    gen = torch.Generator().manual_seed(0)
    e = init_envmap(H_ENV, gen)
    assert e.shape == (2 * H_ENV, H_ENV, 3) and 0.0 <= float(e.min()) and float(e.max()) < 1.0
    assert not init_envmap(H_ENV, init_strategy="zero").any()
    with pytest.raises(ValueError):
        init_envmap(H_ENV, gen, "sphere")


# ---------------------------------------------------------------------------
# K6 / K6b with the background blend
# ---------------------------------------------------------------------------
def _composite_problem(seed, r=48, s=40):
    rng = np.random.default_rng(seed)
    feat = rng.normal(6.0, 5.0, (r, s)).astype(np.float32)
    dists = rng.uniform(0.0, 0.08, (r, s)).astype(np.float32)
    rgb = rng.uniform(-0.3, 1.3, (r, s, 3)).astype(np.float32)
    env = rng.uniform(0.0, 1.0, (r, 3)).astype(np.float32)
    # ray 0 sums to exactly 0 (black samples, black background); ray 1 to
    # exactly 1 (an opaque white first sample hides the background); ray 2
    # is empty, so its colour is the background's
    rgb[0], env[0] = 0.0, 0.0
    feat[1, 0], dists[1, 0], rgb[1, 0] = 1000.0, 0.05, 1.0
    feat[2] = -40.0
    g = rng.normal(size=(r, 3)).astype(np.float32)
    return feat, dists, rgb, env, g


def _jax_blend(feat, dists, rgb, env, g):
    def rgb_map(f, c, e):
        _, weight, bg_weight = jax_raw2alpha(jax.nn.softplus(f - 8.0), jnp.asarray(dists) * 25.0)
        x = jnp.sum(weight[..., None] * c, axis=-2) + bg_weight * e
        return jnp.clip(x, 0.0, 1.0), bg_weight * e

    out, vjp, bg = jax.vjp(rgb_map, jnp.asarray(feat), jnp.asarray(rgb), jnp.asarray(env),
                           has_aux=True)
    return np.asarray(out), np.asarray(bg), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def test_composite_with_env_matches_jax():
    """K6's plain version with ``env`` against JAX's raw2alpha + the blend of
    ``models/egonerf.py:481-487``: the clip after the blend, bg_map =
    bg_weight * env; float32 sums in another order, 1e-6."""
    feat, dists, rgb, env, g = _composite_problem(0)
    want, want_bg, _ = _jax_blend(feat, dists, rgb, env, g)
    assert want[0].tolist() == [0.0] * 3 and want[1].tolist() == [1.0] * 3
    np.testing.assert_allclose(want[2], env[2], rtol=0, atol=1e-6)
    t = {k: torch.from_numpy(v) for k, v in dict(feat=feat, dists=dists, rgb=rgb,
                                                env=env).items()}
    outs = volrend.composite(t["feat"], t["dists"], t["dists"].cumsum(-1), t["rgb"],
                             torch.zeros(feat.shape[0]), -8.0, 25.0, "softplus", env=t["env"])
    assert len(outs) == 5
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(outs[4].numpy(), want_bg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(outs[4].numpy(), (outs[3] * t["env"]).numpy(), rtol=0, atol=0)
    # without env, the four outputs of before
    plain = volrend.composite(t["feat"], t["dists"], t["dists"].cumsum(-1), t["rgb"],
                              torch.zeros(feat.shape[0]))
    assert len(plain) == 4 and torch.equal(plain[3], outs[3])


def test_composite_bwd_with_env_matches_jax_vjp():
    """K6b's plain version with ``env`` against jax.vjp of the blend: the
    reverse recurrence starts at the background's q, the clip gradient is
    taken on the blended sum (1/2 at exactly 0 and 1), and d env =
    bg_weight * g; rel 1e-5 of each gradient's largest entry (float32 sums
    in another order)."""
    feat, dists, rgb, env, g = _composite_problem(1)
    _, _, (want_f, want_c, want_e) = _jax_blend(feat, dists, rgb, env, g)
    got = volrend.composite_bwd(torch.from_numpy(feat), torch.from_numpy(dists),
                                torch.from_numpy(rgb), torch.from_numpy(g), -8.0, 25.0,
                                "softplus", env=torch.from_numpy(env))
    assert len(got) == 3
    for x, want in zip(got, (want_f, want_c, want_e)):
        np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # ray 2 is empty: its background takes the whole gradient
    np.testing.assert_allclose(got[2][2].numpy(), g[2], rtol=1e-6)


def test_composite_function_with_env():
    """``composite_train`` with ``env``: rgb_map differentiable in feat, rgb
    and env through the plain K6b; depth, acc, bg_weight and bg_map not."""
    feat, dists, rgb, env, g = _composite_problem(2)
    f = torch.from_numpy(feat).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    e = torch.from_numpy(env).requires_grad_(True)
    d = torch.from_numpy(dists)
    outs = volrend.composite_train(f, d, d.cumsum(-1), c, torch.zeros(feat.shape[0]), -8.0,
                                   25.0, "softplus", env=e)
    assert not any(o.requires_grad for o in outs[1:])
    outs[0].backward(torch.from_numpy(g))
    want = volrend.composite_bwd_plain(f.detach(), d, c.detach(), torch.from_numpy(g),
                                       env=e.detach())
    for got, w in zip((f.grad, c.grad, e.grad), want):
        assert torch.equal(got, w)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _pair(compute_dtype="bfloat16", seed=0):
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    jm = JaxEgoNeRF(AABB, jc.resolution, jc,
                    JaxFieldConfig(**SHAPE, compute_dtype=compute_dtype), near_far=NEAR_FAR)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**SHAPE, compute_dtype=compute_dtype),
                 near_far=NEAR_FAR, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    return np.concatenate([o, d], -1)


def test_model_has_the_envmap(pair):
    jm, jp, tm = pair
    assert tuple(tm.envmap.shape) == jp["envmap"].shape == (2 * H_ENV, H_ENV, 3)
    assert torch.equal(tm.envmap.detach(), torch.from_numpy(np.asarray(jp["envmap"])))
    drawn = EgoNeRF(AABB, tm.grid_size, tm.coordinates, tm.cfg, near_far=NEAR_FAR,
                    device="cpu").init_params(torch.Generator().manual_seed(0))["envmap"]
    assert 0.0 <= float(drawn.min()) and float(drawn.max()) < 1.0 and drawn.std() > 0.2
    assert FieldConfig.from_meta(jax_model_meta(None, jm)).envmap_res_h == H_ENV


def test_forward_eval_with_envmap_matches(pair):
    """The eval forward against JAX's: rgb to 1e-5 and depth to 1e-4 as
    tests/test_torch_model.py; env (the lookup alone) to 2e-6 and bg to
    1e-5."""
    jm, jp, tm = pair
    rays = _rays(N_RAYS)
    want = jax.jit(lambda p, r: jm.forward(p, r, key=None, is_train=False, **RENDER))(
        jp, jnp.asarray(rays))
    with torch.no_grad():
        got = tm.forward(tm.params(), torch.from_numpy(rays), **RENDER)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["env"].numpy(), np.asarray(want["env"]), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["bg"].numpy(), np.asarray(want["bg"]), rtol=0, atol=1e-5)
    # the random weights leave the field nearly empty: the background shows
    assert float(got["bg"].mean()) > 0.1


def test_forward_pretrain_envmap_matches(pair):
    jm, jp, tm = pair
    rays = _rays(N_RAYS, seed=1)
    want = jm.forward(jp, jnp.asarray(rays), pretrain_envmap=True)
    got = tm.forward(tm.params(), torch.from_numpy(rays), pretrain_envmap=True)
    assert sorted(got) == sorted(want) == ["env"]
    np.testing.assert_allclose(got["env"].detach().numpy(), np.asarray(want["env"]), rtol=0,
                               atol=2e-6)


def test_pretrain_forward_needs_the_envmap():
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**{**SHAPE, "use_envmap": False}),
                 near_far=NEAR_FAR, device="cpu")
    with pytest.raises(ValueError, match="envmap"):
        tm.forward(tm.params(), torch.from_numpy(_rays(4)), pretrain_envmap=True)


def test_renderer_outputs_bg_and_env(pair):
    _, _, tm = pair
    rays = _rays(40, seed=2)
    r = Renderer(tm, chunk=16, **RENDER)
    out = r.render_rays(tm.params(), rays)
    assert sorted(out) == ["bg", "depth", "rgb"] and out["bg"].shape == (40, 3)
    env = r.render_rays(tm.params(), rays, pretrain_envmap=True)
    assert sorted(env) == ["env"]
    with torch.no_grad():
        want = tm.forward(tm.params(), torch.from_numpy(rays), pretrain_envmap=True)["env"]
    # torch's vectorized CPU sigmoid rounds a chunk's tail elements on
    # another path than its body, so the chunking moves last bits
    np.testing.assert_allclose(env["env"].numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def step():
    """One envmap training step on both sides (float32 tables, so every
    gradient has a float32 reference), with JAX's draws."""
    jm, jp, tm = _pair("float32", seed=3)
    rng = np.random.default_rng(7)
    rays = _rays(N_RAYS, seed=3)
    rgbs = rng.uniform(0.0, 1.0, size=(N_RAYS, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k_coarse, k_pdf = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k_coarse, (N_RAYS, RENDER["n_coarse"])))
    u = np.array(jax_sorted_uniform(k_pdf, (N_RAYS, RENDER["n_fine"])))

    def loss_fn(p):
        out = jm.forward(p, jnp.asarray(rays), key=key, is_train=True, **RENDER)
        return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    params = tm.params()
    out = tm.forward(params, torch.from_numpy(rays), is_train=True,
                     jitter=torch.from_numpy(jitter), u=torch.from_numpy(u), **RENDER)
    loss = torch.mean((out["rgb"] - torch.from_numpy(rgbs)) ** 2)
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in params.items()})
    return dict(want_loss=float(want_loss), loss=float(loss.detach()),
                want=jax_ckpt._flatten(want_grads), got=got)


def test_envmap_step_loss_matches_jax(step):
    """float32 sums in another order through the cdf, the field, the
    shader and the composite: rel 1e-5, as tests/test_torch_train.py."""
    assert step["loss"] == pytest.approx(step["want_loss"], rel=1e-5)


def test_envmap_step_gradients_match_jax(step):
    """Every gradient, the envmap's included, against jax.value_and_grad:
    rel 1e-4 of each tensor's largest entry (float32 scatter-adds,
    matmuls and cumsums in another order, as tests/test_torch_train.py)."""
    got, want = step["got"], step["want"]
    assert sorted(got) == sorted(want) and "envmap" in got
    for k in sorted(want):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)
    assert np.abs(got["envmap"]).max() > 0


# ---------------------------------------------------------------------------
# the trainer: the pretrain phase, resume, checkpoints
# ---------------------------------------------------------------------------
def _tiny_cfg(tmp_path, **over):
    base = dict(
        dataset_name="synthetic", model_name="EgoNeRF", coordinates_name="yinyang",
        exp_sampling=True, interval_th=True, r0="0.05", resampling=True,
        use_coarse_sample=True, n_coarse=16, n_fine=16, batch_size=256,
        n_iters=4, N_voxel_init=24 ** 3, N_voxel_final=24 ** 3,
        n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
        shadingMode="MLP_Fea", fea2denseAct="softplus", density_shift="-8",
        featureC=32, view_pe=2, fea_pe=2, lr_init=0.02, lr_basis=1e-3, sparsity_lambda=0,
        near_far="[0.05, 8.5]", progress_refresh_rate=2, basedir=str(tmp_path),
        expname="env", N_vis=0, i_weights=10 ** 7, eval_chunk=512, use_envmap=True,
        envmap_res_H=8, iter_pretrain_envmap=6, lr_envmap_pretrain=0.05, lr_envmap=0.01,
        lr_decay_target_ratio=0.1)
    base.update(over)
    return base


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A fresh envmap run, every optimizer step recorded: which Adam took it,
    its group lrs and count, and which parameters had moved before it."""
    tmp = tmp_path_factory.mktemp("envmap")
    trainer = Trainer(load_config(overrides=_tiny_cfg(tmp)), device="cpu")
    first = trainer.optimizer
    start = {k: p.detach().clone() for k, p in trainer.params.items()}
    steps = []
    orig = optim.Optimizer.step

    def recorded(self):
        moved = sorted(k for k, p in trainer.params.items() if not torch.equal(p, start[k]))
        steps.append(dict(opt=self, count=self.count, moved=moved,
                          lrs={g["group"]: g["lr"] for g in self.adam.param_groups},
                          scale=self.factor ** self.count))
        orig(self)

    optim.Optimizer.step = recorded
    try:
        trainer.train()
    finally:
        optim.Optimizer.step = orig
    return trainer, tmp, first, steps


def test_pretrain_moves_only_the_envmap_at_a_constant_lr(pretrained):
    trainer, _, first, steps = pretrained
    cfg = trainer.cfg
    pre, main = steps[:cfg.iter_pretrain_envmap], steps[cfg.iter_pretrain_envmap:]
    assert len(main) == cfg.n_iters
    # the pretrain runs on an Adam of its own, built for it
    assert all(s["opt"] is pre[0]["opt"] for s in pre) and pre[0]["opt"] is not first
    assert pre[0]["opt"].base_lr["envmap"] == cfg.lr_envmap_pretrain
    # no decay: every pretrain step at scale 1 (lrs are set inside step, so
    # the recorded ones are the previous step's: equal from the second on)
    assert [s["scale"] for s in pre] == [1.0] * len(pre)
    assert all(s["lrs"]["envmap"] == cfg.lr_envmap_pretrain for s in pre[1:])
    # only the envmap moved: before the first main step nothing else had
    assert main[0]["moved"] == ["envmap"]


def test_pretrain_rebuilds_the_optimizer_and_restarts_the_decay(pretrained):
    trainer, _, first, steps = pretrained
    cfg = trainer.cfg
    main = steps[cfg.iter_pretrain_envmap:]
    opt = main[0]["opt"]
    assert all(s["opt"] is opt for s in main) and opt is trainer.optimizer
    assert opt is not first and opt is not steps[0]["opt"]
    assert opt.base_lr["envmap"] == cfg.lr_envmap
    assert [s["count"] for s in main] == list(range(cfg.n_iters))
    assert opt.factor == pytest.approx(cfg.lr_decay_target_ratio ** (1.0 / cfg.n_iters))
    # fresh Adam moments: the pretrain's state did not carry over
    assert all(len(opt.adam.state[p]) for p in trainer.params.values())
    assert main[-1]["lrs"]["envmap"] == pytest.approx(cfg.lr_envmap * opt.factor ** 2)


def test_resume_skips_the_pretrain(pretrained):
    trainer, tmp, _, _ = pretrained
    envmap_before = trainer.params["envmap"].detach().clone()
    resumed = Trainer(load_config(overrides=_tiny_cfg(tmp, n_iters=5)), device="cpu")
    assert resumed.start_step == trainer.cfg.n_iters
    assert torch.equal(resumed.params["envmap"], envmap_before)
    opt = resumed.optimizer
    resumed.pretrain_envmap()
    assert resumed.optimizer is opt and opt.count == trainer.cfg.n_iters
    assert torch.equal(resumed.params["envmap"], envmap_before)


def test_set_datasets_swaps_the_training_rays(pretrained, tmp_path):
    from egonerf_torch.data.datasets import SyntheticEgoDataset

    trainer = Trainer(load_config(overrides=_tiny_cfg(tmp_path, iter_pretrain_envmap=0)),
                      device="cpu")
    common = dict(n_train=3, n_test=1, height=6, width=12, background="env",
                  near_far=trainer.cfg.near_far)
    train = SyntheticEgoDataset(split="train", **common)
    test = SyntheticEgoDataset(split="test", is_stack=True, **common)
    trainer.set_datasets(train, test)
    assert trainer.test_dataset is test and trainer.sampler.buffer.shape == (3 * 72, 9)
    np.testing.assert_array_equal(trainer.sampler.buffer[:, :6].numpy(), train.all_rays)
    psnrs = trainer.train()
    assert len(psnrs) == 0 or np.isfinite(psnrs).all()


def test_envmap_checkpoint_port_to_jax(pretrained):
    """The port's checkpoint carries the envmap under JAX's key, channel-last,
    and egonerf_tpu reads it back into its parameter tree."""
    trainer, tmp, _, _ = pretrained
    path = os.path.join(trainer.logdir, "env.npz")
    flat, header, masks = jax_ckpt.load_checkpoint(path)
    assert "envmap" in flat and flat["envmap"].shape == (16, 8, 3)
    np.testing.assert_array_equal(flat["envmap"], trainer.params["envmap"].detach().numpy())
    assert header["model_meta"]["use_envmap"] and header["model_meta"]["envmap_res_h"] == 8
    jc = JaxYinYang(trainer.coords.aabb, exp_r=True, N_voxel=24 ** 3, r0=0.05,
                    interval_th=True)
    jm = JaxEgoNeRF(trainer.coords.aabb, jc.resolution, jc,
                    JaxFieldConfig(**{**SHAPE, "envmap_res_h": 8}), near_far=NEAR_FAR)
    jp = jax_ckpt.unflatten_params(jm.init_params(jax.random.PRNGKey(1)), flat)
    np.testing.assert_array_equal(np.asarray(jp["envmap"]), flat["envmap"])


def test_envmap_checkpoint_jax_to_port(pair, tmp_path):
    jm, jp, _ = pair
    path = str(tmp_path / "jax_env.npz")
    jax_ckpt.save_checkpoint(path, jp, global_step=3, coords_spec=jm.coordinates.to_spec(),
                             model_meta=jax_model_meta(None, jm))
    model, params, header = load_jax_checkpoint(path, near_far=NEAR_FAR, device="cpu")
    assert model.cfg.use_envmap and model.cfg.envmap_res_h == H_ENV
    np.testing.assert_array_equal(params["envmap"].detach().numpy(), np.asarray(jp["envmap"]))
    # and the port writes it back unchanged
    out = str(tmp_path / "port_env.npz")
    save_checkpoint(out, params, global_step=3, coords_spec=header["coords_spec"],
                    model_meta=header["model_meta"])
    flat, _ = load_checkpoint(out)
    for k, v in jax_ckpt._flatten(jp).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
