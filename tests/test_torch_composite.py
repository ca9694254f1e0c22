"""The composite's envmap form (K6e: K6 with K8's lookup inside), K6b's
range of sample counts and its shared layout, on the CPU, where the wrappers take their plain versions.

K6e's plain version is K8's plain version followed by K6's blend, so its
outputs must equal that composition bit for bit; against JAX's
``envmap_radiance`` and the blend of ``models/egonerf.py:481-487`` it is
held to the tolerances of ``tests/test_torch_envmap.py``.  Through
``composite_train`` the table's gradient is K8b of K6b's d env.  The model's
outdoor forward and training step against JAX's are
``tests/test_torch_envmap.py``'s tests, which now run through this form."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.models.envmap import envmap_radiance as jax_envmap_radiance
from egonerf_tpu.ops.volrend import raw2alpha as jax_raw2alpha
from egonerf_torch import ops
from egonerf_torch.ops import envmap, volrend

H_ENV = 5
# tests/test_torch_envmap.py::_env_dirs's hard directions: the seam
# (atan2 = +-pi), the poles, z = 0 on the odd-width table's middle column
HARD_DIRS = [[-1.0, 0.0, 0.3], [-1.0, -0.0, -0.4], [-2.0, 0.0, 0.0], [-1.0, 1e-30, 0.2],
             [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 5.0], [3.0, 4.0, 0.0],
             [-4.0, 3.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, r=48, s=40):
    """A composite batch whose last rays look at the seam and the poles, as
    (R, 6) rays: (feat, dists, z, rgb, ray_dz, table, rays, g)."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(6.0, 5.0, (r, s)).astype(np.float32)
    dists = rng.uniform(0.0, 0.08, (r, s)).astype(np.float32)
    rgb = rng.uniform(-0.3, 1.3, (r, s, 3)).astype(np.float32)
    feat[2] = -40.0  # an empty ray: its colour is the background's
    dirs = rng.normal(size=(r, 3)) * rng.uniform(0.5, 3.0, (r, 1))
    n = min(r, len(HARD_DIRS))
    dirs[-n:] = HARD_DIRS[:n]
    rays = np.concatenate([rng.uniform(-0.2, 0.2, (r, 3)), dirs], -1).astype(np.float32)
    table = rng.normal(size=(2 * H_ENV, H_ENV, 3)).astype(np.float32)
    g = rng.normal(size=(r, 3)).astype(np.float32)
    t = torch.from_numpy
    return (t(feat), t(dists), t(dists).cumsum(-1), t(rgb), t(rays[:, 2].copy()), t(table),
            t(rays), t(g))


def _envmap_args(p):
    """composite's arguments in the envmap form, the directions the (R, 6)
    rays' strided columns 3:6."""
    feat, dists, z, rgb, ray_dz, table, rays, _ = p
    return (feat, dists, z, rgb, ray_dz, -8.0, 25.0, "softplus", None, None, None, table,
            rays[:, 3:6])


@pytest.mark.parametrize("seed", [0, 1])
def test_envmap_form_is_k8_then_the_blend(seed):
    """K6e's plain version: env is K8's plain version and rgb, depth, acc,
    bg and bg_map are K6's with that env, bit for bit, the seam and the
    poles included."""
    p = _problem(seed)
    args = _envmap_args(p)
    got = volrend.composite(*args)
    assert len(got) == 6
    env = envmap.envmap_fwd_plain(p[5], p[6][:, 3:6])
    want = volrend.composite_plain(*args[:8], env) + (env,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # contiguous directions give the same bits as the strided columns
    again = volrend.composite(*args[:12], p[6][:, 3:6].contiguous())
    for g, w in zip(again, got):
        assert torch.equal(g, w)


def test_envmap_form_matches_jax():
    """K6e's plain version against JAX's ``envmap_radiance`` followed by the
    blend (the clip after it, bg_map = bg_weight * env): env to 2e-6 (the
    port multiplies by float32(1 / 2pi) where JAX divides, one ulp of v),
    rgb and bg_map to 1e-6 plus what env's 2e-6 moves them."""
    feat, dists, z, rgb, ray_dz, table, rays, _ = _problem(2)
    dirs = rays[:, 3:6].numpy()
    want_env = np.asarray(jax_envmap_radiance(jnp.asarray(table.numpy()), jnp.asarray(dirs)))
    _, weight, bg_weight = jax_raw2alpha(jax.nn.softplus(jnp.asarray(feat.numpy()) - 8.0),
                                         jnp.asarray(dists.numpy()) * 25.0)
    want_bg = np.asarray(bg_weight * want_env)
    want_rgb = np.asarray(jnp.clip(jnp.sum(weight[..., None] * jnp.asarray(rgb.numpy()), -2)
                                   + want_bg, 0.0, 1.0))
    got = volrend.composite(*_envmap_args(_problem(2)))
    np.testing.assert_allclose(got[5].numpy(), want_env, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[4].numpy(), want_bg, rtol=0, atol=3e-6)
    np.testing.assert_allclose(got[0].numpy(), want_rgb, rtol=0, atol=3e-6)
    # the empty ray shows the background alone
    np.testing.assert_allclose(got[0][2].numpy(), np.clip(want_env[2], 0, 1), rtol=0, atol=3e-6)


def test_envmap_form_table_gradient_is_k8b_of_k6b():
    """Through ``composite_train`` in the envmap form, feat and rgb take
    K6b's gradients and the table takes K8b of K6b's d env (given K6e's
    env), bit for bit; the directions, depth, acc, bg, bg_map and env take
    none."""
    feat, dists, z, rgb, ray_dz, table, rays, g = _problem(3)
    f, c, t = (x.clone().requires_grad_(True) for x in (feat, rgb, table))
    outs = volrend.composite_train(f, dists, z, c, ray_dz, -8.0, 25.0, "softplus",
                                   envmap=t, viewdirs=rays[:, 3:6])
    assert len(outs) == 6 and not any(o.requires_grad for o in outs[1:])
    outs[0].backward(g)
    env = outs[5]
    d_feat, d_rgb, d_env = volrend.composite_bwd_plain(feat, dists, rgb, g, env=env)
    assert torch.equal(f.grad, d_feat) and torch.equal(c.grad, d_rgb)
    assert torch.equal(t.grad, envmap.envmap_bwd_plain(rays[:, 3:6], env, d_env, H_ENV))
    assert t.grad.abs().max() > 0


def test_envmap_form_launches_no_standalone_lookup():
    """The envmap form's Function takes its ``fwd``, ``bwd`` and ``env_bwd``
    from the Ops pair it is given: one composite and one K6b and K8b, and
    never the standalone K8."""
    feat, dists, z, rgb, ray_dz, table, rays, g = _problem(4)
    calls = []

    def counted(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call
    o = ops.PLAIN
    t = table.clone().requires_grad_(True)
    outs = volrend.composite_train(feat, dists, z, rgb.clone().requires_grad_(True), ray_dz,
                                   -8.0, 25.0, "softplus", counted("K6", o.composite),
                                   counted("K6b", o.composite_bwd), envmap=t,
                                   viewdirs=rays[:, 3:6], env_bwd=counted("K8b", o.envmap_bwd))
    outs[0].backward(g)
    assert calls == ["K6", "K6b", "K8b"]


def test_ops_registry_exposes_the_envmap_form():
    """``Ops.composite`` takes the envmap form on both sides, K6e on the
    kernels' side (its plain version on CPU tensors) and the plain
    composition on the other, with the same bits."""
    args = _envmap_args(_problem(5))
    got, want = ops.KERNELS.composite(*args), ops.PLAIN.composite(*args)
    assert ops.KERNELS.composite is volrend.composite
    assert ops.PLAIN.composite is volrend.composite_plain
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_envmap_form_rejects_what_it_does_not_take():
    p = _problem(6, r=4, s=8)
    args = _envmap_args(p)
    with pytest.raises(ValueError, match="no env and no gates"):
        volrend.composite(*args[:8], torch.zeros(4, 3), None, None, *args[11:])
    with pytest.raises(ValueError, match="no env and no gates"):
        volrend.composite(*args[:9], torch.ones(4, 8, dtype=torch.bool), None, *args[11:])
    with pytest.raises(ValueError, match=r"\(2h, h, 3\)"):
        volrend.composite(*args[:11], torch.zeros(6, 5, 3), args[12])
    with pytest.raises(ValueError, match="viewdirs"):
        volrend.composite(*args[:12], p[6][:3, 3:6])


# ---------------------------------------------------------------------------
# K6b's range of sample counts, the launch counts and the shared layout
# ---------------------------------------------------------------------------
def _bwd_case(r, s, seed):
    """K6b's arguments on ``r`` rays of ``s`` samples, with an env and a
    valid mask for the other two instantiations."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    feat = t(rng.normal(4.0, 5.0, (r, s)).astype(np.float32))
    dists = t(rng.uniform(0.0, 0.08, (r, s)).astype(np.float32))
    rgb = t(rng.uniform(-0.3, 1.3, (r, s, 3)).astype(np.float32))
    g = t(rng.normal(size=(r, 3)).astype(np.float32))
    env = t(rng.uniform(0.0, 1.0, (r, 3)).astype(np.float32))
    valid = t(rng.uniform(size=(r, s)) < 0.5)
    return feat, dists, rgb, g, env, valid


@pytest.mark.parametrize("s", [1, 2, 31, 32, 33, 96, 128, 255, 256, 257, 512, 1000, 1536])
def test_composite_bwd_takes_1_to_1536_samples(s):
    """Every sample count the wrapper takes reaches the plain version in
    each instantiation (EgoNeRF, env, gated), with its shapes and bits."""
    feat, dists, rgb, g, env, valid = _bwd_case(3, s, s)
    for kw in ({}, dict(env=env), dict(valid=valid, rgb_thres=1e-4)):
        got = volrend.composite_bwd(feat, dists, rgb, g, -8.0, 25.0, "softplus", **kw)
        want = volrend.composite_bwd_plain(feat, dists, rgb, g, -8.0, 25.0, "softplus", **kw)
        assert len(got) == (3 if "env" in kw else 2)
        assert got[0].shape == (3, s) and got[1].shape == (3, s, 3)
        for a, b in zip(got, want):
            assert torch.equal(a, b) and torch.isfinite(a).all()


def test_composite_bwd_rejects_sample_counts_outside_its_range():
    """A ray's staged rows must fit the 48 KB of a one-warp block: 1537
    samples are refused, as are none."""
    for s in (0, 1537):
        feat, dists, rgb, g, _, _ = _bwd_case(2, s, 7)
        with pytest.raises(ValueError, match="1..1536 samples"):
            volrend.composite_bwd(feat, dists, rgb, g)


def test_each_composite_form_has_its_own_launch_count():
    """K6, K6 with a given env and K6e count their launches apart, and the
    plain versions that CPU tensors take count none."""
    counts = (volrend.composite, volrend.composite.env_form, volrend.composite.envmap_form)
    assert len({id(c) for c in counts}) == 3
    before = [c.launches for c in counts]
    p = _problem(6, r=8, s=12)
    feat, dists, z, rgb, ray_dz, table, rays, _ = p
    volrend.composite(feat, dists, z, rgb, ray_dz)
    volrend.composite(feat, dists, z, rgb, ray_dz, env=torch.zeros(8, 3))
    volrend.composite(*_envmap_args(p))
    assert [c.launches for c in counts] == before


def _sw(i):
    """csrc/composite.cu's ``sw``: word i swizzled within its row of 32."""
    return i ^ ((i >> 5) & 31)


@pytest.mark.parametrize("s", [1, 33, 64, 96, 128, 256, 512, 1536])
def test_swizzle_is_a_permutation_within_each_row(s):
    per = -(-s // 32)
    words = np.arange(32 * per)
    phys = np.array([_sw(int(i)) for i in words])
    assert sorted(phys) == list(words)
    assert np.array_equal(phys // 32, words // 32)


@pytest.mark.parametrize("per", [1, 2, 4, 8, 16])
def test_swizzle_spreads_a_step_of_the_lanes_chunks_over_32_banks(per):
    """Lane l walks samples l per .. l per + per - 1; at each step the 32
    lanes' words sit in 32 banks (unswizzled, chunks of 8 would meet 8 to
    a bank)."""
    for k in range(per):
        banks = {_sw(lane * per + k) % 32 for lane in range(32)}
        assert len(banks) == 32
    if per == 8:
        assert len({(lane * per) % 32 for lane in range(32)}) == 4


def test_outdoor_model_takes_the_envmap_form():
    """The EgoNeRF outdoor forward composites through the envmap form (one
    composite a batch, no standalone K8) and its training step gives the
    table its gradient through K8b; the pretrain forward takes K8 alone.
    The values against JAX's are tests/test_torch_envmap.py's."""
    from test_torch_envmap import RENDER, _pair, _rays

    _, _, tm = _pair("float32", seed=4)
    calls = []

    def counted(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call
    tm.ops = ops.PLAIN._replace(**{k: counted(k, getattr(ops.PLAIN, k)) for k in (
        "composite", "composite_bwd", "envmap", "envmap_bwd")})
    params = tm.params()
    rays = torch.from_numpy(_rays(16, seed=5))
    out = tm.forward(params, rays, is_train=True, **RENDER)
    assert calls == ["composite"]
    assert torch.equal(out["env"], envmap.envmap_fwd_plain(params["envmap"].detach(),
                                                           rays[:, 3:6]))
    out["rgb"].sum().backward()
    assert calls == ["composite", "composite_bwd", "envmap_bwd"]
    assert params["envmap"].grad.abs().max() > 0
    calls.clear()
    env = tm.forward(params, rays, pretrain_envmap=True)["env"]
    assert calls == ["envmap"] and env.requires_grad
