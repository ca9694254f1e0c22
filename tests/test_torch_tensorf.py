"""The port's TensoRF slice against the JAX package, on the CPU, at the JAX
test's shape (aabb +-1.5, 24^3, n_lamb 4/8, app_dim 12, featureC 32): the
xyz chart and grid resampling, K1/K2/K3 on a stack of one grid, K9 (the
alpha-mask lookup), K6/K6b with the sample gates, TensorVMSplit's forward,
the regularizers in a training loss (and EgoNeRF's), the bake, checkpoints
with masks, the trainer's schedules, and the FieldConfig round trip.
Inputs come from numpy seeds and go to both sides."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.cartesian import CartesianCoords as JaxCartesian
from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models import model_meta as jax_model_meta
from egonerf_tpu.models.alphamask import AlphaGridMask as JaxMask
from egonerf_tpu.models.alphamask import YinYangAlphaGridMask as JaxYinYangMask
from egonerf_tpu.models.alphamask import bake_alpha_mask as jax_bake
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.tensorf import TensorVMSplit as JaxTensorVMSplit
from egonerf_tpu.ops import vm_lookup as jvm
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.ops.volrend import raw2alpha as jax_raw2alpha
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_tpu.train import trainer as jax_trainer
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch import ops, presets
from egonerf_torch.coords import coords_from_spec
from egonerf_torch.coords.cartesian import CartesianCoords
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.data.datasets import SyntheticEgoDataset
from egonerf_torch.models import (EgoNeRF, FieldConfig, TensorVMSplit, build_model,
                                  load_jax_checkpoint, params_from_jax, params_to_jax)
from egonerf_torch.models import model_meta
from egonerf_torch.models.alphamask import (AlphaGridMask, YinYangAlphaGridMask,
                                            bake_alpha_mask, dense_alpha)
from egonerf_torch.ops import alphamask, vm_lookup, volrend
from egonerf_torch.train.checkpoint import load_checkpoint, mask_volumes, save_checkpoint
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer, check_supported

AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
NEAR_FAR = (0.5, 3.5)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32, step_ratio=0.5)
RESO = [24, 24, 24]
MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(compute_dtype="bfloat16", **cfg):
    """The JAX and the port's TensorVMSplit with the same weights."""
    jc = JaxCartesian(AABB)
    jc.set_resolution(RESO)
    jm = JaxTensorVMSplit(AABB, RESO, jc, JaxFieldConfig(**SHAPE, compute_dtype=compute_dtype,
                                                         **cfg), near_far=NEAR_FAR)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tc = CartesianCoords(AABB)
    tc.set_resolution(RESO)
    tm = TensorVMSplit(AABB, RESO, tc, FieldConfig(**SHAPE, compute_dtype=compute_dtype, **cfg),
                       near_far=NEAR_FAR, device="cpu")
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.1, 0.1, size=(n, 3)).astype(np.float32)
    return np.concatenate([o, d], -1)


def _grads_of(params):
    return params_to_jax({k: p.grad for k, p in params.items()})


# ---------------------------------------------------------------------------
# the xyz chart and grid resampling
# ---------------------------------------------------------------------------
def test_xyz_chart_and_upsampling_match_jax():
    """The affine chart and ``up_sampling_VM`` (linear resampling of a plane
    over two axes, of a line over one): the same float32 operations, so
    equal to 1 ulp; N_to_reso and the spec round trip equal."""
    jc, tc = JaxCartesian(AABB * 1.3), CartesianCoords(AABB * 1.3)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    want = np.asarray(jc.normalize_coord(jc.from_cartesian(jnp.asarray(pts))))
    got = tc.normalize_coord(tc.from_cartesian(torch.from_numpy(pts))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    for n in (24 ** 3, 2_097_152, 5_000_000, 16_777_216):
        assert tc.N_to_reso(n) == jc.N_to_reso(n)
    jc.set_resolution([24, 20, 16])
    tc.set_resolution([24, 20, 16])
    back = coords_from_spec(jc.to_spec())
    assert isinstance(back, CartesianCoords) and back.to_spec() == jc.to_spec()
    target = [32, 29, 17]
    plane = rng.normal(size=(1, 20, 24, 5)).astype(np.float32)
    line = rng.normal(size=(1, 16, 5)).astype(np.float32)
    for arr, ids in ((plane, [1, 0]), (line, [2])):
        want = np.asarray(jc.up_sampling_VM(jnp.asarray(arr), target, ids=ids))
        got = tc.up_sampling_VM(torch.from_numpy(arr), target, ids=ids).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# K1, K2, K3 on a stack of one grid
# ---------------------------------------------------------------------------
def _single_grid(seed, n, c=12, hw=(6, 8), l=10):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    planes = [bf(rng.normal(size=(1, *hw, c)).astype(np.float32)) for _ in range(3)]
    lines = [bf(rng.normal(size=(1, l, c)).astype(np.float32)) for _ in range(3)]
    xyz = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    # a random flag column: a single grid ignores it, as JAX's sel=None
    flag = rng.integers(0, 2, (n, 1)).astype(np.float32)
    return planes, lines, xyz, np.concatenate([xyz, flag], -1)


def _jax_products(plane_fn, line_fn, planes, lines, xyz, n_density):
    c = jnp.asarray(xyz)

    def field(ps, ls):
        dens, app = 0.0, []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            pr = plane_fn(ps[i], c[:, m0], c[:, m1], None) * line_fn(ls[i], c[:, VEC_MODE[i]],
                                                                     None)
            dens = dens + jnp.maximum(jnp.sum(pr[:, :n_density[i]], axis=-1), 0.0)
            app.append(pr[:, n_density[i]:])
        return dens, jnp.concatenate(app, axis=-1)

    return field


@pytest.mark.parametrize("hat", [False, True], ids=["f32_lines", "hat_lines"])
def test_field_single_grid_matches_jax(hat):
    """K1's and K2's plain versions at S = 1 against JAX's lookups with
    sel=None (TensorVMSplit.compute_field): forward, and jax.vjp of the
    float32 custom VJPs.  float32 sums in another order: forward rel 1e-6,
    gradients rel 1e-5 of each tensor's largest entry.  The hat gate counts
    S * L rows."""
    n_density = (4, 4, 4)
    planes, lines, xyz, coords = _single_grid(0, 3000)
    assert vm_lookup.line_hat_ok(1 * 256, 4096 * 256) and vm_lookup.line_hat_ok(128, 4096 * 256)
    line_fn = jvm.sample_line_hat if hat else jvm.sample_line_packed
    plane_fn = jvm.sample_plane_packed_fastgrad if hat else jvm.sample_plane_packed
    field = _jax_products(plane_fn, line_fn, planes, lines, xyz, n_density)
    (want_d, want_a), vjp = jax.vjp(field, [jnp.asarray(p) for p in planes],
                                    [jnp.asarray(l) for l in lines])
    bf = [torch.tensor(t).to(torch.bfloat16) for t in planes + lines]
    c = torch.from_numpy(coords)
    got_d, got_a, mask = vm_lookup.field_fwd(c, bf[:3], bf[3:], n_density, (hat,) * 3,
                                             with_mask=True)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6, atol=1e-6)
    if hat:
        return  # the fastgrad planes scatter in bf16 (test_torch_grad bounds it)
    rng = np.random.default_rng(1)
    d_dens = rng.normal(size=3000).astype(np.float32)
    d_app = rng.normal(size=(3000, 24)).astype(np.float32)
    want_p, want_l = vjp((jnp.asarray(d_dens), jnp.asarray(d_app)))
    got_p, got_l = vm_lookup.field_bwd(c, bf[:3], bf[3:], torch.from_numpy(d_dens),
                                       torch.from_numpy(d_app), mask, n_density, (hat,) * 3)
    for g, w in zip(got_p + got_l, list(want_p) + list(want_l)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_density_single_grid_matches_jax():
    """K3's plain version at S = 1 over the real channels against JAX's
    compute_density_feature_only, whose tables are zero-padded to 32
    channels: the zeros add nothing, the sums go in another order: rel 1e-5."""
    planes, lines, xyz, coords = _single_grid(2, 2000, c=4)
    pad = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 28)])
    c = jnp.asarray(xyz)
    want = 0.0
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        p = jvm.sample_plane_packed(jnp.asarray(pad(planes[i])), c[:, m0], c[:, m1], None)
        l = jvm.sample_line_packed(jnp.asarray(pad(lines[i])), c[:, VEC_MODE[i]], None)
        want = want + jnp.maximum(jnp.sum(p * l, axis=-1), 0.0)
    bf = [torch.tensor(t).to(torch.bfloat16) for t in planes + lines]
    got = vm_lookup.density_fwd(torch.from_numpy(coords), bf[:3], bf[3:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="stacks of 1 or 2"):
        vm_lookup.density_fwd(torch.from_numpy(coords), [b.expand(3, -1, -1, -1).contiguous()
                                                         for b in bf[:3]], bf[3:])


# ---------------------------------------------------------------------------
# K9, the alpha-mask lookup
# ---------------------------------------------------------------------------
def test_alpha_lookup_matches_jax_masks():
    """K9's plain version against AlphaGridMask.sample_alpha and
    YinYangAlphaGridMask.sample_alpha (the packed-row lookup) on 9x11x13
    volumes (non-cubic, so a transposed axis cannot pass) with coords in
    [-1.25, 1.25], out-of-range cells included: the same eight terms
    summed in another order, abs 1e-6.  The mask classes keep JAX's
    ``volume``."""
    rng = np.random.default_rng(3)
    v1 = (rng.uniform(size=(9, 11, 13)) > 0.5).astype(np.float32)
    v2 = (rng.uniform(size=(9, 11, 13)) > 0.5).astype(np.float32)
    coords = rng.uniform(-1.25, 1.25, size=(6000, 3)).astype(np.float32)
    flag = rng.integers(0, 2, (6000, 1)).astype(np.float32)
    c4 = np.concatenate([coords, flag], -1)
    jm, tm = JaxMask(v1), AlphaGridMask(v1)
    want = np.asarray(jm.sample_alpha(jnp.asarray(coords)))
    for c in (coords, c4):  # a single volume ignores the flag
        got = tm.sample_alpha(torch.from_numpy(c), alphamask.alpha_fwd).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.volume, np.asarray(jm.volume))
    jy, ty = JaxYinYangMask(v1, v2), YinYangAlphaGridMask(v1, v2)
    want = np.asarray(jy.sample_alpha(jnp.asarray(c4)))
    got = ty.sample_alpha(torch.from_numpy(c4), alphamask.alpha_fwd).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ty.volume, np.asarray(jy.volume))
    # occupancies in [0, 1] up to the float32 rounding of the sum
    assert ((got > 0) & (got < 1)).any() and got.min() >= 0.0 and got.max() <= 1.0 + 1e-6
    with pytest.raises(ValueError):
        alphamask.alpha_fwd(torch.from_numpy(coords), ty.vol)  # two grids need the flag


# ---------------------------------------------------------------------------
# K6 and K6b with the gates
# ---------------------------------------------------------------------------
THRES = 1e-2


def _gated_problem(seed, r=48, s=40):
    rng = np.random.default_rng(seed)
    feat = rng.normal(6.0, 5.0, (r, s)).astype(np.float32)
    dists = rng.uniform(0.0, 0.08, (r, s)).astype(np.float32)
    rgb = rng.uniform(-0.3, 1.3, (r, s, 3)).astype(np.float32)
    valid = rng.uniform(size=(r, s)) > 0.3
    z = np.cumsum(dists, -1).astype(np.float32)
    dz = rng.normal(size=r).astype(np.float32)
    g = rng.normal(size=(r, 3)).astype(np.float32)
    return feat, dists, z, rgb, dz, valid, g


def _jax_gated(feat, dists, z, rgb, dz, valid):
    def run(f, c):
        sigma = jnp.where(jnp.asarray(valid), jax.nn.softplus(f - 8.0), 0.0)
        _, weight, _ = jax_raw2alpha(sigma, jnp.asarray(dists) * 25.0)
        c = jnp.where((weight > THRES)[..., None], c, 0.0)
        acc = jnp.sum(weight, -1)
        depth = jnp.sum(weight * jnp.asarray(z), -1) + (1.0 - acc) * jnp.asarray(dz)
        return jnp.clip(jnp.sum(weight[..., None] * c, -2), 0.0, 1.0), (depth, acc, weight)

    return run


def test_gated_composite_matches_jax():
    """K6's and K6b's plain versions with ``valid`` and the rgb gate against
    JAX's TensoRF composite (tensorf.py:226-258) and its jax.vjp.  No weight
    lies within 1e-5 of the gate here, so both take the same samples; the
    rest is float32 sums in another order: rel 1e-5 of the largest entry."""
    feat, dists, z, rgb, dz, valid, g = _gated_problem(0)
    run = _jax_gated(feat, dists, z, rgb, dz, valid)
    want_rgb, (want_depth, want_acc, weight) = run(jnp.asarray(feat), jnp.asarray(rgb))
    w = np.asarray(weight)
    assert np.abs(w - THRES).min() > 1e-5 * THRES
    assert (w > THRES).any() and ((w > 0) & (w <= THRES)).any()
    t = {k: torch.from_numpy(v) for k, v in dict(feat=feat, dists=dists, z=z, rgb=rgb, dz=dz,
                                                  valid=valid, g=g).items()}
    got = volrend.composite(t["feat"], t["dists"], t["z"], t["rgb"], t["dz"], -8.0, 25.0,
                            "softplus", None, t["valid"], THRES)
    for o, want in zip(got[:3], (want_rgb, want_depth, want_acc)):
        want = np.asarray(want)
        np.testing.assert_allclose(o.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    _, vjp = jax.vjp(lambda f, c: run(f, c)[0], jnp.asarray(feat), jnp.asarray(rgb))
    want_f, want_c = vjp(jnp.asarray(g))
    got_f, got_c = volrend.composite_bwd(t["feat"], t["dists"], t["rgb"], t["g"], -8.0, 25.0,
                                         "softplus", None, t["valid"], THRES)
    for o, want in ((got_f, want_f), (got_c, want_c)):
        want = np.asarray(want)
        np.testing.assert_allclose(o.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # invalid samples take no density gradient, gated samples no rgb gradient
    assert (got_f.numpy()[~valid] == 0).all()
    assert (got_c.numpy()[w <= THRES] == 0).all()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked, exp", [(False, False), (True, False), (False, True)],
                         ids=["no_mask", "mask", "exp_sampling"])
def test_forward_eval_matches_jax(masked, exp):
    """TensorVMSplit.forward at key=None (the render path: K9 gate, K1 on
    the bf16 tables, the shader, K6) against JAX's, with and without a
    16^3 mask of about half occupancy, and with exponential steps: rgb abs
    1e-5, depth abs 1e-4 (as EgoNeRF's eval test; float32 sums in another
    order)."""
    jm, jp, tm = _pair()
    if masked:
        vol = (np.random.default_rng(5).uniform(size=(16, 16, 16)) > 0.5).astype(np.float32)
        jm.alpha_mask, tm.alpha_mask = JaxMask(vol), AlphaGridMask(vol)
    rays = _rays(64, seed=5)
    want = jax.jit(lambda p, r: jm.forward(p, r, n_coarse=40, exp_sampling=exp))(
        jp, jnp.asarray(rays))
    with torch.no_grad():
        params = tm.params()
        got = tm.forward(params, torch.from_numpy(rays), n_coarse=40, exp_sampling=exp,
                         tables=tm.lookup_tables(params))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)


LOSS_W = dict(ortho=1e-3, l1=1e-4, tv_d=0.1, tv_a=0.05)


def _jax_loss(jm, rays, rgbs, fwd_kw):
    def loss_fn(p):
        out = jm.forward(p, jnp.asarray(rays), is_train=True, **fwd_kw)
        return (jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2)
                + LOSS_W["ortho"] * jm.vector_comp_diffs(p) + LOSS_W["l1"] * jm.density_l1(p)
                + LOSS_W["tv_d"] * jm.tv_loss_density(p) + LOSS_W["tv_a"] * jm.tv_loss_app(p))
    return loss_fn


def _port_loss(tm, rays, rgbs, fwd_kw):
    params = tm.params()
    out = tm.forward(params, torch.from_numpy(rays), is_train=True, **fwd_kw)
    loss = (torch.mean((out["rgb"] - torch.from_numpy(rgbs)) ** 2)
            + LOSS_W["ortho"] * tm.vector_comp_diffs(params)
            + LOSS_W["l1"] * tm.density_l1(params)
            + LOSS_W["tv_d"] * tm.tv_loss_density(params)
            + LOSS_W["tv_a"] * tm.tv_loss_app(params))
    loss.backward()
    return loss.item(), _grads_of(params)


def _egonerf_pair():
    aabb = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
    kw = dict(exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    jc, tc = JaxYinYang(aabb, **kw), YinYangSphericalCoords(aabb, **kw)
    shape = dict(SHAPE, compute_dtype="float32")
    jm = JaxEgoNeRF(aabb, jc.resolution, jc, JaxFieldConfig(**shape), near_far=(0.05, 8.5))
    tm = EgoNeRF(aabb, tc.resolution, tc, FieldConfig(**shape), near_far=(0.05, 8.5),
                 device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


@pytest.mark.parametrize("model", ["TensorVMSplit", "TensorVMSplit_mask", "EgoNeRF"])
def test_training_loss_with_regularizers_matches_jax(model):
    """One training loss, MSE + Ortho + L1 + TV (the trainer's terms), and
    every gradient against jax.value_and_grad, in float32 lookups so both
    sides sum the plane gradients in float32: loss rel 1e-5, gradients rel
    1e-4 of each tensor's largest entry (float32 sums in another order)."""
    rng = np.random.default_rng(7)
    rays = _rays(64, seed=6)
    rgbs = rng.uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if model == "EgoNeRF":
        jm, jp, tm = _egonerf_pair()
        rays[:, :3] *= 2.0
        kw = dict(n_coarse=16, n_fine=16)
        k_coarse, k_pdf = jax.random.split(key)
        draws = dict(jitter=torch.tensor(np.asarray(jax.random.uniform(k_coarse, (64, 16)))),
                     u=torch.tensor(np.asarray(jax_sorted_uniform(k_pdf, (64, 16)))))
    else:
        jm, jp, tm = _pair("float32")
        if model.endswith("mask"):
            vol = (np.random.default_rng(8).uniform(size=(12, 12, 12)) > 0.4).astype(np.float32)
            jm.alpha_mask, tm.alpha_mask = JaxMask(vol), AlphaGridMask(vol)
        kw = dict(n_coarse=32)
        draws = dict(jitter=torch.tensor(np.asarray(jax.random.uniform(key, (64, 32)))))
    want_loss, want = jax.jit(jax.value_and_grad(_jax_loss(jm, rays, rgbs,
                                                           dict(kw, key=key))))(jp)
    loss, got = _port_loss(tm, rays, rgbs, dict(kw, **draws))
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_ckpt._flatten(want)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["TensorVMSplit", "EgoNeRF"])
def test_bake_matches_jax(model):
    """``update_alpha_mask`` on a non-cubic 9x11x13 bake grid against JAX's,
    with the density tables scaled x20 so that alphas spread over (0, 1):
    the dense alpha (K3's channel sums in another order, which JAX's jit
    also contracts into FMAs, held to rel 1e-5 of the feature as EgoNeRF's
    density test holds them, and linspace points an ulp apart: abs 2e-5 on
    alphas in (0, 1)), and the baked volumes equal except where the 3^3
    dilation reaches a cell whose JAX alpha lies within 1e-6 (relative) of
    the threshold, which may bake the other way."""
    gs = [9, 11, 13]
    jm, jp, tm = _egonerf_pair() if model == "EgoNeRF" else _pair()
    for k in ("density_planes", "density_lines"):
        jp[k] = [20.0 * a for a in jp[k]]
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    if model == "EgoNeRF":
        want_alpha = np.stack([np.asarray(a) for a in jm.get_dense_alpha(jp, gs)])
    else:
        want_alpha = np.asarray(jm.get_dense_alpha(jp, gs))[None]
    assert ((want_alpha > 0.1) & (want_alpha < 0.9)).mean() > 0.1
    params = tm.params()
    planes = [params[f"density_planes.{i}"].detach().to(torch.bfloat16) for i in range(3)]
    lines = [params[f"density_lines.{i}"].detach().to(torch.bfloat16) for i in range(3)]

    def alpha_of(c):  # the bakes' alpha: K3, feature2density, the step length
        sigma = volrend.density_activation(ops.density_fwd(c, planes, lines), -8.0, "softplus")
        return 1.0 - torch.exp(-sigma * tm.step_size)

    got_alpha = np.stack([a.numpy() for a in dense_alpha(alpha_of, gs, "cpu",
                                                          n_grids=want_alpha.shape[0])])
    np.testing.assert_allclose(got_alpha, want_alpha, rtol=0, atol=2e-5)
    thres = float(np.quantile(want_alpha, 0.9))  # about half the cells after dilation
    jm.cfg = dataclasses.replace(jm.cfg, alpha_mask_thres=thres)
    tm.cfg = dataclasses.replace(tm.cfg, alpha_mask_thres=thres)
    jm.update_alpha_mask(jp, gs)
    tm.update_alpha_mask(params, gs)
    want_vol = np.asarray(jm.alpha_mask.volume)[..., 0]
    got_vol = tm.alpha_mask.volume[..., 0]
    assert got_vol.shape == want_vol.shape == (want_alpha.shape[0], 13, 11, 9)
    assert 0.2 < want_vol.mean() < 0.8
    near = np.abs(want_alpha - thres) <= 1e-6 * thres
    near = np.stack([np.asarray(jax_bake(jnp.asarray(n.astype(np.float32)), 0.5))
                     for n in near]) > 0
    assert np.all((got_vol == want_vol) | near)
    # the port's bake alone on JAX's alpha: equal
    for a, v in zip(want_alpha, want_vol):
        np.testing.assert_array_equal(bake_alpha_mask(torch.from_numpy(a), thres).numpy(), v)


# ---------------------------------------------------------------------------
# checkpoints, the trainer, the FieldConfig repair
# ---------------------------------------------------------------------------
def _tiny_cfg(tmp_path, **over):
    return presets.tensorf_overrides(**{**dict(
        n_iters=10, N_voxel_init=10 ** 3, N_voxel_final=16 ** 3, upsamp_list="[2,5,20]",
        update_AlphaMask_list="[3,7]", n_coarse=16, batch_size=128, n_lamb_sigma="[4,4,4]",
        n_lamb_sh="[8,8,8]", data_dim_color=12, featureC=32, progress_refresh_rate=5,
        TV_weight_density=0.1, TV_weight_app=0.1, Ortho_weight=1e-3, basedir=str(tmp_path),
        expname="tf", N_vis=0, i_weights=10 ** 7, eval_chunk=512, render_test=False), **over})


def _install_tiny_scene(trainer):
    ds = dict(n_train=2, n_test=1, height=8, width=16, near_far=trainer.cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", **ds),
                         SyntheticEgoDataset(split="test", is_stack=True, **ds))


def test_trainer_schedules_fire_where_jax_fires(tmp_path, monkeypatch):
    """A tiny TensorVMSplit run: the bakes fire after the steps of
    ``update_AlphaMask_list``, the L1 weight switches to the rest weight
    after the first, the upsamples fire after the steps of ``upsamp_list``
    below n_iters on JAX's log-linear voxel counts, each rebuilding Adam
    with fresh moments (the bake does not); the TV weights follow JAX's
    closed form; a resumed run realigns the voxel list and the L1 weight
    as JAX's trainer does."""
    cfg = load_config(overrides=_tiny_cfg(tmp_path))
    jcfg = jax_load_config(overrides=_tiny_cfg(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    _install_tiny_scene(trainer)
    assert trainer.model.grid_size == [10, 10, 10] and trainer.coords.resolution == [10] * 3
    # JAX's schedule, from its trainer's own formulas (trainer.py:200-210)
    ups = jcfg.upsamp_list
    want_voxels = np.round(np.exp(np.linspace(np.log(jcfg.N_voxel_init),
                                              np.log(jcfg.N_voxel_final),
                                              len(ups) + 1))).astype(np.int64).tolist()[1:]
    assert trainer.n_voxel_list == want_voxels and trainer.upsamp_list == [2, 5]
    events, opt_ids = [], []
    for name in ("update_alpha_mask", "upsample"):
        orig = getattr(Trainer, name)

        def record(self, *a, _orig=orig, _name=name):
            events.append((_name, self._step_it, self.l1_weight))
            return _orig(self, *a)
        monkeypatch.setattr(Trainer, name, record)
    step = Trainer.train_step

    def recording_step(self, it):
        self._step_it = it
        opt_ids.append((it, id(self.optimizer), self.optimizer.count))
        return step(self, it)
    monkeypatch.setattr(Trainer, "train_step", recording_step)
    trainer.train()
    assert events == [("upsample", 2, 8e-5), ("update_alpha_mask", 3, 8e-5),
                      ("upsample", 5, 4e-5), ("update_alpha_mask", 7, 4e-5)]
    assert trainer.model.grid_size == trainer.coords.N_to_reso(want_voxels[1])
    assert trainer.model.alpha_mask.grid_size == tuple(trainer.model.grid_size)
    # Adam rebuilt with fresh moments and count 0 after each upsample only
    firsts = {it: (oid, count) for it, oid, count in opt_ids}
    assert firsts[3][1] == 0 and firsts[6][1] == 0 and firsts[4][1] == 1 and firsts[8][1] == 2
    assert firsts[3][0] == firsts[4][0] != firsts[6][0]
    # the TV weights: JAX's in-step closed form (trainer.py:265-275)
    for it in (0, 4, 9):
        f = float(np.float32(trainer.lr_factor) ** np.float32(it + 1))
        assert trainer.tv_weights(it) == pytest.approx((0.1 * f, 0.1 * f), rel=1e-6)
    # resume past the first bake and the first upsample
    resumed = Trainer(cfg, device="cpu")
    assert resumed.start_step == 10 and resumed.l1_weight == 4e-5
    assert resumed.l1_weight == jax_trainer.initial_l1_weight(jcfg, 10)
    assert resumed.n_voxel_list == [want_voxels[2]]
    assert resumed.model.alpha_mask is not None
    assert resumed.model.grid_size == trainer.coords.N_to_reso(want_voxels[1])
    assert check_supported(cfg) is None


def test_checkpoints_with_masks_both_ways(tmp_path):
    """The port writes its masks as JAX does (bit-packed under
    __alphamask__, one per grid) and restores JAX's: a TensorVMSplit with
    one volume and an EgoNeRF with two, through JAX's load_checkpoint and
    save_checkpoint."""
    jm, jp, tm = _pair()
    vol = (np.random.default_rng(9).uniform(size=(7, 8, 9)) > 0.5)
    tm.alpha_mask = AlphaGridMask(vol)
    path = os.path.join(str(tmp_path), "port.npz")
    save_checkpoint(path, tm.params(), global_step=3, coords_spec=tm.coordinates.to_spec(),
                    model_meta=model_meta(None, tm), alpha_masks=mask_volumes(tm))
    flat, header, masks = jax_ckpt.load_checkpoint(path)
    assert list(masks) == ["alpha_0"] and np.array_equal(masks["alpha_0"], vol)
    jax_trainer.Trainer.restore_alpha_mask(jm, masks)
    np.testing.assert_array_equal(np.asarray(jm.alpha_mask.volume), tm.alpha_mask.volume)
    # JAX -> port: an EgoNeRF with a yin-yang mask, and the TensoRF one
    ejm, ejp, _ = _egonerf_pair()
    v2 = ~vol
    out = os.path.join(str(tmp_path), "jax.npz")
    jax_ckpt.save_checkpoint(out, ejp, global_step=5, coords_spec=ejm.coordinates.to_spec(),
                             model_meta=jax_model_meta(None, ejm),
                             alpha_masks={"alpha_0": vol, "alpha_1": v2})
    model, params, header = load_jax_checkpoint(out, device="cpu")
    assert isinstance(model, EgoNeRF) and isinstance(model.alpha_mask, YinYangAlphaGridMask)
    np.testing.assert_array_equal(model.alpha_mask.volume[..., 0], np.stack([vol, v2]))
    model, params, header = load_jax_checkpoint(path, device="cpu")
    assert isinstance(model, TensorVMSplit) and header["global_step"] == 3
    np.testing.assert_array_equal(model.alpha_mask.volume[0, ..., 0], vol)
    for k, v in flat.items():
        np.testing.assert_array_equal(params_to_jax(params)[k], v, err_msg=k)


def test_jax_thresholds_survive_a_port_save(tmp_path):
    """The FieldConfig repair: a JAX checkpoint made with other thresholds
    (pos_pe, ray_march_weight_thres, alpha_mask_thres, step_ratio) resumes
    in the port under a config with the defaults, and the port's next
    checkpoint stores the checkpoint's values, not the config's."""
    jfield = dict(pos_pe=4, ray_march_weight_thres=3e-3, alpha_mask_thres=2e-2, step_ratio=0.8)
    cfg = load_config(overrides=_tiny_cfg(tmp_path, n_iters=4, upsamp_list="[100]",
                                          update_AlphaMask_list="[100]"))
    # the model's aabb is the trainer's scene's, as in JAX (only the chart's
    # comes from the checkpoint)
    aabb = SyntheticEgoDataset(split="train", near_far=cfg.near_far).scene_bbox
    jc = JaxCartesian(aabb)
    jc.set_resolution([10, 10, 10])
    jm = JaxTensorVMSplit(aabb, [10] * 3, jc, JaxFieldConfig(**dict(SHAPE, **jfield)),
                          near_far=NEAR_FAR)
    logdir = os.path.join(str(tmp_path), "tf")
    jax_ckpt.save_checkpoint(os.path.join(logdir, "tf_000002.npz"),
                             jm.init_params(jax.random.PRNGKey(3)), global_step=2,
                             coords_spec=jc.to_spec(), model_meta=jax_model_meta(None, jm))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.start_step == 2 and trainer.model.step_size == pytest.approx(jm.step_size)
    _install_tiny_scene(trainer)
    trainer.train()
    _, header = load_checkpoint(os.path.join(logdir, "tf.npz"))
    meta = header["model_meta"]
    assert {k: meta[k] for k in jfield} == jfield
    assert meta == {**jax_model_meta(None, jm), "density_n_comp": [4, 4, 4],
                    "app_n_comp": [8, 8, 8]}


def test_build_model_refuses_tensorvm_and_tensorcp(tmp_path):
    """The port builds every TensoRF member that JAX builds (it refused
    TensorVM and TensorCP before they were ported; the name is kept): each
    config's model_name gives that class, on the xyz chart."""
    from egonerf_torch.models import TensorCP, TensorVM

    cfg = load_config(overrides=_tiny_cfg(tmp_path))
    tc = CartesianCoords(AABB)
    tc.set_resolution(RESO)
    assert isinstance(build_model(cfg, AABB, RESO, tc, NEAR_FAR, device="cpu"), TensorVMSplit)
    for name, cls in (("TensorVM", TensorVM), ("TensorCP", TensorCP)):
        other = load_config(overrides=_tiny_cfg(tmp_path, model_name=name))
        model = build_model(other, AABB, RESO, tc, NEAR_FAR, device="cpu")
        assert type(model) is cls and model.name == name


def test_cli_trains_tensorvmsplit(tmp_path, monkeypatch):
    """``python -m egonerf_torch`` builds and trains TensorVMSplit from the
    tensorf preset's flags (on the CPU here: the entry points' device
    resolution is pointed there), and ``--evaluation 1`` renders the test
    set from the checkpoint it wrote."""
    from egonerf_torch import __main__ as cli
    from egonerf_torch.models import convert
    from egonerf_torch.models import tensorf as tensorf_module
    from egonerf_torch.train import trainer as trainer_module

    for module in (trainer_module, tensorf_module, convert):
        monkeypatch.setattr(module, "resolve_device", lambda device="cuda": torch.device("cpu"))
    argv = []
    for k, v in _tiny_cfg(tmp_path, n_iters=4, progress_refresh_rate=2).items():
        argv += [f"--{k}", str(v)]
    cli.main(argv)
    _, header = load_checkpoint(os.path.join(str(tmp_path), "tf", "tf.npz"))
    assert header["model_meta"]["model_name"] == "TensorVMSplit"
    assert header["coords_spec"]["name"] == "xyz" and header["global_step"] == 4
    cli.main(argv + ["--evaluation", "1"])
    row = np.loadtxt(os.path.join(str(tmp_path), "tf", "evaluation", "mean.txt"))
    assert row.shape == (5,) and np.isfinite(row[0])
