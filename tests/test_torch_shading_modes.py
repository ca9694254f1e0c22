"""The port's five shading modes against the JAX package's, on the CPU:
each mode's shader (and SH's bases of every degree), SH's gradient at an
exact tie, RGB's width check, EgoNeRF's and TensorVMSplit's eval forward
and training step under each mode, the hoist only for MLP_Fea, the MLP
modes under the opt-in forms (K10, K11), checkpoints of each mode both
ways, and the config default.  Inputs come from numpy seeds and go to both
sides; the JAX switch and the port's are flipped together."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.cartesian import CartesianCoords as JaxCartesian
from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models import model_meta as jax_model_meta
from egonerf_tpu.models import shading as jsh
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.tensorf import TensorVMSplit as JaxTensorVMSplit
from egonerf_tpu.ops import mm as jmm
from egonerf_tpu.ops import sh as jax_sh
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch import ops
from egonerf_torch.coords.cartesian import CartesianCoords
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.models import (EgoNeRF, FieldConfig, TensorVMSplit, load_jax_checkpoint,
                                  model_meta, params_from_jax, params_to_jax)
from egonerf_torch.models import shading as tsh
from egonerf_torch.ops import sh as port_sh
from egonerf_torch.train.checkpoint import save_checkpoint
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer

from test_torch_shader_forms import flip
from test_torch_tensorf import _jax_loss, _port_loss, _rays

MODES = ["MLP_Fea", "MLP_PE", "MLP", "SH", "RGB"]
# each mode's appearance width: SH reads 3 x 9 degree-2 coefficients, RGB
# the colour itself
APP_DIM = {"SH": 27, "RGB": 3}
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), view_pe=2, fea_pe=2, pos_pe=3,
             feature_c=32)
EGO_AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
TF_AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
RENDER = dict(n_coarse=16, n_fine=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode, compute_dtype="float32"):
    return dict(SHAPE, app_dim=APP_DIM.get(mode, 12), shading_mode=mode,
                compute_dtype=compute_dtype)


def _ego_pair(mode, compute_dtype="float32"):
    kw = dict(exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    jc, tc = JaxYinYang(EGO_AABB, **kw), YinYangSphericalCoords(EGO_AABB, **kw)
    cfg = _cfg(mode, compute_dtype)
    jm = JaxEgoNeRF(EGO_AABB, jc.resolution, jc, JaxFieldConfig(**cfg), near_far=(0.05, 8.5))
    tm = EgoNeRF(EGO_AABB, tc.resolution, tc, FieldConfig(**cfg), near_far=(0.05, 8.5),
                 device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


def _tf_pair(mode, compute_dtype="float32"):
    reso = [24, 24, 24]
    jc, tc = JaxCartesian(TF_AABB), CartesianCoords(TF_AABB)
    jc.set_resolution(reso)
    tc.set_resolution(reso)
    cfg = _cfg(mode, compute_dtype)
    jm = JaxTensorVMSplit(TF_AABB, reso, jc, JaxFieldConfig(**cfg), near_far=(0.5, 3.5))
    tm = TensorVMSplit(TF_AABB, reso, tc, FieldConfig(**cfg), near_far=(0.5, 3.5),
                       device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


def _shader_inputs(app_dim, r=29, s=13, seed=7):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(r, s, app_dim)).astype(np.float32)
    dirs = rng.normal(size=(r, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = np.broadcast_to(dirs[:, None, :], (r, s, 3)).copy()
    pts = rng.uniform(-1.1, 1.1, size=(r, s, 4)).astype(np.float32)
    return feats, dirs, pts


def _port_params(jp):
    """JAX's shader parameters as ``nn.Linear``-layout leaves with grads."""
    params = {}
    for i in (1, 2, 3):
        params[f"shader.l{i}.weight"] = torch.tensor(np.asarray(jp[f"l{i}"]["w"]).T.copy(),
                                                     requires_grad=True)
        params[f"shader.l{i}.bias"] = torch.tensor(np.asarray(jp[f"l{i}"]["b"]),
                                                   requires_grad=True)
    return params


def _shader_case(mode, mixed=False):
    """(want, want grads, got, got grads) of the shader alone on seeded
    inputs: the output, the gradient of sum(out ** 2) in the features, the
    pts and every parameter."""
    app_dim = APP_DIM.get(mode, 12)
    feats, dirs, pts = _shader_inputs(app_dim)
    shader = jsh.make_shader(mode, app_dim, pos_pe=3, view_pe=2, fea_pe=2, feature_c=32,
                             matmul=jmm.mixed_matmul if mixed else None)
    jp = shader.init(jax.random.PRNGKey(3)) if shader.init else None

    def jax_loss(p, f, x):
        return jnp.sum(shader.apply(p, x, jnp.asarray(dirs), f) ** 2)

    want = np.asarray(shader.apply(jp, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(feats)))
    want_g = jax.grad(jax_loss, argnums=(0, 1, 2))(jp, jnp.asarray(feats), jnp.asarray(pts))
    port = tsh.make_shader(mode, app_dim, pos_pe=3, view_pe=2, fea_pe=2, feature_c=32)
    params = _port_params(jp) if jp is not None else {}
    tf = torch.from_numpy(feats).requires_grad_(True)
    tp = torch.from_numpy(pts).requires_grad_(True)
    got = port.apply_params(params, "shader.", torch.from_numpy(dirs), tf, ops.PLAIN, mixed,
                            pts=tp)
    (got ** 2).sum().backward()
    pairs = [(tf.grad.numpy(), np.asarray(want_g[1])),
             (tp.grad.numpy() if tp.grad is not None else np.zeros_like(pts),
              np.asarray(want_g[2]))]
    if jp is not None:
        for i in (1, 2, 3):
            pairs.append((params[f"shader.l{i}.weight"].grad.numpy().T,
                          np.asarray(want_g[0][f"l{i}"]["w"])))
            pairs.append((params[f"shader.l{i}.bias"].grad.numpy(),
                          np.asarray(want_g[0][f"l{i}"]["b"])))
    return want, got.detach().numpy(), pairs


@pytest.mark.parametrize("mode", MODES)
def test_shader_matches_jax(mode):
    """Each mode's shader against JAX's ``make_shader`` on seeded features,
    directions and (4-wide) normalized coords: the output within 1e-6 and
    every gradient (features, pts, parameters) within 1e-5 of its largest
    entry: float32 sums in another order (as the MLP_Fea forms test holds
    them).  MLP_PE reads pts[..., :3]; the other modes give pts no
    gradient."""
    want, got, pairs = _shader_case(mode)
    assert got.shape == want.shape == (29, 13, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for g, w in pairs:
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-12)
    if mode != "MLP_PE":
        assert not np.any(pairs[1][1])


@pytest.mark.parametrize("mode", ["MLP_PE", "MLP"])
@pytest.mark.parametrize("form", ["bias_dot", "mixed"])
def test_mlp_modes_under_the_forms_match_jax(mode, form, monkeypatch):
    """MLP_PE and MLP under ``EGONERF_BIAS_DOT`` (each bias through K11's
    Function) and with ``mixed_matmul`` (K10, as EgoNeRF passes it under
    ``EGONERF_MIXED_MM``) against JAX's: the bias form within the float32
    limits above; the mixed form within the MLP_Fea forms test's bf16
    limits (output 5e-4, each gradient 1e-3 of its norm and 2**-6 of its
    largest entry: one bf16 ulp of a hidden unit)."""
    mixed = form == "mixed"
    if not mixed:
        flip(monkeypatch, BIAS_DOT=True)
    want, got, pairs = _shader_case(mode, mixed)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 if mixed else 1e-6)
    for g, w in pairs:
        if not np.any(w):
            continue
        if mixed:
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)
            assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_bases_match_jax(deg):
    """``eval_sh_bases`` and ``eval_sh`` of every degree on seeded unit and
    non-unit directions: the same float32 polynomials in the same order,
    within 2 float32 ulps of their size (rel 2.4e-7 x 4)."""
    rng = np.random.default_rng(deg)
    dirs = rng.normal(size=(257, 3)).astype(np.float32)
    dirs[:128] /= np.linalg.norm(dirs[:128], axis=-1, keepdims=True)
    want = np.asarray(jax_sh.eval_sh_bases(deg, jnp.asarray(dirs)))
    got = port_sh.eval_sh_bases(deg, torch.from_numpy(dirs)).numpy()
    assert got.shape == want.shape == (257, (deg + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    sh = rng.normal(size=(257, 3, (deg + 1) ** 2)).astype(np.float32)
    want = np.asarray(jax_sh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    got = port_sh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        port_sh.eval_sh_bases(5, torch.from_numpy(dirs))


def test_sh_gradient_at_an_exact_tie():
    """SH's rgb is relu(x + 0.5) by ``jnp.maximum``, whose gradient at
    exactly 0 is half: features whose contraction is exactly -0.5 (the
    first coefficient times C0, the others 0) give rgb 0 and half the
    cotangent in both packages; just above and below, all and none."""
    c0 = np.float32(port_sh.C0)
    c = np.float32(-0.5) / c0
    while np.float32(c * c0) != np.float32(-0.5):
        c = np.nextafter(c, np.float32(0.0), dtype=np.float32)
    feats = np.zeros((3, 1, 27), np.float32)
    for row, coef in enumerate((c, c * np.float32(1.01), c * np.float32(0.99))):
        feats[row, 0, 0] = coef
    dirs = np.tile(np.array([[[0.6, 0.0, 0.8]]], np.float32), (3, 1, 1))
    shader = jsh.make_shader("SH", 27)
    want_out = np.asarray(shader.apply(None, None, jnp.asarray(dirs), jnp.asarray(feats)))
    want_g = np.asarray(jax.grad(lambda f: jnp.sum(shader.apply(
        None, None, jnp.asarray(dirs), f)))(jnp.asarray(feats)))
    tf = torch.from_numpy(feats).requires_grad_(True)
    got = tsh.SH().apply_params({}, "shader.", torch.from_numpy(dirs), tf)
    got.sum().backward()
    assert want_out[0, 0, 0] == 0.0 and want_out[1, 0, 0] == 0.0 and want_out[2, 0, 0] > 0.0
    np.testing.assert_array_equal(got.detach().numpy(), want_out)
    np.testing.assert_array_equal(tf.grad.numpy(), want_g)
    assert tf.grad[0, 0, 0] == pytest.approx(0.5 * c0) and tf.grad[1, 0, 0] == 0.0
    assert tf.grad[2, 0, 0] == pytest.approx(c0)


def test_rgb_needs_three_channels():
    """RGB is the colour itself: JAX asserts app_dim == 3; the port raises
    a ``ValueError`` saying so, in the factory and in both models."""
    with pytest.raises(AssertionError):
        jsh.make_shader("RGB", 12)
    with pytest.raises(ValueError, match="app_dim == 3"):
        tsh.make_shader("RGB", 12)
    for cls, aabb, coords in ((EgoNeRF, EGO_AABB, YinYangSphericalCoords(
            EGO_AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05)), (TensorVMSplit, TF_AABB,
                                                               CartesianCoords(TF_AABB))):
        coords.set_resolution(coords.resolution or [8, 8, 8])
        with pytest.raises(ValueError, match="app_dim == 3"):
            cls(aabb, [8, 8, 8], coords, FieldConfig(**dict(_cfg("RGB"), app_dim=12)),
                device="cpu")
    with pytest.raises(ValueError, match="Unrecognized"):
        tsh.make_shader("MLP_XX", 12)
    assert tsh.make_shader("RGB", 3).apply_params({}, "", None, torch.ones(2, 3)).shape == (2, 3)


# ---------------------------------------------------------------------------
# the models under each mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["EgoNeRF", "TensorVMSplit"])
@pytest.mark.parametrize("mode", MODES)
def test_training_step_matches_jax(mode, model):
    """One training loss (MSE + Ortho + L1 + TV) and every gradient under
    the mode against ``jax.value_and_grad`` with JAX's draws, float32
    lookups: loss rel 1e-5, each gradient abs 1e-4 of its largest entry
    (float32 sums in another order, as tests/test_torch_tensorf.py holds
    the default mode); the shader's keys are JAX's (none for SH and RGB)."""
    rng = np.random.default_rng(7)
    rays = _rays(64, seed=6)
    rgbs = rng.uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if model == "EgoNeRF":
        jm, jp, tm = _ego_pair(mode)
        rays[:, :3] *= 2.0
        kw = dict(RENDER)
        k_coarse, k_pdf = jax.random.split(key)
        draws = dict(jitter=torch.tensor(np.asarray(jax.random.uniform(k_coarse, (64, 16)))),
                     u=torch.tensor(np.asarray(jax_sorted_uniform(k_pdf, (64, 16)))))
    else:
        jm, jp, tm = _tf_pair(mode)
        kw = dict(n_coarse=32)
        draws = dict(jitter=torch.tensor(np.asarray(jax.random.uniform(key, (64, 32)))))
    want_loss, want = jax.jit(jax.value_and_grad(_jax_loss(jm, rays, rgbs,
                                                           dict(kw, key=key))))(jp)
    loss, got = _port_loss(tm, rays, rgbs, dict(kw, **draws))
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_ckpt._flatten(want)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("shader") for k in got) == (mode not in ("SH", "RGB"))
    for k in sorted(want):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["MLP_PE", "SH"])
@pytest.mark.parametrize("model", ["EgoNeRF", "TensorVMSplit"])
def test_eval_forward_matches_jax(model, mode):
    """The render path (key=None, the bf16 tables) under MLP_PE (the chart's
    coords into the shader) and SH: rgb abs 1e-5, depth abs 1e-4, as the
    default mode's eval tests hold them."""
    rays = _rays(64, seed=8)
    if model == "EgoNeRF":
        jm, jp, tm = _ego_pair(mode, "bfloat16")
        rays[:, :3] *= 2.0
        kw = dict(RENDER)
    else:
        jm, jp, tm = _tf_pair(mode, "bfloat16")
        kw = dict(n_coarse=40)
    want = jax.jit(lambda p, r: jm.forward(p, r, **kw))(jp, jnp.asarray(rays))
    with torch.no_grad():
        params = tm.params()
        got = tm.forward(params, torch.from_numpy(rays), tables=tm.lookup_tables(params), **kw)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("model", ["EgoNeRF", "TensorVMSplit"])
@pytest.mark.parametrize("mode", MODES)
def test_hoist_only_for_mlp_fea(mode, model, monkeypatch):
    """Under ``EGONERF_HOIST_DIRS=1`` only MLP_Fea takes the unexpanded (R, 3)
    directions (JAX ``models/egonerf.py:468``, ``models/tensorf.py:234``);
    every other mode gets them per sample, and renders as without the
    switch, bit for bit; MLP_PE gets the chart's first three coords."""
    pair = _ego_pair if model == "EgoNeRF" else _tf_pair
    _, _, tm = pair(mode)
    seen = []
    apply = tm.shader.apply_params

    def rec(params, prefix, dirs, feats, *a, **kw):
        seen.append((tuple(dirs.shape), tuple(kw["pts"].shape)))
        return apply(params, prefix, dirs, feats, *a, **kw)
    tm.shader.apply_params = rec
    rays = torch.from_numpy(_rays(32, seed=9))
    kw = dict(RENDER) if model == "EgoNeRF" else dict(n_coarse=24)
    with torch.no_grad():
        params = tm.params()
        base = tm.forward(params, rays, tables=tm.lookup_tables(params), **kw)["rgb"]
        flip(monkeypatch, HOIST_DIRS=True)
        hoisted = tm.forward(params, rays, tables=tm.lookup_tables(params), **kw)["rgb"]
    s = 32 if model == "EgoNeRF" else 24  # samples a ray: 16 + 16 merged, or 24
    assert seen[0] == ((32, s, 3), (32, s, 3))
    assert seen[1] == (((32, 3) if mode == "MLP_Fea" else (32, s, 3)), (32, s, 3))
    if mode == "MLP_Fea":
        np.testing.assert_allclose(hoisted.numpy(), base.numpy(), rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(hoisted.numpy(), base.numpy())


@pytest.mark.parametrize("mode", ["MLP_PE", "MLP", "SH"])
def test_mixed_mm_takes_the_mlp_modes_products(mode, monkeypatch):
    """Under ``EGONERF_MIXED_MM=1`` EgoNeRF's training forward takes the
    basis product and an MLP mode's three products through K10 (``ops.mm``,
    here the plain version), SH's only the basis; TensorVMSplit never
    mixes, as JAX passes ``matmul`` to EgoNeRF's shader alone."""
    flip(monkeypatch, MIXED_MM=True)
    calls = []

    def mm(*args):
        calls.append(tuple(args[0].shape))
        return ops.PLAIN.mm(*args)
    _, _, tm = _ego_pair(mode, "bfloat16")
    assert tm.mixed_mm
    tm.ops = ops.KERNELS._replace(mm=mm)
    rays = torch.from_numpy(_rays(32, seed=10))
    tm.forward(tm.params(), rays, is_train=True, jitter=torch.rand(32, 16),
               u=torch.sort(torch.rand(32, 16), dim=-1).values, **RENDER)
    assert len(calls) == (1 if mode == "SH" else 4)
    _, _, tf = _tf_pair(mode, "bfloat16")
    calls.clear()
    tf.ops = ops.KERNELS._replace(mm=mm)
    tf.forward(tf.params(), rays, is_train=True, jitter=torch.rand(32, 24), n_coarse=24)
    assert calls == []


@pytest.mark.parametrize("model", ["EgoNeRF", "TensorVMSplit"])
@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_of_each_mode_both_ways(tmp_path, mode, model):
    """A JAX checkpoint under the mode loads in the port bit for bit (the
    MLP modes' ``shader/l*/w|b`` transposed, no shader key for SH and RGB)
    and builds that mode; the port's checkpoint loads in JAX's
    ``load_checkpoint`` bit for bit, with JAX's ``model_meta``."""
    jm, jp, _ = (_ego_pair if model == "EgoNeRF" else _tf_pair)(mode)
    path = os.path.join(str(tmp_path), "jax.npz")
    jax_ckpt.save_checkpoint(path, jp, global_step=3, coords_spec=jm.coordinates.to_spec(),
                             model_meta=jax_model_meta(None, jm))
    loaded, params, header = load_jax_checkpoint(path, near_far=jm.near_far, device="cpu")
    assert loaded.shader.name == mode and loaded.cfg.shading_mode == mode
    flat = jax_ckpt._flatten(jp)
    back = params_to_jax(params)
    assert sorted(back) == sorted(flat)
    assert any(k.startswith("shader/") for k in back) == (mode not in ("SH", "RGB"))
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg=k)
    out = os.path.join(str(tmp_path), "port.npz")
    save_checkpoint(out, params, global_step=5, coords_spec=loaded.coordinates.to_spec(),
                    model_meta=model_meta(None, loaded))
    jflat, jheader, _ = jax_ckpt.load_checkpoint(out)
    assert jheader["model_meta"] == jax_model_meta(None, jm)
    assert sorted(jflat) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(jflat[k]), np.asarray(flat[k]), err_msg=k)


def test_config_default_mode_trains(tmp_path):
    """A config that names no shading mode takes MLP_PE, the default of both
    packages' ``Config``, and the port trains it: TensorVMSplit on the xyz
    chart for 8 steps, finite falling MSEs, the checkpoint's model_meta
    naming MLP_PE."""
    over = dict(dataset_name="synthetic", model_name="TensorVMSplit", coordinates_name="xyz",
                n_coarse=12, batch_size=256, n_iters=8, N_voxel_init=14 ** 3,
                N_voxel_final=14 ** 3, n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]",
                data_dim_color=12, density_shift="-8", featureC=32, lr_init=0.02,
                near_far="[0.05, 8.5]", basedir=str(tmp_path), expname="default_mode",
                N_vis=0, i_weights=10 ** 7, eval_chunk=256, progress_refresh_rate=1,
                render_test=False)
    cfg = load_config(overrides=over)
    assert cfg.shadingMode == jax_load_config(overrides=over).shadingMode == "MLP_PE"
    t = Trainer(cfg, device="cpu")
    assert t.model.shader.name == "MLP_PE"
    t.train()
    with open(os.path.join(t.logdir, "metrics.jsonl")) as f:
        mses = [json.loads(l)["value"] for l in f if json.loads(l)["tag"] == "train/mse"]
    assert len(mses) >= 8 and np.isfinite(mses).all() and mses[-1] < mses[0]
    _, header, _ = jax_ckpt.load_checkpoint(os.path.join(t.logdir, "default_mode.npz"))
    assert header["model_meta"]["shading_mode"] == "MLP_PE"
