"""The port's nine charts against the JAX package's, on the CPU: each
chart's map (``from_cartesian``, ``normalize_coord``), the directional
fold's decisions, the grid bookkeeping with its side effects, the
checkpoint spec, TensorVMSplit's training step on every single-grid chart,
the port's trainer on each, and the directional balanced chart's model
grid.  Inputs come from numpy seeds and go to both sides."""
import json
import os
from math import pi

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords import coords_from_spec as jax_coords_from_spec
from egonerf_tpu.coords import make_coordinates as jax_make_coordinates
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.tensorf import TensorVMSplit as JaxTensorVMSplit
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_tpu.train import trainer as jax_trainer
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch import ops
from egonerf_torch.coords import coordinates_dict, coords_from_spec, make_coordinates
from egonerf_torch.models import FieldConfig, TensorVMSplit, params_from_jax, params_to_jax
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer

from test_torch_tensorf import SHAPE, _jax_loss, _port_loss, _rays

AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
# an aabb off the origin, so each chart's centre and far bounds are its own
AABB_OFF = np.array([[-1.2, -0.9, -1.7], [1.6, 1.3, 0.8]], np.float32)
N_VOXEL = 14 ** 3
R0 = 0.05
# (id, chart, radial options): every chart of JAX's registry, generic_sphere
# in its three radial modes
CASES = [("xyz", "xyz", {}), ("sphere", "sphere", {}),
         ("balanced_sphere", "balanced_sphere", {}),
         ("directional_sphere", "directional_sphere", {}),
         ("directional_balanced_sphere", "directional_balanced_sphere", {}),
         ("euler_sphere", "euler_sphere", {}), ("cylinder", "cylinder", {}),
         ("generic_lookup", "generic_sphere", dict(exp_r=True, interval_th=True)),
         ("generic_exp", "generic_sphere", dict(exp_r=True, interval_th=False)),
         ("generic_linear", "generic_sphere", dict(exp_r=False, interval_th=False)),
         ("yinyang", "yinyang", dict(exp_r=True, interval_th=True))]
IDS = [c[0] for c in CASES]
# the charts of the single-grid models (JAX's test_every_chart_trains_tensorf)
TENSORF_CHARTS = ["sphere", "balanced_sphere", "directional_sphere",
                  "directional_balanced_sphere", "euler_sphere", "cylinder", "generic_sphere"]
# float32 acos, atan2, log and pow from two libraries: ulps of the result on
# values in [-1, 1] (as tests/test_torch_coords.py holds the yin-yang chart)
ATOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _charts(name, radial, aabb=AABB, n_voxel=N_VOXEL):
    """JAX's chart and the port's, built as each trainer builds them: the
    radial charts size themselves, the others take N_to_reso (with its side
    effects) and set_resolution."""
    kw = dict(exp_r=radial.get("exp_r", False), N_voxel=n_voxel, r0=R0,
              interval_th=radial.get("interval_th", False))
    jc, tc = jax_make_coordinates(name, aabb, **kw), make_coordinates(name, aabb, **kw)
    for c in (jc, tc):
        if c.resolution is None:
            c.set_resolution(c.N_to_reso(n_voxel))
    return jc, tc


def _points(aabb, seed, special=True):
    """Points in a ball 1.3x the chart's reach about the aabb's centre; with
    ``special`` (a centred aabb, so the offsets survive the centre's
    subtraction exactly), the centre itself with either sign of zero, the
    poles, and points at phi = 0 and +-pi with y = +0.0 and -0.0."""
    rng = np.random.default_rng(seed)
    centre = aabb.sum(0) / 2.0
    reach = float(np.linalg.norm(aabb[1] - aabb[0]) / 2.0)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = centre + d * rng.uniform(0.0, 1.3 * reach, (2048, 1)).astype(np.float32)
    if special:
        pts = np.concatenate([pts, np.array(
            [[0.0, 0.0, 0.0], [-0.0, -0.0, 0.0], [-0.0, 0.0, -0.0], [0.0, 0.0, 0.7],
             [0.0, 0.0, -0.7], [0.6, 0.0, 0.2], [0.6, -0.0, 0.2], [-0.6, 0.0, 0.2],
             [-0.6, -0.0, 0.2], [-0.6, 0.0, -0.4], [-0.6, -0.0, -0.4], [0.0, 0.5, 0.0],
             [0.0, -0.5, 0.0], [-1e-30, 0.3, 0.1], [-0.4, 1e-30, 0.0], [-0.4, -1e-30, 0.0]],
            np.float32)])
    return pts.astype(np.float32)


def _maps(jc, tc, pts):
    want_c = np.asarray(jc.from_cartesian(jnp.asarray(pts)))
    want_n = np.asarray(jc.normalize_coord(jnp.asarray(want_c)))
    got_c = tc.from_cartesian(torch.from_numpy(pts))
    got_n = tc.normalize_coord(got_c).numpy()
    return want_c, want_n, got_c.numpy(), got_n


# ---------------------------------------------------------------------------
# the maps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aabb", ["centred", "off"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chart_maps_match_jax(case, aabb):
    """``from_cartesian`` and ``normalize_coord`` of every chart on seeded
    points (and, on the centred aabb, the centre, the poles and the phi = 0,
    +-pi seams with both signs of zero): abs <= 2e-6, the float32 acos,
    atan2, log and pow of two libraries; the charts' flags and the signs
    of their outputs equal."""
    _, name, radial = case
    box = AABB if aabb == "centred" else AABB_OFF
    jc, tc = _charts(name, radial, box)
    pts = _points(box, seed=3, special=aabb == "centred")
    want_c, want_n, got_c, got_n = _maps(jc, tc, pts)
    assert got_c.shape == want_c.shape and got_n.shape == want_n.shape
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_n, want_n, rtol=0, atol=ATOL)
    # no sign flips: the fold, the flag and each angle's side of zero
    big = np.abs(want_n) > ATOL
    np.testing.assert_array_equal(np.sign(got_n[big]), np.sign(want_n[big]))


@pytest.mark.parametrize("name", ["directional_sphere", "directional_balanced_sphere"])
def test_directional_fold_decisions_match_jax(name):
    """The fold (phi < 0: r and theta negated, phi moved up by pi) decides
    the same on every point: atan2(-0.0, x < 0) = -pi folds, atan2(+0.0, x <
    0) = +pi does not, atan2(+-0.0, x > 0) = +-0 does not, and at r = 0
    (atan2(-0.0, -0.0) = -pi folds; r = 0 gives theta = pi / 2)."""
    jc, tc = _charts(name, {})
    pts = _points(AABB, seed=4)
    want_c, want_n, got_c, got_n = _maps(jc, tc, pts)
    want_fold, got_fold = want_c[:, 2] < 0, got_c[:, 2] < 0
    np.testing.assert_array_equal(got_fold, want_fold)
    np.testing.assert_array_equal(np.signbit(got_c[:, 2]), np.signbit(want_c[:, 2]))
    # the signed coords: r (or normalized r) and theta carry the fold's sign
    np.testing.assert_array_equal(np.signbit(got_n[:, :2]), np.signbit(want_n[:, :2]))
    special = pts[-16:]
    assert want_fold[-16:].any() and not want_fold[-16:].all()
    # both signs of zero meet x < 0 among the special points: one folds
    seam = (special[:, 1] == 0) & (special[:, 0] < 0)
    assert want_fold[-16:][seam].any() and not want_fold[-16:][seam].all()
    # r = 0: theta is acos(0) on both sides
    np.testing.assert_allclose(got_c[-16, :2], [0.0, pi / 2], atol=ATOL)


# ---------------------------------------------------------------------------
# the grid bookkeeping
# ---------------------------------------------------------------------------
CONSTANTS = ("resolution", "ratio", "r0", "coeff", "near", "far", "inv_diff", "center",
             "ref_grid", "exp_r", "interval_th")


def _same_constants(jc, tc):
    for key in CONSTANTS:
        if not hasattr(jc, key):
            assert not hasattr(tc, key), key
            continue
        want, got = getattr(jc, key), getattr(tc, key)
        if want is None or isinstance(want, (bool, int, float, list)):
            assert got == want, key
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=key)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grid_bookkeeping_matches_jax(case):
    """N_to_reso (with the balanced charts' rewrite of ratio, r0 and coeff
    as its side effect), set_resolution (the directional balanced chart's
    halved radius), update_aabb, get_normalized_range and the chart's
    constants equal to JAX's; axis_positions abs <= 2e-6 (the radial nodes
    through normalize_r: log and pow of two libraries) and up_sampling_VM
    on seeded planes and lines abs <= 1e-5 (those positions' lerps of
    values in N(0, 1), 2e-6 x (n - 1) / 2 of a cell at most)."""
    _, name, radial = case
    jc, tc = _charts(name, radial)
    _same_constants(jc, tc)
    for n in (10 ** 3, 24 ** 3, 64_000, 27_000_000):
        assert tc.N_to_reso(n) == jc.N_to_reso(n)
        _same_constants(jc, tc)
    reso = jc.N_to_reso(20 ** 3)
    assert tc.N_to_reso(20 ** 3) == reso
    if name in ("yinyang", "generic_sphere"):
        jc.set_resolution(reso, r0=R0)
        tc.set_resolution(reso, r0=R0)
    else:
        jc.set_resolution(reso)
        tc.set_resolution(reso)
    _same_constants(jc, tc)
    if name == "directional_balanced_sphere":
        assert tc.resolution == [reso[0] // 2, *reso[1:]]
    sub = np.array([[-0.7, -1.1, -0.2], [1.2, 0.4, 1.4]], np.float32)
    for a, b in zip(tc.get_normalized_range(sub), jc.get_normalized_range(sub)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(9)
    target = [reso[0] + 3, reso[1] + 5, reso[2] + 2]
    for dim in range(3):
        np.testing.assert_allclose(tc.axis_positions(dim, target[dim]),
                                   np.asarray(jc.axis_positions(dim, target[dim])), rtol=0,
                                   atol=ATOL, err_msg=f"dim {dim}")
    plane = rng.normal(size=(1, reso[1], reso[0], 3)).astype(np.float32)
    line = rng.normal(size=(1, reso[2], 3)).astype(np.float32)
    for arr, ids in ((plane, [1, 0]), (line, [2])):
        want = np.asarray(jc.up_sampling_VM(jnp.asarray(arr), target, ids))
        got = tc.up_sampling_VM(torch.from_numpy(arr), target, ids).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jc.update_aabb(AABB_OFF)
    tc.update_aabb(AABB_OFF)
    _same_constants(jc, tc)
    pts = _points(AABB_OFF, seed=10, special=False)
    _, want_n, _, got_n = _maps(jc, tc, pts)
    np.testing.assert_allclose(got_n, want_n, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_coords_spec_round_trips_both_ways(case):
    """A chart's ``coords_spec`` through JSON (as a checkpoint stores it):
    the port's spec equals JAX's, and each package's chart rebuilt from the
    other's spec holds JAX's constants (the balanced charts' ratio, r0 and
    coeff as stored, the directional balanced chart's halved resolution
    taken as it is) and maps points as JAX's rebuilt chart does."""
    _, name, radial = case
    jc, tc = _charts(name, radial)
    spec = json.loads(json.dumps(jc.to_spec()))
    assert json.loads(json.dumps(tc.to_spec())) == spec
    jc2, tc2 = jax_coords_from_spec(spec), coords_from_spec(spec)
    _same_constants(jc2, tc2)
    _same_constants(jc, tc2)
    assert tc2.to_spec() == jc2.to_spec()
    pts = _points(AABB, seed=11)
    _, want_n, _, got_n = _maps(jc2, tc2, pts)
    np.testing.assert_allclose(got_n, want_n, rtol=0, atol=ATOL)


def test_registry_names_every_chart():
    from egonerf_tpu.coords import coordinates_dict as jax_dict

    assert sorted(coordinates_dict) == sorted(jax_dict)
    for name, cls in coordinates_dict.items():
        assert cls.name == jax_dict[name].name == name


# ---------------------------------------------------------------------------
# TensorVMSplit on each chart
# ---------------------------------------------------------------------------
def _tensorf_pair(name, radial):
    """JAX's and the port's TensorVMSplit on the chart, the same weights,
    float32 lookups (so both sides sum the plane gradients in float32)."""
    jc, tc = _charts(name, radial)
    # the model's grid is N_to_reso's (the directional balanced chart halves
    # only its own resolution)
    reso = jc.N_to_reso(N_VOXEL)
    assert tc.N_to_reso(N_VOXEL) == reso
    cfg = dict(SHAPE, compute_dtype="float32")
    jm = JaxTensorVMSplit(AABB, reso, jc, JaxFieldConfig(**cfg), near_far=(0.5, 3.5))
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = TensorVMSplit(AABB, reso, tc, FieldConfig(**cfg), near_far=(0.5, 3.5), device="cpu")
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


# the step on each single-grid chart with uniform steps, and generic_sphere
# under interval_th also with exponential ones
STEP_CASES = [c for c in CASES if c[1] in TENSORF_CHARTS] + [
    ("generic_lookup_exp", "generic_sphere", dict(exp_r=True, interval_th=True,
                                                  exp_sampling=True))]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_tensorvmsplit_step_matches_jax_on_each_chart(case):
    """One training loss (MSE + Ortho + L1 + TV) of TensorVMSplit on the
    chart and every gradient against ``jax.value_and_grad``, with JAX's
    jitter: loss rel 1e-5, each gradient abs 1e-4 of its largest entry
    (float32 sums in another order, and the charts' ulps above moving a
    lookup by ~1e-6 of a cell).  generic_sphere under interval_th takes
    K7s's plain version here (``ops.chart_sphere`` on CPU tensors), asked
    for the in-box mask with the model's aabb."""
    _, name, radial = case
    jm, jp, tm = _tensorf_pair(name, radial)
    calls = []

    def chart(*args):
        assert len(args) == 5 and np.array_equal(np.asarray(args[4]), tm.aabb)
        calls.append(args[2].shape)
        return ops.PLAIN.chart_sphere(*args)
    tm.ops = ops.KERNELS._replace(chart_sphere=chart)
    rng = np.random.default_rng(12)
    rays = _rays(64, seed=13)
    rays[:, :3] += rng.uniform(-0.6, 0.6, (64, 3)).astype(np.float32)
    rgbs = rng.uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    kw = dict(n_coarse=24, exp_sampling=radial.get("exp_sampling", False))
    want_loss, want = jax.jit(jax.value_and_grad(_jax_loss(jm, rays, rgbs,
                                                           dict(kw, key=key))))(jp)
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (64, 24))))
    loss, got = _port_loss(tm, rays, rgbs, dict(kw, jitter=jitter))
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_ckpt._flatten(want)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)
    lookup = name == "generic_sphere" and radial.get("interval_th")
    assert calls == ([(64, 24)] if lookup else [])


def test_tensorf_refuses_the_yinyang_chart():
    """The family's lookups read one grid; the yin-yang chart's flag would
    index a second one (JAX's reads [r, theta, phi] and drops the flag), so
    the port refuses the chart for the family (ROADMAP.md §3)."""
    jc, tc = _charts("yinyang", dict(exp_r=True, interval_th=True))
    with pytest.raises(ValueError, match="yin-yang"):
        TensorVMSplit(AABB, tc.resolution, tc, FieldConfig(**SHAPE), device="cpu")


def _chart_cfg(tmp_path, chart, **over):
    """JAX's ``test_every_chart_trains_tensorf`` config
    (tests/test_e2e.py:286-320)."""
    return dict(dict(
        dataset_name="synthetic", model_name="TensorVMSplit", coordinates_name=chart,
        exp_sampling=(chart == "generic_sphere"), r0="0.05",
        interval_th=(chart == "generic_sphere"), n_coarse=12, batch_size=256, n_iters=8,
        N_voxel_init=14 ** 3, N_voxel_final=14 ** 3, n_lamb_sigma="[4,4,4]",
        n_lamb_sh="[8,8,8]", data_dim_color=12, shadingMode="MLP_Fea", density_shift="-8",
        featureC=32, view_pe=2, fea_pe=2, lr_init=0.02, sparsity_lambda=0,
        near_far="[0.05, 8.5]", basedir=str(tmp_path), expname=f"chart_{chart}", N_vis=0,
        i_weights=10 ** 7, eval_chunk=256, steps_per_call=4, progress_refresh_rate=1,
        render_test=False), **over)


@pytest.mark.parametrize("chart", TENSORF_CHARTS)
def test_trainer_trains_every_chart(tmp_path, chart):
    """The port's trainer on JAX's end-to-end config for each chart: eight
    finite MSEs that fall, as JAX's test asserts, and a resumed run that
    continues from its checkpoint with the chart's spec."""
    t = Trainer(load_config(overrides=_chart_cfg(tmp_path, chart)), device="cpu")
    assert t.coords.name == chart
    t.train()
    with open(os.path.join(t.logdir, "metrics.jsonl")) as f:
        mses = [json.loads(l)["value"] for l in f if json.loads(l)["tag"] == "train/mse"]
    assert len(mses) >= 8 and np.isfinite(mses).all()
    assert mses[-1] < mses[0], f"{chart}: mse did not fall {mses[0]} -> {mses[-1]}"
    resumed = Trainer(load_config(overrides=_chart_cfg(tmp_path, chart, n_iters=9)),
                      device="cpu")
    assert resumed.start_step == 8 and resumed.coords.to_spec() == t.coords.to_spec()
    # a resumed directional balanced model steps at its chart's resolution,
    # as JAX's resume builds it (test_directional_balanced_model_grid_matches_jax)
    want = (t.coords.resolution if chart == "directional_balanced_sphere"
            else t.model.grid_size)
    assert resumed.model.grid_size == want
    for k, p in t.params.items():
        np.testing.assert_array_equal(resumed.params[k].detach().numpy(), p.detach().numpy())


def _jax_trainer(cfg):
    return jax_trainer.Trainer(jax_load_config(overrides=cfg))


def test_directional_balanced_model_grid_matches_jax(tmp_path):
    """The directional balanced chart halves the radius of its own
    resolution, not the model's: at N_voxel 14^3 both trainers build the
    model at N_to_reso's [13, 13, 13] beside the chart's [6, 13, 13], with
    JAX's step.  An upsample event takes JAX's order (N_to_reso, which
    rewrites ratio, r0 and coeff; upsample_params at those constants and
    the old resolution; set_resolution; update_step_size): the grids, the
    chart's constants and the resampled parameters as JAX's (abs 1e-5, the
    radial positions' ulps).  Resumed from JAX's checkpoint, the port builds
    the model at the stored grid with the step of the chart's resolution,
    as JAX's resume does."""
    base = _chart_cfg(tmp_path, "directional_balanced_sphere",
                      N_voxel_final=20 ** 3, upsamp_list="[2]")
    jt = _jax_trainer(dict(base, basedir=str(tmp_path / "jax")))
    pt = Trainer(load_config(overrides=dict(base, basedir=str(tmp_path / "port"))),
                 device="cpu")
    assert jt.model.grid_size == pt.model.grid_size == [13, 13, 13]
    assert jt.coords.resolution == pt.coords.resolution == [6, 13, 13]
    assert pt.model.step_size == jt.model.step_size
    assert pt.params["density_lines.0"].shape == (1, 13, 4)
    pt.model.load_state_dict(params_from_jax(jax_ckpt._flatten(jt.params), device="cpu"))
    jt._upsample(2)
    pt.upsample(2)
    # int(8000 ** (1 / 3)) is 19 in float64, in both packages
    assert jt.model.grid_size == pt.model.grid_size == [19, 19, 19]
    assert pt.coords.resolution == jt.coords.resolution == [9, 19, 19]
    _same_constants(jt.coords, pt.coords)
    assert pt.model.step_size == jt.model.step_size
    want, got = jax_ckpt._flatten(jt.params), params_to_jax(pt.params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
    path = os.path.join(str(tmp_path), "jax_dirbal.npz")
    jt.save(path, 2)
    resumed_j = _jax_trainer(dict(base, basedir=str(tmp_path / "jax2"), ckpt=path))
    resumed_p = Trainer(load_config(overrides=dict(base, basedir=str(tmp_path / "port2"),
                                                   ckpt=path)), device="cpu")
    assert resumed_p.params["density_lines.0"].shape == (1, 19, 4)
    assert resumed_p.coords.resolution == resumed_j.coords.resolution == [9, 19, 19]
    assert resumed_p.model.grid_size == resumed_j.model.grid_size == [9, 19, 19]
    assert resumed_p.model.step_size == resumed_j.model.step_size
