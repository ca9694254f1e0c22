"""EgoNeRF's grid upsampling and linear ray sampling in the port against the
JAX package, on the CPU, at a small shape (N_voxel 24^3 -> 32^3, n_lamb
4/8, app_dim 12, featureC 32, 16 + 16 samples): the chart's r-aware axis
positions, ``up_sampling_VM``, ``EgoNeRF.upsample_params``, the fine line
modes on either side of an upsample, the forward with ``exp_sampling``
off at eval and in a training step fed JAX's draws, and the trainer across
an upsample event."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.ops import vm_lookup as jax_vm_lookup
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.models import EgoNeRF, FieldConfig, params_from_jax, params_to_jax
from egonerf_torch.ops.vm_lookup import HAT, LINEAR, MAT_MODE, VEC_MODE
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer
from test_torch_train import _tiny_cfg

AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
NEAR_FAR = (0.05, 8.5)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32)
RENDER = dict(n_coarse=16, n_fine=16)
N_RAYS = 64
# (exp_r, interval_th) of the chart
CHARTS = {"exp interval_th": (True, True), "exp": (True, False), "linear": (False, False)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _charts(chart, n_voxel=24 ** 3):
    exp_r, ith = CHARTS[chart]
    return (JaxYinYang(AABB, exp_r=exp_r, N_voxel=n_voxel, r0=0.05, interval_th=ith),
            YinYangSphericalCoords(AABB, exp_r=exp_r, N_voxel=n_voxel, r0=0.05,
                                   interval_th=ith))


def _pair(chart, compute_dtype="float32", seed=0):
    jc, tc = _charts(chart)
    jm = JaxEgoNeRF(AABB, jc.resolution, jc,
                    JaxFieldConfig(**SHAPE, compute_dtype=compute_dtype), near_far=NEAR_FAR)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**SHAPE, compute_dtype=compute_dtype),
                 near_far=NEAR_FAR, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # exact zeros in the directions: the linear sampler divides them as 1e-6
    d[:4, 0] = 0.0
    d[2:6, 2] = 0.0
    o = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    return np.concatenate([o, d], -1)


@pytest.mark.parametrize("new_size", [8, 13, 24, 32, 57])
@pytest.mark.parametrize("chart", sorted(CHARTS))
def test_axis_positions_match_jax(chart, new_size):
    """Every axis of each chart, bit for bit: the radius's new node radii go
    through the current normalize_r on both sides."""
    jc, tc = _charts(chart)
    for dim in range(3):
        got = tc.axis_positions(dim, new_size)
        want = np.asarray(jc.axis_positions(dim, new_size))
        assert got.dtype == np.float32 and got.shape == (new_size,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chart", sorted(CHARTS))
def test_up_sampling_vm_matches_jax(chart):
    """Planes and lines of each decomposition onto a larger and a smaller
    grid, bit for bit (the same float32 lerp of the same gathered rows)."""
    jc, tc = _charts(chart)
    rng = np.random.default_rng(1)
    for target in (jc.N_to_reso(32 ** 3), jc.N_to_reso(16 ** 3)):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane = rng.normal(size=(2, jc.resolution[m1], jc.resolution[m0], 3)).astype(
                np.float32)
            line = rng.normal(size=(2, jc.resolution[VEC_MODE[i]], 3)).astype(np.float32)
            for arr, ids in ((plane, [m1, m0]), (line, [VEC_MODE[i]])):
                want = np.asarray(jc.up_sampling_VM(jnp.asarray(arr), target, ids))
                got = tc.up_sampling_VM(torch.from_numpy(arr), target, ids).numpy()
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chart", sorted(CHARTS))
def test_upsample_params_matches_jax(chart):
    """Both charts' density and appearance planes and lines, installed as the
    module's parameters: within 1e-6 of JAX's; the basis and the shader
    untouched."""
    jm, jp, tm = _pair(chart)
    target = jm.coordinates.N_to_reso(32 ** 3)
    want = jax_ckpt._flatten(jm.upsample_params(jp, target))
    before = {k: v.clone() for k, v in tm.params().items()}
    got_params = tm.upsample_params(tm.params(), target)
    assert got_params == tm.params()
    got = params_to_jax(got_params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)
    for name in ("basis", "shader.l1.weight"):
        assert torch.equal(got_params[name], before[name])
    assert all(isinstance(p, torch.nn.Parameter) for p in got_params.values())
    assert tuple(tm.density_lines[2].shape) == (2, target[VEC_MODE[2]], 4)


@pytest.mark.parametrize("reso_n", [
    # the production schedule 8e6 -> 27e6 at a render chunk of 4096 x 256
    ((100, 114, 344), (150, 172, 516), 4096 * 256),
    # the phi line crosses the 1152-row gate (2 stacked rows a node)
    ((160, 184, 552), (170, 196, 588), 4096 * 256),
    # the byte gate: rows x samples x 2 bytes above 3e9 after the upsample
    ((100, 114, 344), (150, 172, 516), 2_000_000),
])
def test_line_modes_across_the_upsample(reso_n):
    """Each fine line's mode before and after an upsample, against JAX's
    ``_onehot_ok`` gate on the same table and sample count."""
    before, after, n = reso_n
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**SHAPE), near_far=NEAR_FAR,
                 device="cpu")
    modes = []
    for reso in (before, after):
        lines = [torch.empty(2, reso[VEC_MODE[i]], 12) for i in range(3)]
        got = tm._line_hat(lines, n)
        want = [HAT if jax_vm_lookup._onehot_ok(2 * l.shape[1], n,
                                                jax_vm_lookup._ONEHOT_FWD_MAX_ROWS) else LINEAR
                for l in lines]
        assert got == want, reso
        modes.append(got)
    phi = VEC_MODE.index(2)
    if before[0] == 160 or n == 2_000_000:
        assert modes[0][phi] == HAT and modes[1][phi] == LINEAR


@pytest.mark.parametrize("chart", sorted(CHARTS))
def test_linear_depths_match_jax(chart):
    """``sample_depths_linear`` against the depths of JAX's
    ``sample_ray_linear``, eval and jittered, bit for bit."""
    jm, _, tm = _pair(chart)
    rays = _rays(N_RAYS)
    key = jax.random.PRNGKey(3)
    jit_jax = np.array(jax.random.uniform(key, (N_RAYS, 24)))
    for jit_t, k in ((None, None), (torch.from_numpy(jit_jax), key)):
        _, want = jm.sample_ray_linear(jnp.asarray(rays[:, :3]), jnp.asarray(rays[:, 3:]), k, 24)
        got = tm.sample_depths_linear(torch.from_numpy(rays[:, :3]),
                                      torch.from_numpy(rays[:, 3:]), 24, jit_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=sorted(CHARTS))
def linear_step(request):
    """One training step with ``exp_sampling`` off on both sides, the JAX
    draws fed to the port: k_coarse, k_pdf = split(key); the jitter
    uniform(k_coarse), u = sorted_uniform(k_pdf)."""
    jm, jp, tm = _pair(request.param)
    rays = _rays(N_RAYS, seed=4)
    rgbs = np.random.default_rng(5).uniform(size=(N_RAYS, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k_coarse, k_pdf = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k_coarse, (N_RAYS, RENDER["n_coarse"])))
    u = np.asarray(jax_sorted_uniform(k_pdf, (N_RAYS, RENDER["n_fine"])))

    def loss_fn(p):
        out = jm.forward(p, jnp.asarray(rays), key=key, is_train=True, exp_sampling=False,
                         **RENDER)
        return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    params = tm.params()
    out = tm.forward(params, torch.from_numpy(rays), is_train=True, exp_sampling=False,
                     jitter=torch.from_numpy(jitter), u=torch.from_numpy(u), **RENDER)
    loss = torch.mean((out["rgb"] - torch.from_numpy(rgbs)) ** 2)
    loss.backward()
    return dict(loss=float(loss.detach()), want_loss=float(want_loss),
                got=params_to_jax({k: p.grad for k, p in params.items()}),
                want=jax_ckpt._flatten(want_grads))


def test_linear_step_loss_matches_jax(linear_step):
    """float32 sums in another order through the cdf, field, shader and
    composite: rel 1e-5 (as tests/test_torch_train.py)."""
    assert linear_step["loss"] == pytest.approx(linear_step["want_loss"], rel=1e-5)


def test_linear_step_gradients_match_jax(linear_step):
    """Every gradient, float32 tables: rel 1e-4 of each tensor's largest
    entry (scatter-adds and matmuls in another order, as
    tests/test_torch_train.py)."""
    got, want = linear_step["got"], linear_step["want"]
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


@pytest.fixture(scope="module", params=[True, False], ids=["exp", "linear"])
def upsampled(request, tmp_path_factory):
    """The tiny trainer across an upsample event at step 3 of 6 (24^3 ->
    32^3), with the event's params before and after recorded."""
    exp = request.param
    tmp = tmp_path_factory.mktemp("ups")
    cfg = load_config(overrides=_tiny_cfg(tmp, n_iters=6, upsamp_list="[3]",
                                          N_voxel_final=32 ** 3, N_vis=0, exp_sampling=exp,
                                          interval_th=exp))
    seen = {}

    class Spy(Trainer):
        def upsample(self, iteration):
            seen["it"] = iteration
            seen["reso"] = list(self.coords.resolution)
            seen["before"] = {k: v.detach().clone() for k, v in self.params.items()}
            super().upsample(iteration)
            seen["after"] = {k: v.detach().clone() for k, v in self.params.items()}
            seen["optimizer"] = self.optimizer

    trainer = Spy(cfg, device="cpu")
    trainer.train()
    return trainer, seen, exp


def test_trainer_upsample_event(upsampled):
    """The event against JAX's: the new resolution (``N_to_reso`` of the
    log-linear schedule), the step size, the params (1e-6), Adam rebuilt
    with fresh moments, the chart's radial lookup grid re-made."""
    trainer, seen, exp = upsampled
    assert seen["it"] == 3
    aabb = trainer.train_dataset.scene_bbox
    jc = JaxYinYang(aabb, exp_r=exp, r0=0.05, interval_th=exp)
    jc.set_resolution(seen["reso"], r0=0.05)
    jm = JaxEgoNeRF(aabb, seen["reso"], jc, JaxFieldConfig(**SHAPE), near_far=NEAR_FAR)
    jp = jax_ckpt._unflatten(jm.init_params(jax.random.PRNGKey(0)),
                             params_to_jax(seen["before"]))
    n_vox = int(np.round(np.exp(np.linspace(np.log(24 ** 3), np.log(32 ** 3), 2)))[1])
    reso = jc.N_to_reso(n_vox)
    want = jax_ckpt._flatten(jm.upsample_params(jp, reso))
    jc.set_resolution(reso)
    jm.update_step_size(reso)
    assert trainer.coords.resolution == trainer.reso_cur == reso
    assert trainer.model.grid_size == jm.grid_size
    assert trainer.model.step_size == pytest.approx(jm.step_size, rel=1e-7)
    if exp:
        np.testing.assert_array_equal(trainer.coords.ref_grid, jc.ref_grid)
    got = params_to_jax(seen["after"])
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)
    # Adam rebuilt at the event: the steps after it counted from 0, with
    # moments for the new shapes
    opt = seen["optimizer"]
    assert opt is trainer.optimizer and opt.count == 2
    for p in trainer.params.values():
        assert opt.adam.state[p]["exp_avg"].shape == p.shape


def test_step_after_the_upsample_matches_jax(upsampled):
    """The next step's loss at the new resolution on both sides, with the
    event's params and JAX's draws: rel 1e-5 (as a training step)."""
    trainer, seen, exp = upsampled
    aabb = trainer.train_dataset.scene_bbox
    reso = trainer.coords.resolution
    jc = JaxYinYang(aabb, exp_r=exp, r0=0.05, interval_th=exp)
    jc.set_resolution(reso, r0=0.05)
    jm = JaxEgoNeRF(aabb, reso, jc, JaxFieldConfig(**SHAPE), near_far=NEAR_FAR)
    jp = jax_ckpt._unflatten(jm.init_params(jax.random.PRNGKey(0)), params_to_jax(seen["after"]))
    tc = YinYangSphericalCoords(aabb, exp_r=exp, r0=0.05, interval_th=exp)
    tc.set_resolution(reso, r0=0.05)
    tm = EgoNeRF(aabb, reso, tc, FieldConfig(**SHAPE), near_far=NEAR_FAR, device="cpu")
    tm.load_state_dict(seen["after"])
    row = trainer.sampler.next_batch()
    rays, rgbs = row[:, :6].numpy(), row[:, 6:9].numpy()
    key = jax.random.PRNGKey(11)
    k_coarse, k_pdf = jax.random.split(key)
    n = rays.shape[0]
    jitter = np.asarray(jax.random.uniform(k_coarse, (n, RENDER["n_coarse"])))
    u = np.asarray(jax_sorted_uniform(k_pdf, (n, RENDER["n_fine"])))
    out = jm.forward(jp, jnp.asarray(rays), key=key, is_train=True, exp_sampling=exp,
                     **RENDER)
    want = float(jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2))
    got_out = tm.forward(tm.params(), torch.from_numpy(rays), is_train=True,
                         exp_sampling=exp, jitter=torch.from_numpy(jitter),
                         u=torch.from_numpy(u), **RENDER)
    total, mse = trainer.loss(got_out, torch.from_numpy(rgbs), 4)
    assert float(total) == float(mse)  # the tiny config has no regularizer on
    assert float(mse) == pytest.approx(want, rel=1e-5)
