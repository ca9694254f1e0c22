"""The port's training slice against the JAX package, on the CPU, at a small
shape (N_voxel 24^3, n_lamb 4/8, app_dim 12, featureC 32, 16 + 16
samples): one training step's loss and gradients against
``jax.value_and_grad``, Adam against the optax chain, and the trainer, its
checkpoints (both ways) and its CLI."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords import coords_from_spec as jax_coords_from_spec
from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models import build_model as jax_build_model
from egonerf_tpu.models import model_meta as jax_model_meta
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.render.renderer import Renderer as JaxRenderer
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_tpu.train.config import parse_cli as jax_parse_cli
from egonerf_tpu.train.optim import make_optimizer
from egonerf_torch import __main__ as cli
from egonerf_torch import ops
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.data.datasets import SyntheticEgoDataset
from egonerf_torch.models import EgoNeRF, FieldConfig, params_from_jax, params_to_jax
from egonerf_torch.ops import vm_lookup
from egonerf_torch.render.renderer import Renderer
from egonerf_torch.train.checkpoint import load_checkpoint
from egonerf_torch.train.config import load_config, parse_cli
from egonerf_torch.train.optim import Optimizer
from egonerf_torch.train.trainer import Trainer, check_supported, render_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
NEAR_FAR = (0.05, 8.5)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32)
RENDER = dict(n_coarse=16, n_fine=16)
N_RAYS = 64
MAT_MODE = ((0, 1), (0, 2), (1, 2))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(compute_dtype):
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    jm = JaxEgoNeRF(AABB, jc.resolution, jc,
                    JaxFieldConfig(**SHAPE, compute_dtype=compute_dtype), near_far=NEAR_FAR)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**SHAPE, compute_dtype=compute_dtype),
                 near_far=NEAR_FAR, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(N_RAYS, 3)).astype(np.float32)
    rgbs = rng.uniform(0.0, 1.0, size=(N_RAYS, 3)).astype(np.float32)
    return np.concatenate([o, d], -1), rgbs


def plane_hits(coords, shape, i):
    """(S, H, W, 1) count of the corner entries with a nonzero weight that
    land in each cell of plane ``i``: the number of terms its sum adds."""
    s, h, w, _ = shape
    m0, m1 = MAT_MODE[i]
    hits = torch.zeros(s * h * w)
    for idx, wt in vm_lookup._plane_corners(coords[:, m0], coords[:, m1],
                                             coords[:, 3].to(torch.int64), h, w):
        hits.index_add_(0, idx, (wt != 0).float())
    return hits.reshape(s, h, w, 1).numpy()


class _Recorder:
    """An ``Ops`` field_bwd that keeps its cotangents (for the bf16 bound)."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return vm_lookup.field_bwd_plain(*args)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def step(request):
    """One training step on both sides, with JAX's draws: k_coarse, k_pdf =
    split(key); the jitter uniform(k_coarse); u = sorted_uniform(k_pdf)."""
    compute_dtype = request.param
    jm, jp, tm = _pair(compute_dtype)
    rays, rgbs = _batch()
    key = jax.random.PRNGKey(5)
    k_coarse, k_pdf = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k_coarse, (N_RAYS, RENDER["n_coarse"])))
    u = np.asarray(jax_sorted_uniform(k_pdf, (N_RAYS, RENDER["n_fine"])))

    def loss_fn(p):
        out = jm.forward(p, jnp.asarray(rays), key=key, is_train=True, **RENDER)
        return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    rec = _Recorder()
    tm.ops = ops.KERNELS._replace(field_bwd=rec)
    params = tm.params()
    out = tm.forward(params, torch.from_numpy(rays), is_train=True,
                     jitter=torch.from_numpy(jitter), u=torch.from_numpy(u), **RENDER)
    loss = torch.mean((out["rgb"] - torch.from_numpy(rgbs)) ** 2)
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in params.items()})
    return dict(compute_dtype=compute_dtype, want_loss=float(want_loss), loss=float(loss),
                want=jax_ckpt._flatten(want_grads), got=got, rec=rec, tm=tm, out=out)


def test_step_loss_matches_jax(step):
    """The MSE: float32 sums in another order through the coarse cdf, the
    field, the shader and the composite; rel 1e-5."""
    assert step["loss"] == pytest.approx(step["want_loss"], rel=1e-5)
    assert step["out"]["rgb"].requires_grad and not step["out"]["depth"].requires_grad


def test_step_gradients_match_jax(step):
    """Every gradient tensor against jax.value_and_grad.  float32 sums in
    another order (scatter-adds, matmuls, cumsums): rel 1e-4 of each
    tensor's largest entry.  Under bfloat16 JAX scatter-adds the plane
    gradients in bf16 (fastgrad); there each plane cell is held to the
    bound of test_torch_grad: (hits + 1) * 2**-8 * sum|terms|, with the
    terms from this step's own cotangents.  The hat lines round each
    cotangent to bf16 on both sides, and float32 cotangents that differ in
    the last bits (d_app comes out of the basis matmul's backward) may round
    to neighbouring bf16 values, one bf16 ulp (<= 2**-7 relative) apart:
    there the bound adds 2**-7 * sum|terms|."""
    got, want = step["got"], step["want"]
    assert sorted(got) == sorted(want)
    bf16_planes = step["compute_dtype"] == "bfloat16"
    if bf16_planes:
        coords, planes, lines, d_dens, d_app, n_density, line_hat = step["rec"].args
        mag_p, mag_l = vm_lookup.field_bwd_plain(coords, planes, lines, d_dens, d_app,
                                                 n_density, line_hat, magnitude=True)
    for k in sorted(want):
        g, w = got[k], np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        if bf16_planes and ("planes" in k or "lines" in k):
            i = int(k.split("/")[1])
            cd = n_density[i]
            sl = slice(None, cd) if k.startswith("density") else slice(cd, None)
            if "planes" in k:
                hits = plane_hits(coords, planes[i].shape, i)
                bound = (hits + 1) * 2.0 ** -8 * mag_p[i][..., sl].numpy()
            else:
                assert line_hat[i]
                bound = 2.0 ** -7 * mag_l[i][..., sl].numpy()
            assert np.all(np.abs(g - w) <= bound + 1e-4 * np.abs(w).max() + 1e-12), k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                       err_msg=k)


def test_step_kernels_and_plain_agree_on_cpu(step):
    """The Ops pair of each Function is swappable: the plain versions give
    the same loss and gradients (on the CPU the wrappers take them)."""
    tm = step["tm"]
    rays, rgbs = _batch()
    draws = dict(jitter=torch.rand(N_RAYS, RENDER["n_coarse"],
                                   generator=torch.Generator().manual_seed(0)),
                 u=ops.sorted_uniform(N_RAYS, RENDER["n_fine"], 0, 0, "cpu"))
    grads = []
    for o in (ops.KERNELS, ops.PLAIN):
        tm.ops = o
        params = tm.params()
        for p in params.values():
            p.grad = None
        out = tm.forward(params, torch.from_numpy(rays), is_train=True, **draws, **RENDER)
        torch.mean((out["rgb"] - torch.from_numpy(rgbs)) ** 2).backward()
        grads.append({k: p.grad.clone() for k, p in params.items()})
    tm.ops = ops.KERNELS
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_adam_matches_optax():
    """Three steps of the port's Adam against the optax chain of
    egonerf_tpu/train/optim.py on the same gradients: the grid and network
    lr groups and the per-step decay factor**count (count 0 on the first
    step).  float32 arithmetic in another order: rel 1e-5."""
    jm, jp, tm = _pair("bfloat16")
    params = tm.params()
    rng = np.random.default_rng(3)
    tx = make_optimizer(jp, 0.02, 1e-3, 0.0, decay_target_ratio=0.1, decay_iters=4)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    opt = Optimizer(params, 0.02, 1e-3, 0.0, decay_target_ratio=0.1, decay_iters=4)
    jparams = jp
    for _ in range(3):
        flat = {k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in jax_ckpt._flatten(jparams).items()}
        grads = jax_ckpt._unflatten(jparams, flat)
        updates, state = update(grads, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for name, g in params_from_jax(flat, device="cpu").items():
            params[name].grad = g
        opt.step()
    want = jax_ckpt._flatten(jparams)
    got = params_to_jax(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert opt.count == 3


def test_adam_lr_groups():
    _, _, tm = _pair("bfloat16")
    opt = Optimizer(tm.params(), 0.02, 1e-3, 0.0)
    groups = {g["group"]: len(g["params"]) for g in opt.adam.param_groups}
    assert groups == {"grid": 12, "network": 7}


def _tiny_cfg(tmp_path, **over):
    base = dict(
        dataset_name="synthetic", model_name="EgoNeRF", coordinates_name="yinyang",
        exp_sampling=True, interval_th=True, r0="0.05", resampling=True,
        use_coarse_sample=True, n_coarse=16, n_fine=16, batch_size=512,
        n_iters=30, N_voxel_init=24 ** 3, N_voxel_final=24 ** 3,
        n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
        shadingMode="MLP_Fea", fea2denseAct="softplus", density_shift="-8",
        featureC=32, view_pe=2, fea_pe=2, lr_init=0.02, lr_basis=1e-3, sparsity_lambda=0,
        near_far="[0.05, 8.5]", progress_refresh_rate=5, basedir=str(tmp_path),
        expname="e2e", N_vis=1, vis_list="[30]", i_weights=10 ** 7, eval_chunk=512)
    base.update(over)
    return base


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    trainer = Trainer(load_config(overrides=_tiny_cfg(tmp)), device="cpu")
    psnrs = trainer.train()
    return trainer, tmp, psnrs


def test_trainer_lowers_the_mse(trained):
    """30 steps on the synthetic scene lower the logged MSE."""
    import json

    trainer, _, psnrs = trained
    with open(os.path.join(trainer.logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    mses = [r["value"] for r in rows if r["tag"] == "train/mse"]
    assert len(mses) == 6
    assert np.mean(mses[-2:]) < 0.95 * mses[0], mses
    assert len(psnrs) == 1 and np.isfinite(psnrs[0])
    assert os.path.exists(os.path.join(trainer.logdir, "imgs_vis", "000029_mean.txt"))


def test_port_checkpoint_renders_in_jax(trained):
    """The port's final checkpoint loads in egonerf_tpu (load_checkpoint +
    unflatten_params) and renders the same rays within the eval tolerance
    (rgb 1e-5, depth 1e-4, as tests/test_torch_model.py)."""
    trainer, tmp, _ = trained
    path = os.path.join(trainer.logdir, "e2e.npz")
    flat, header, masks = jax_ckpt.load_checkpoint(path)
    assert header["global_step"] == 30 and not masks
    jcfg = jax_load_config(overrides=_tiny_cfg(tmp))
    coords = jax_coords_from_spec(header["coords_spec"])
    jm = jax_build_model(jcfg, coords.aabb, coords.resolution, coords, trainer.near_far,
                         meta=header["model_meta"])
    # the meta holds every field of JAX's FieldConfig, so nothing defaults
    assert set(header["model_meta"]) == set(dataclasses.asdict(JaxFieldConfig())) | {
        "model_name"}
    jp = jax_ckpt.unflatten_params(jm.init_params(jax.random.PRNGKey(1)), flat)
    rays = trainer.test_dataset.all_rays[0][::37]
    want = JaxRenderer(jm, chunk=256, **RENDER).render_rays(jp, rays)
    got = Renderer(trainer.model, chunk=256, **RENDER).render_rays(trainer.params, rays)
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"], rtol=0, atol=1e-4)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpoint in the log folder resumes: the step count, the
    weights and the lr decay continue from it."""
    cfg = load_config(overrides=_tiny_cfg(tmp_path, n_iters=9, N_vis=0))
    aabb = SyntheticEgoDataset(split="train", near_far=cfg.near_far).scene_bbox
    jc = JaxYinYang(aabb, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    jm = JaxEgoNeRF(aabb, jc.resolution, jc, JaxFieldConfig(**SHAPE), near_far=NEAR_FAR)
    jp = jm.init_params(jax.random.PRNGKey(4))
    logdir = os.path.join(str(tmp_path), "e2e")
    jax_ckpt.save_checkpoint(os.path.join(logdir, "e2e_000007.npz"), jp, global_step=7,
                             coords_spec=jc.to_spec(), model_meta=jax_model_meta(None, jm))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.start_step == 7 and trainer.optimizer.count == 7
    got = params_to_jax(trainer.params)
    for k, v in jax_ckpt._flatten(jp).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    trainer.train()
    assert trainer.optimizer.count == 9
    _, header = load_checkpoint(os.path.join(logdir, "e2e.npz"))
    assert header["global_step"] == 9


def test_render_test_reads_the_checkpoint(trained):
    trainer, tmp, _ = trained
    cfg = load_config(overrides=_tiny_cfg(tmp))
    psnrs = render_test(cfg, device="cpu")
    assert len(psnrs) == 2 and all(np.isfinite(psnrs))
    row = np.loadtxt(os.path.join(trainer.logdir, "evaluation", "mean.txt"))
    assert row.shape == (5,) and row[0] == pytest.approx(np.mean(psnrs))


UNPORTED = {
    "tv": dict(TV_weight_density=0.1),
    "l1": dict(L1_weight_initial=1e-4),
    "ortho": dict(Ortho_weight=1e-3),
    "entropy": dict(entropy_weight=1e-3),
    "sparsity": dict(sparsity_lambda=0.1),
    "depth": dict(use_depth=True),
    "upsample": dict(upsamp_list="[10]"),
    "alpha_mask": dict(update_AlphaMask_list="[10]"),
    "cull": dict(train_keep=8),
    "theta_importance": dict(sampling_method="theta_importance"),
    "filter_ray": dict(filter_ray=True),
    "mesh": dict(mesh_shape="[4]"),
    "linear_sampling": dict(exp_sampling=False),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise(tmp_path, name):
    cfg = load_config(overrides=_tiny_cfg(tmp_path, **UNPORTED[name]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(cfg)


def test_sentinel_schedules_are_accepted(tmp_path):
    """configs/egonerf/common.txt disables upsampling and the alpha mask
    with entries beyond any run; those pass."""
    cfg = parse_cli(["--config", os.path.join(REPO, "configs", "smoke", "synthetic.txt")])
    assert min(cfg.upsamp_list) > cfg.n_iters and min(cfg.update_AlphaMask_list) > cfg.n_iters
    check_supported(cfg)


def test_cli_parses_the_smoke_config():
    """The port's parser reads configs/smoke/synthetic.txt (with its
    include chain) as the JAX parser does."""
    argv = ["--config", os.path.join(REPO, "configs", "smoke", "synthetic.txt"),
            "--n_iters", "300", "--vis_list", "[300]"]
    got, want = dataclasses.asdict(parse_cli(argv)), dataclasses.asdict(jax_parse_cli(argv))
    assert got == want
    assert got["n_iters"] == 300 and got["vis_list"] == [300]


def test_cli_runs_on_the_card_by_default(monkeypatch):
    """``python -m egonerf_torch`` trains on the card: without one it
    raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", os.path.join(REPO, "configs", "smoke", "synthetic.txt")])
