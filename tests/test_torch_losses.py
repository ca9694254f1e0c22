"""The entropy, sparsity and depth losses of the port against the JAX
package, on the CPU at small shapes: ``ray_entropy``; the composite's alpha
output and its cotangent (K6's and K6b's training instantiations, through
their plain versions); the density-only lookup with its gradient (K3's
training instantiation and K2 at no appearance channels); each model's
``sparsity_density`` on JAX's points; the trainer's total loss and every
gradient against a transcription of JAX's ``loss_fn``; the entropy and
depth weights; the depth term; JAX's error on a depthless loader; and the
10-float rows of the three samplers.  Inputs come from numpy seeds or JAX
keys and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords import coords_from_spec as jax_coords_from_spec
from egonerf_tpu.models import build_model as jax_build_model
from egonerf_tpu.ops.volrend import ray_entropy as jax_ray_entropy
from egonerf_tpu.ops.volrend import raw2alpha as jax_raw2alpha
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch import ops
from egonerf_torch.data import samplers
from egonerf_torch.data.datasets import SyntheticEgoDataset
from egonerf_torch.models import model_meta, params_to_jax
from egonerf_torch.ops import vm_lookup, volrend
from egonerf_torch.ops.sampler import theta_batch_plain
from egonerf_torch.train import trainer as trainer_mod
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer
from test_torch_tensorf import THRES, _egonerf_pair
from test_torch_tensorf import _pair as tensorf_pair
from test_torch_train import _tiny_cfg

SHIFT, SCALE = -8.0, 25.0
LOSSES = dict(entropy_weight=1e-3, sparsity_lambda=0.1, use_depth=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max|want| elementwise."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-30,
                               err_msg=what)


# ---------------------------------------------------------------------------
# ray_entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ones", [False, True], ids=["samples", "with_ones_column"])
def test_ray_entropy_matches_jax(ones):
    """Value and gradient against JAX's ``ray_entropy`` under ``jax.grad``,
    with rows of all-zero alpha (prob 0, log2(1e-10)) and, under the
    envmap, JAX's column of ones.  float32 sums and log2 of two libraries:
    rel 1e-5 of the value, 1e-5 of the largest gradient entry."""
    rng = np.random.default_rng(0)
    alpha = rng.uniform(0.0, 1.0, (24, 37)).astype(np.float32) ** 3
    alpha[3] = 0.0
    alpha[7, ::2] = 0.0
    if ones:
        alpha = np.concatenate([alpha, np.ones_like(alpha[:, :1])], -1)
    want, want_g = jax.value_and_grad(jax_ray_entropy)(jnp.asarray(alpha))
    a = torch.from_numpy(alpha).requires_grad_(True)
    got = volrend.ray_entropy(a)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _close(a.grad, want_g, 1e-5)


# ---------------------------------------------------------------------------
# the composite's alpha and its cotangent (K6, K6b training instantiations)
# ---------------------------------------------------------------------------
def _problem(seed, r=40, s=33, gates=False):
    rng = np.random.default_rng(seed)
    p = dict(feat=rng.normal(6.0, 5.0, (r, s)), dists=rng.uniform(0.0, 0.08, (r, s)),
             rgb=rng.uniform(-0.3, 1.3, (r, s, 3)), dz=rng.normal(size=r),
             env=rng.uniform(0.0, 1.0, (r, 3)), g=rng.normal(size=(r, 3)),
             g_alpha=rng.normal(size=(r, s + 1)))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["z"] = np.cumsum(p["dists"], -1).astype(np.float32)
    p["valid"] = rng.uniform(size=(r, s)) > 0.3 if gates else None
    return p


def _jax_composite(p, form):
    """JAX's composite (``models/egonerf.py:466-493``, ``tensorf.py:226-258``)
    as a function of (feat, rgb, env): (rgb_map, alpha), alpha with the
    column of ones under the envmap."""
    def run(f, c, e):
        sigma = jax.nn.softplus(f + SHIFT)
        if form == "gated":
            sigma = jnp.where(jnp.asarray(p["valid"]), sigma, 0.0)
        alpha, weight, bg = jax_raw2alpha(sigma, jnp.asarray(p["dists"]) * SCALE)
        if form == "gated":
            c = jnp.where((weight > THRES)[..., None], c, 0.0)
        rgb_map = jnp.sum(weight[..., None] * c, -2)
        if form == "envmap":
            alpha = jnp.concatenate([alpha, jnp.ones_like(alpha[..., :1])], -1)
            rgb_map = rgb_map + bg * e
        return jnp.clip(rgb_map, 0.0, 1.0), alpha
    return run


@pytest.mark.parametrize("form", ["indoor", "envmap", "gated"])
def test_composite_alpha_and_its_cotangent_match_jax(form):
    """``composite_plain(with_alpha=True)``'s alpha and
    ``composite_bwd_plain(d_alpha=...)`` against ``jax.vjp`` of JAX's
    raw2alpha + composite (+ the ray entropy's input, alpha) with both
    cotangents: indoor, with the envmap's radiance (the ones column's
    cotangent dropped) and TensoRF's gates with invalid samples.  float32
    sums in another order: rel 1e-5 of the largest entry; invalid samples
    take exactly no density gradient."""
    p = _problem(1, gates=form == "gated")
    t = {k: torch.from_numpy(v) for k, v in p.items() if v is not None}
    env = t["env"] if form == "envmap" else None
    valid = t.get("valid")
    thres = THRES if form == "gated" else None
    s = p["feat"].shape[1]
    run = _jax_composite(p, form)
    (want_rgb, want_alpha), vjp = jax.vjp(run, jnp.asarray(p["feat"]), jnp.asarray(p["rgb"]),
                                          jnp.asarray(p["env"]))
    g_alpha = p["g_alpha"] if form == "envmap" else p["g_alpha"][:, :s]
    want_f, want_c, want_e = vjp((jnp.asarray(p["g"]), jnp.asarray(g_alpha)))
    outs = volrend.composite(t["feat"], t["dists"], t["z"], t["rgb"], t["dz"], SHIFT, SCALE,
                             "softplus", env, valid, thres, with_alpha=True)
    alpha = outs[-1]
    assert alpha.shape == (p["feat"].shape[0], s)
    _close(outs[0], want_rgb, 1e-5, "rgb")
    _close(alpha, np.asarray(want_alpha)[:, :s], 1e-6, "alpha")
    grads = volrend.composite_bwd(t["feat"], t["dists"], t["rgb"], t["g"], SHIFT, SCALE,
                                  "softplus", env, valid, thres,
                                  d_alpha=torch.from_numpy(g_alpha[:, :s].copy()))
    _close(grads[0], want_f, 1e-5, "d_feat")
    _close(grads[1], want_c, 1e-5, "d_rgb")
    if form == "envmap":
        _close(grads[2], want_e, 1e-5, "d_env")
    if form == "gated":
        assert (grads[0].numpy()[~p["valid"]] == 0).all()
        assert (alpha.numpy()[~p["valid"]] == 0).all()


def test_composite_train_routes_the_alpha_cotangent():
    """Through the autograd Function: the entropy's gradient reaches feat
    only through alpha (K6b's d_alpha), equal to ``composite_bwd_plain``
    with a zero rgb cotangent; without ``with_alpha`` the outputs are the
    default form's, bit for bit; the envmap form (K6e) gives the same alpha
    as the form with its radiance given."""
    p = _problem(2)
    t = {k: torch.from_numpy(v) for k, v in p.items() if v is not None}
    feat = t["feat"].clone().requires_grad_(True)
    outs = volrend.composite_train(feat, t["dists"], t["z"], t["rgb"], t["dz"], SHIFT, SCALE,
                                   "softplus", with_alpha=True)
    volrend.ray_entropy(outs[-1]).backward()
    with torch.enable_grad():
        a = outs[-1].detach().requires_grad_(True)
        d_alpha, = torch.autograd.grad(volrend.ray_entropy(a), a)
    want = volrend.composite_bwd_plain(t["feat"], t["dists"], t["rgb"], torch.zeros_like(t["g"]),
                                       SHIFT, SCALE, "softplus", d_alpha=d_alpha)[0]
    assert torch.equal(feat.grad, want)
    plain = volrend.composite(t["feat"], t["dists"], t["z"], t["rgb"], t["dz"], SHIFT, SCALE)
    for o, w in zip(outs[:4], plain):
        assert torch.equal(o, w)
    table = torch.from_numpy(np.random.default_rng(3).uniform(size=(16, 8, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        np.random.default_rng(4).normal(size=(p["feat"].shape[0], 3)).astype(np.float32)), dim=-1)
    k6e = volrend.composite(t["feat"], t["dists"], t["z"], t["rgb"], t["dz"], SHIFT, SCALE,
                            envmap=table, viewdirs=dirs, with_alpha=True)
    assert len(k6e) == 7 and torch.equal(k6e[-1], outs[-1])


# ---------------------------------------------------------------------------
# the density-only lookup (K3's training instantiation, K2 at n_app = 0)
# ---------------------------------------------------------------------------
def _coords(n, seed, two_grids):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    flag = (rng.uniform(size=(n, 1)) < 0.5).astype(np.float32) if two_grids else np.zeros(
        (n, 1), np.float32)
    return np.concatenate([xyz, flag], -1)


@pytest.mark.parametrize("model", ["EgoNeRF", "TensorVMSplit"])
def test_density_train_matches_jax_vjp(model):
    """``density_train`` (K3 with its relu mask, K2 with every channel a
    density channel, float32 line weights) against ``jax.vjp`` of JAX's
    ``compute_density_feature`` (S = 2) and ``compute_density_feature_only``
    (S = 1) on float32 tables.  Decomposition 0's planes are zero on grid
    0, so every sample there has an exactly zero partial: JAX's
    ``jnp.maximum`` passes half its gradient, and so must the mask's state
    1.  float32 sums in another order (lane order, scatter-adds): rel 1e-5
    of the largest entry."""
    n = 3000
    if model == "EgoNeRF":
        jm, jp, tm = _egonerf_pair()
    else:
        jm, jp, tm = tensorf_pair("float32")
    coords = _coords(n, 5, model == "EgoNeRF")
    planes = [np.asarray(p).copy() for p in jp["density_planes"]]
    lines = [np.asarray(l) for l in jp["density_lines"]]
    planes[0][0] = 0.0
    g = np.random.default_rng(6).normal(size=n).astype(np.float32)

    if model == "EgoNeRF":
        def jfn(pl, li):
            return jm.compute_density_feature(pl, li, jnp.asarray(coords))
    else:
        def jfn(pl, li):
            return jm.compute_density_feature_only(
                {"density_planes": pl, "density_lines": li}, jnp.asarray(coords[:, :3]))
    want, vjp = jax.vjp(jfn, [jnp.asarray(p) for p in planes], [jnp.asarray(l) for l in lines])
    want_p, want_l = vjp(jnp.asarray(g))
    tp = [torch.from_numpy(p).requires_grad_(True) for p in planes]
    tl = [torch.from_numpy(l.copy()).requires_grad_(True) for l in lines]
    c = torch.from_numpy(coords)
    got = vm_lookup.density_train(c, tp, tl)
    _close(got, want, 1e-5, "density")
    got.backward(torch.from_numpy(g))
    for i in range(3):
        _close(tp[i].grad, want_p[i], 1e-5, f"planes {i}")
        _close(tl[i].grad, want_l[i], 1e-5, f"lines {i}")
    _, mask = vm_lookup.density_fwd(c, [p.detach().to(torch.bfloat16) for p in tp],
                                    [l.detach().to(torch.bfloat16) for l in tl], with_mask=True)
    tie = (mask & 3) == 1
    assert int(tie.sum()) == int((coords[:, 3] == 0).sum()) > 0
    # the tie's half gradient: plane 0 of grid 0 gets g/2 times its line
    assert float(tp[0].grad[0].abs().max()) > 0


@pytest.mark.parametrize("model", ["EgoNeRF", "TensorVMSplit"])
def test_sparsity_density_matches_jax(model):
    """Each model's ``sparsity_density`` on the points JAX draws from its
    key (EgoNeRF: split, uniform coords and a Bernoulli(1/2) chart flag;
    TensorVMSplit: uniform coords), fed to the port, against JAX's, with
    the gradient of the loss term 1 - mean(exp(-0.2 sigma)) in every
    density table: sigma and the gradients rel 1e-5 of the largest entry
    (float32 sums in another order).  The term itself is 1 less a float32
    mean of values just below 1, whose rounding is an ulp of 1 (2**-24
    below it) whatever the term's size: abs 4 * 2**-24."""
    n = 2000
    key = jax.random.PRNGKey(11)
    if model == "EgoNeRF":
        jm, jp, tm = _egonerf_pair()
        k1, k2 = jax.random.split(key)
        pts = np.concatenate([
            np.asarray(jax.random.uniform(k1, (n, 3), minval=-1.0, maxval=1.0)),
            np.asarray(jax.random.bernoulli(k2, 0.5, (n, 1))).astype(np.float32)], -1)
    else:
        jm, jp, tm = tensorf_pair("float32")
        pts = np.asarray(jax.random.uniform(key, (n, 3), minval=-1.0, maxval=1.0))

    def jloss(p):
        sp = jm.sparsity_density(p, key, n)
        return 1.0 - jnp.mean(jnp.exp(-0.2 * sp)), sp

    (want_l, want_sp), want_g = jax.value_and_grad(jloss, has_aux=True)(jp)
    params = tm.params()
    sp = tm.sparsity_density(params, None, n, points=torch.from_numpy(pts.copy()))
    _close(sp, want_sp, 1e-5, "sigma")
    loss = 1.0 - torch.mean(torch.exp(-0.2 * sp))
    assert abs(loss.item() - float(want_l)) <= 4 * 2.0 ** -24
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in params.items() if p.grad is not None})
    want = jax_ckpt._flatten(want_g)
    density = sorted(k for k in want if k.startswith("density"))
    assert sorted(got) == density
    for k in density:
        _close(got[k], want[k], 1e-5, k)


def test_sparsity_points_come_from_the_generator():
    """Without ``points`` the draw is (n, 3) uniform in [-1, 1) and a flag
    in {0, 1} from the given generator, after whatever it drew before."""
    _, _, tm = _egonerf_pair()
    params = tm.params()
    a = tm.sparsity_density(params, torch.Generator().manual_seed(3), 500)
    gen = torch.Generator().manual_seed(3)
    xyz = torch.rand(500, 3, generator=gen) * 2.0 - 1.0
    flag = (torch.rand(500, 1, generator=gen) < 0.5).float()
    b = tm.sparsity_density(params, None, 500, points=torch.cat([xyz, flag], -1))
    assert torch.equal(a, b)
    assert 0 < float(flag.mean()) < 1 and float(xyz.min()) >= -1.0


# ---------------------------------------------------------------------------
# the trainer: the total loss and its gradients against JAX's loss_fn
# ---------------------------------------------------------------------------
TERMS = dict(LOSSES, Ortho_weight=1e-3, L1_weight_initial=1e-4, TV_weight_density=0.1,
             TV_weight_app=0.01, iter_ignore_entropy=1, depth_lambda=0.3, depth_step_size=2,
             depth_rate=0.5, N_sparsity_points=1500, compute_dtype="float32")


def _overrides(tmp_path, model, **over):
    if model == "TensorVMSplit":
        over = dict(model_name="TensorVMSplit", coordinates_name="xyz", exp_sampling=False,
                    resampling=False, use_coarse_sample=False, n_coarse=24, **over)
    return _tiny_cfg(tmp_path, **{**TERMS, **over})


def _trainer(tmp_path, model, **over):
    return Trainer(load_config(overrides=_overrides(tmp_path, model, **over)), device="cpu")


def _jax_side(trainer, overrides):
    """The JAX model with the trainer's weights, and JAX's params."""
    jcfg = jax_load_config(overrides=overrides)
    coords = jax_coords_from_spec(trainer.coords.to_spec())
    jm = jax_build_model(jcfg, coords.aabb, coords.resolution, coords, trainer.near_far,
                         meta=model_meta(trainer.cfg, trainer.model))
    jp = jax_ckpt.unflatten_params(jm.init_params(jax.random.PRNGKey(1)),
                                   params_to_jax(trainer.params))
    return jm, jp


def _jax_weights(cfg, it, sched_start, lr_factor):
    """JAX's ``dyn_of`` closed forms (``egonerf_tpu/train/trainer.py:
    266-289``) at iteration ``it``: the TV, entropy and depth weights, in
    float32."""
    it = jnp.int32(it)
    n_tv = jnp.maximum(jnp.minimum(it, cfg.iter_ignore_TV - 1) - sched_start + 1, 0)
    f_tv = jnp.power(jnp.float32(lr_factor), n_tv.astype(jnp.float32))
    n_e = jnp.maximum(it - max(sched_start, cfg.iter_ignore_entropy + 1) + 1, 0)
    w_e = cfg.entropy_weight * jnp.power(jnp.float32(lr_factor), n_e.astype(jnp.float32))
    w_d = cfg.depth_lambda * jnp.power(jnp.float32(cfg.depth_rate),
                                       (it // cfg.depth_step_size).astype(jnp.float32))
    if cfg.depth_end_iter is not None:
        w_d = jnp.where(it > cfg.depth_end_iter, 0.0, w_d)
    return dict(tv_d=cfg.TV_weight_density * f_tv, tv_a=cfg.TV_weight_app * f_tv, e=w_e, d=w_d)


def _batch(trainer, n=48):
    ds = trainer.train_dataset
    ids = np.random.default_rng(9).choice(ds.all_rays.shape[0], n, replace=False)
    row = np.concatenate([ds.all_rays[ids], ds.all_rgbs[ids], ds.all_depths[ids, None]], -1)
    row = row.astype(np.float32)
    row[::5, 9] = 0.0  # no depth supervision on these rays
    return row


@pytest.mark.parametrize("model", ["EgoNeRF", "TensorVMSplit"])
def test_trainer_loss_matches_jax_loss_fn(tmp_path, model):
    """``Trainer.loss`` with every term on (sparsity, Ortho, L1, TV,
    entropy, depth) against JAX's ``loss_fn`` (``egonerf_tpu/train/
    trainer.py:303-334``, transcribed with JAX's own model functions and
    ``ray_entropy``) on the same weights, the key=None forward and the
    sparsity points JAX's key draws: loss rel 1e-5, every parameter's
    gradient within 1e-3 in relative L2 norm (float32 sums in another
    order through the field, the shader, the composite and the scatter-adds
    of two sparsity lookups)."""
    overrides = _overrides(tmp_path, model)
    trainer = Trainer(load_config(overrides=overrides), device="cpu")
    cfg = trainer.cfg
    jm, jp = _jax_side(trainer, overrides)
    it = 3
    row = _batch(trainer)
    n = cfg.N_sparsity_points
    key = jax.random.PRNGKey(21)
    if model == "EgoNeRF":
        k1, k2 = jax.random.split(key)
        pts = np.concatenate([
            np.asarray(jax.random.uniform(k1, (n, 3), minval=-1.0, maxval=1.0)),
            np.asarray(jax.random.bernoulli(k2, 0.5, (n, 1))).astype(np.float32)], -1)
    else:
        pts = np.asarray(jax.random.uniform(key, (n, 3), minval=-1.0, maxval=1.0))
    dyn = _jax_weights(cfg, it, trainer._sched_start, trainer.lr_factor)
    fwd = dict(is_train=True, n_coarse=cfg.n_coarse, n_fine=cfg.n_fine,
               exp_sampling=cfg.exp_sampling, resampling=cfg.resampling,
               use_coarse_sample=cfg.use_coarse_sample)

    def loss_fn(p):
        r = jnp.asarray(row)
        out = jm.forward(p, r[:, :6], key=None, **fwd)
        mse = jnp.mean((out["rgb"] - r[:, 6:9]) ** 2)
        total = mse
        sp = jm.sparsity_density(p, key, n)
        total = total + cfg.sparsity_lambda * (1.0 - jnp.mean(jnp.exp(-cfg.sparsity_length * sp)))
        total = total + cfg.Ortho_weight * jm.vector_comp_diffs(p)
        total = total + cfg.L1_weight_initial * jm.density_l1(p)
        total = total + dyn["tv_d"] * jm.tv_loss_density(p)
        total = total + dyn["tv_a"] * jm.tv_loss_app(p)
        total = total + dyn["e"] * jax_ray_entropy(out["alpha"])
        mask = (r[:, 9] != 0).astype(jnp.float32)
        dloss = jnp.sum(mask * (out["depth"] - r[:, 9]) ** 2) / (jnp.sum(mask) + 1e-8)
        return total + dyn["d"] * dloss

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(jp)
    params = trainer.params
    rows = torch.from_numpy(row)
    out = trainer.model.forward(params, rows[:, :6], key=None, with_alpha=True, **fwd)
    total, _ = trainer.loss(out, rows[:, 6:9], it, rows[:, 9], torch.from_numpy(pts))
    assert float(total) == pytest.approx(float(want_loss), rel=1e-5)
    total.backward()
    got = params_to_jax({k: p.grad for k, p in params.items()})
    want = jax_ckpt._flatten(want_g)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        assert np.isfinite(got[k]).all(), k
        err = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-3, (k, err)


def test_loss_weights_match_jax_closed_forms(tmp_path):
    """``entropy_weight_at`` and ``depth_weight_at`` at iterations across
    ``iter_ignore_entropy``, ``depth_step_size`` and ``depth_end_iter``,
    from a resume point, against JAX's ``dyn_of`` closed forms in float32
    (the same float32 power and product; rel 1e-6 allows one ulp between
    numpy's and XLA's powf).  Before the entropy switches on its weight is
    0, as JAX leaves the term out."""
    trainer = _trainer(tmp_path, "EgoNeRF", iter_ignore_entropy=4, depth_end_iter=9,
                       depth_step_size=3, depth_rate=0.7, lr_decay_iters=20)
    trainer._sched_start = 2
    cfg = trainer.cfg
    for it in range(0, 14):
        dyn = _jax_weights(cfg, it, 2, trainer.lr_factor)
        e_want = float(dyn["e"]) if it > cfg.iter_ignore_entropy else 0.0
        assert trainer.entropy_weight_at(it) == pytest.approx(e_want, rel=1e-6, abs=0), it
        assert trainer.entropy_on(it) == (it > cfg.iter_ignore_entropy)
        assert trainer.depth_weight_at(it) == pytest.approx(float(dyn["d"]), rel=1e-6,
                                                            abs=0), it
    assert trainer.depth_weight_at(10) == 0.0 and trainer.depth_weight_at(9) > 0.0


def test_depth_term_value_and_zero_gradient(tmp_path):
    """The depth term alone (every other weight 0): its value is JAX's
    masked mean on the forward's depth, and it moves no parameter: JAX
    stops the depth's gradient, and the port's depth is not
    differentiable."""
    trainer = _trainer(tmp_path, "EgoNeRF", entropy_weight=0.0, sparsity_lambda=0.0,
                       Ortho_weight=0.0, L1_weight_initial=0.0, TV_weight_density=0.0,
                       TV_weight_app=0.0)
    row = torch.from_numpy(_batch(trainer))
    cfg = trainer.cfg
    out = trainer.model.forward(trainer.params, row[:, :6], key=None, is_train=True,
                                n_coarse=cfg.n_coarse, n_fine=cfg.n_fine)
    total, mse = trainer.loss(out, row[:, 6:9], 3, row[:, 9])
    mask = (row[:, 9] != 0).float()
    dloss = (mask * (out["depth"] - row[:, 9]) ** 2).sum() / (mask.sum() + 1e-8)
    assert float(total - mse) == pytest.approx(trainer.depth_weight_at(3) * float(dloss),
                                               rel=1e-6)
    assert not out["depth"].requires_grad
    (total - mse).backward()
    assert all(p.grad is None or not p.grad.any() for p in trainer.params.values())


class _Depthless(SyntheticEgoDataset):
    """A loader that gives no depths."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.all_depths = None


def test_depthless_loader_raises_jax_error(tmp_path, monkeypatch):
    """JAX's ``ValueError`` under ``use_depth`` with a loader that gives no
    depths, at construction and in ``set_datasets``."""
    monkeypatch.setattr(trainer_mod, "dataset_class", lambda name: _Depthless)
    with pytest.raises(ValueError, match="provides no depths"):
        _trainer(tmp_path, "EgoNeRF")
    monkeypatch.undo()
    trainer = _trainer(tmp_path, "EgoNeRF")
    scene = dict(n_train=2, n_test=1, height=8, width=16, near_far=trainer.cfg.near_far)
    with pytest.raises(ValueError, match="provides no depths"):
        trainer.set_datasets(_Depthless(split="train", **scene),
                             SyntheticEgoDataset(split="test", is_stack=True, **scene))


# ---------------------------------------------------------------------------
# the 10-float rows of the samplers
# ---------------------------------------------------------------------------
def test_samplers_carry_the_depth_column():
    """Under ``use_depth`` each sampler's resident buffer is (N, 10), rays |
    rgb | depth (JAX ``trainer.py:479-481``), and its rows are the buffer's
    rows of its ids; K14f's plain version at 10 floats draws the same ids as
    at 9 (the row width changes no draw) and gathers the 10-float rows."""
    ds = SyntheticEgoDataset(split="train", n_train=3, n_test=1, height=8, width=16)
    rays, rgbs, depths = ds.all_rays, ds.all_rgbs, ds.all_depths
    full = torch.from_numpy(np.concatenate([rays, rgbs, depths[:, None]], 1).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    dev_s = samplers.DeviceRaySampler(rays, rgbs, 64, gen, depths)
    assert torch.equal(dev_s.buffer, full)
    ids = torch.randint(0, full.shape[0], (64,), generator=torch.Generator().manual_seed(0))
    assert torch.equal(dev_s.next_batch(), full[ids])
    host = samplers.SimpleSampler(full.shape[0], 64, seed=1)
    want_ids = samplers.SimpleSampler(full.shape[0], 64, seed=1).nextids()
    host_s = samplers.HostRaySampler(rays, rgbs, host, "cpu", depths)
    assert torch.equal(host_s.next_batch(), full[torch.from_numpy(want_ids)])
    theta = samplers.ThetaImportanceSampler(4.0, full.shape[0], (16, 8), 64, [0, 1, 0, 1])
    th_s = samplers.DeviceThetaSampler(rays, rgbs, theta, 64, "cpu", seed=2, all_depths=depths)
    th_9 = samplers.DeviceThetaSampler(rays, rgbs, theta, 64, "cpu", seed=2)
    assert th_s.buffer.shape == (full.shape[0], 10) and th_9.buffer.shape[1] == 9
    ids10, rows10 = th_s.draw(1)
    ids9, rows9 = th_9.draw(1)
    assert torch.equal(ids10, ids9) and torch.equal(rows10, full[ids10])
    assert torch.equal(rows10[:, :9], rows9)
    ids_p, rows_p = theta_batch_plain(full, th_s.cdf, 16, 8, 64, 2, 1)
    assert torch.equal(ids_p, ids10) and torch.equal(rows_p, rows10)
    assert torch.equal(ops.KERNELS.theta_batch(full, th_s.cdf, 16, 8, 64, 2, 1)[1], rows10)
    with pytest.raises(ValueError, match="rows of"):
        ops.KERNELS.theta_batch(full[:, :8].contiguous(), th_s.cdf, 16, 8, 64, 2, 1)


def test_trainer_steps_with_the_three_losses(tmp_path):
    """A few trainer steps with every loss on, through ``train_step``: the
    buffer has the depth column, the forward is asked for alpha only while
    the entropy term is on, and the losses are finite."""
    trainer = _trainer(tmp_path, "EgoNeRF", iter_ignore_entropy=1)
    assert trainer.sampler.buffer.shape[1] == 10
    seen = []
    forward = trainer.model.forward

    def spy(*a, **kw):
        seen.append(kw.get("with_alpha"))
        return forward(*a, **kw)

    trainer.model.forward = spy
    for it in range(3):
        assert np.isfinite(float(trainer.train_step(it)))
    assert seen == [False, False, True]
