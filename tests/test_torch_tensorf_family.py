"""The rest of the TensoRF family in the port against the JAX package, on
the CPU at small shapes: TensorVM (K1, K2 and K3 without the relu),
TensorCP (K17 and K17b, the CP line product, through their plain
versions), ``shrink`` of all three, the NDC sampler and the NDC training
forward, ``filtering_rays`` and the trainer's ``filter_ray``, checkpoints
both ways, and each model trained by the trainer.  Inputs come from numpy
seeds or JAX keys and go to both sides."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.cartesian import CartesianCoords as JaxCartesian
from egonerf_tpu.models import model_meta as jax_model_meta
from egonerf_tpu.models import tensorf as jax_tensorf
from egonerf_tpu.models.alphamask import AlphaGridMask as JaxMask
from egonerf_tpu.models.alphamask import bake_alpha_mask as jax_bake
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.tensorf import TensorCP as JaxTensorCP
from egonerf_tpu.models.tensorf import TensorVM as JaxTensorVM
from egonerf_tpu.models.tensorf import TensorVMSplit as JaxTensorVMSplit
from egonerf_tpu.ops import vm_lookup as jvm
from egonerf_tpu.render.renderer import Renderer as JaxRenderer
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_tpu.train import trainer as jax_trainer
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch import ops
from egonerf_torch.coords.cartesian import CartesianCoords
from egonerf_torch.data.datasets import SyntheticEgoDataset
from egonerf_torch.models import (FieldConfig, TensorCP, TensorVM, TensorVMSplit, build_model,
                                  load_jax_checkpoint, model_meta, params_from_jax,
                                  params_to_jax)
from egonerf_torch.models import tensorf as port_tensorf
from egonerf_torch.models.alphamask import AlphaGridMask
from egonerf_torch.ops import cp, vm_lookup
from egonerf_torch.ops.vm_lookup import HAT, LINEAR
from egonerf_torch.render.renderer import Renderer
from egonerf_torch.train.checkpoint import load_checkpoint, mask_volumes, save_checkpoint
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer, check_supported
from test_torch_tensorf import (AABB, MAT_MODE, NEAR_FAR, RESO, SHAPE, VEC_MODE, _rays,
                                _single_grid)

CP_SHAPE = dict(SHAPE, density_n_comp=(6,), app_n_comp=(20,))
JAX_CLASSES = {"TensorVMSplit": JaxTensorVMSplit, "TensorVM": JaxTensorVM,
               "TensorCP": JaxTensorCP}
PORT_CLASSES = {"TensorVMSplit": TensorVMSplit, "TensorVM": TensorVM, "TensorCP": TensorCP}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, compute_dtype="bfloat16", reso=RESO, seed=0):
    """The JAX and the port's ``name`` with the same weights."""
    shape = CP_SHAPE if name == "TensorCP" else SHAPE
    jc = JaxCartesian(AABB)
    jc.set_resolution(reso)
    jm = JAX_CLASSES[name](AABB, reso, jc, JaxFieldConfig(**shape, compute_dtype=compute_dtype),
                           near_far=NEAR_FAR)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tc = CartesianCoords(AABB)
    tc.set_resolution(reso)
    tm = PORT_CLASSES[name](AABB, reso, tc, FieldConfig(**shape, compute_dtype=compute_dtype),
                            near_far=NEAR_FAR, device="cpu")
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max|want| elementwise."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-30,
                               err_msg=what)


def _grads_of(params):
    """The gradients under JAX flat keys, zeros where none flowed (JAX's
    grad gives zeros for the parameters a function does not read)."""
    return params_to_jax({k: p.grad if p.grad is not None else torch.zeros_like(p)
                          for k, p in params.items()})


def _points(n, seed):
    return np.random.default_rng(seed).uniform(-1.1, 1.1, (n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# TensorVM: K1, K2, K3 without the relu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hat", [False, True], ids=["f32_lines", "hat_lines"])
def test_vm_field_no_relu_matches_jax(hat):
    """K1's and K2's relu-free plain versions at S = 1 against JAX's
    lookups summed raw (``TensorVM.compute_field``'s products), with
    negative partials and decomposition 0's density channels zeroed, so
    that its partial is exactly 0: the relu would halve that gradient, the
    raw sum passes it whole.  float32 sums in another order: forward rel
    1e-6, gradients 1e-5 of each tensor's largest entry."""
    n_density = (4, 4, 4)
    planes, lines, xyz, coords = _single_grid(3, 3000)
    planes[0] = planes[0].copy()
    planes[0][..., :4] = 0.0
    line_fn = jvm.sample_line_hat if hat else jvm.sample_line_packed
    plane_fn = jvm.sample_plane_packed_fastgrad if hat else jvm.sample_plane_packed
    c = jnp.asarray(xyz)

    def field(ps, ls):
        dens, app = 0.0, []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            pr = plane_fn(ps[i], c[:, m0], c[:, m1], None) * line_fn(ls[i], c[:, VEC_MODE[i]],
                                                                     None)
            dens = dens + jnp.sum(pr[:, :n_density[i]], axis=-1)
            app.append(pr[:, n_density[i]:])
        return dens, jnp.concatenate(app, axis=-1)

    (want_d, want_a), vjp = jax.vjp(field, [jnp.asarray(p) for p in planes],
                                    [jnp.asarray(l) for l in lines])
    bf = [torch.tensor(t).to(torch.bfloat16) for t in planes + lines]
    cc = torch.from_numpy(coords)
    got_d, got_a = vm_lookup.field_fwd(cc, bf[:3], bf[3:], n_density, (hat,) * 3, relu=False)
    assert float(want_d.min()) < 0.0
    _close(got_d, want_d, 1e-6, "density")
    _close(got_a, want_a, 1e-6, "appearance")
    with pytest.raises(ValueError, match="relu-free"):
        vm_lookup.field_fwd(cc, bf[:3], bf[3:], n_density, (hat,) * 3, with_mask=True,
                            relu=False)
    if hat:
        return  # the fastgrad planes scatter in bf16 (test_torch_grad bounds it)
    rng = np.random.default_rng(4)
    d_dens = rng.normal(size=3000).astype(np.float32)
    d_app = rng.normal(size=(3000, 24)).astype(np.float32)
    want_p, want_l = vjp((jnp.asarray(d_dens), jnp.asarray(d_app)))
    got_p, got_l = vm_lookup.field_bwd(cc, bf[:3], bf[3:], torch.from_numpy(d_dens),
                                       torch.from_numpy(d_app), None, n_density, (hat,) * 3,
                                       relu=False)
    for g, w in zip(got_p + got_l, list(want_p) + list(want_l)):
        _close(g, w, 1e-5)
    # the zero partial: plane 0's density gradient is d_dens * line whole
    assert np.abs(np.asarray(want_p[0])[..., :4]).max() > 0


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_vm_density_and_sparsity_match_jax(compute_dtype):
    """TensorVM's density alone (K3 relu-free: the bake's lookup) and its
    sparsity density with its gradient (K3 relu-free, K2 relu-free at no
    appearance channels) against JAX's ``compute_density_feature_only``
    on the same points: rel 1e-5 (sums in another order), gradients 1e-4
    of each tensor's largest entry."""
    jm, jp, tm = _pair("TensorVM", compute_dtype)
    for k in ("density_planes", "density_lines"):
        jp[k] = [3.0 * a for a in jp[k]]
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    pts = _points(2000, 5)
    want = np.asarray(jm.compute_density_feature_only(jp, jnp.asarray(pts)))
    assert want.min() < 0.0
    params = tm.params()
    got = tm.compute_density_feature_only(params, torch.nn.functional.pad(
        torch.from_numpy(pts), (0, 1)))
    _close(got, want, 1e-5)

    def sp(p):
        return jnp.sum(jax_tensorf.feature2density(
            jm.compute_density_feature_only(p, jnp.asarray(pts)), jm.cfg))
    want_g = jax_ckpt._flatten(jax.grad(sp)(jp))
    tm.sparsity_density(params, None, 0, points=torch.from_numpy(pts)).sum().backward()
    got_g = _grads_of(params)
    for k in ("density_planes/0", "density_planes/1", "density_lines/2"):
        _close(got_g[k], want_g[k], 1e-4, k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vm_forward_matches_jax(train):
    """TensorVM.forward against JAX's: the eval forward (key=None, K1 on the
    bf16 tables) and a training forward fed JAX's jitter, rgb abs 1e-5 and
    depth abs 1e-4 (float32 sums in another order); in training also
    every gradient of the MSE, rel 1e-4 of each tensor's largest entry."""
    jm, jp, tm = _pair("TensorVM", "float32" if train else "bfloat16")
    rays = _rays(64, seed=8)
    key = jax.random.PRNGKey(9)
    rgbs = np.random.default_rng(9).uniform(size=(64, 3)).astype(np.float32)
    params = tm.params()
    if not train:
        want = jax.jit(lambda p, r: jm.forward(p, r, n_coarse=40))(jp, jnp.asarray(rays))
        with torch.no_grad():
            got = tm.forward(params, torch.from_numpy(rays), n_coarse=40,
                             tables=tm.lookup_tables(params))
    else:
        def loss_fn(p):
            out = jm.forward(p, jnp.asarray(rays), key=key, is_train=True, n_coarse=32)
            return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2), out
        (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
        jitter = torch.tensor(np.asarray(jax.random.uniform(key, (64, 32))))
        got = tm.forward(params, torch.from_numpy(rays), is_train=True, n_coarse=32,
                         jitter=jitter)
        torch.mean((got["rgb"] - torch.from_numpy(rgbs)) ** 2).backward()
        want_g, got_g = jax_ckpt._flatten(grads), _grads_of(params)
        assert sorted(want_g) == sorted(got_g)
        for k in sorted(want_g):
            _close(got_g[k], want_g[k], 1e-4, k)
    np.testing.assert_allclose(got["rgb"].detach().numpy(), np.asarray(want["rgb"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["depth"].detach().numpy(), np.asarray(want["depth"]),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# TensorCP: K17, K17b
# ---------------------------------------------------------------------------
CP_FORMS = {"bf16_hat": ("bfloat16", True), "float32": ("float32", True),
            "line_hat_off": ("bfloat16", False)}


@pytest.fixture
def line_hat(monkeypatch):
    """Set ``EGONERF_LINE_HAT`` in both packages' TensoRF modules."""
    def set_(on: bool):
        monkeypatch.setattr(jax_tensorf, "_LINE_HAT", on)
        monkeypatch.setattr(port_tensorf, "_LINE_HAT", on)
    return set_


@pytest.mark.parametrize("form", sorted(CP_FORMS))
def test_cp_field_matches_jax(form, line_hat):
    """TensorCP.compute_field (K17's training form and K17b through their
    plain versions) against jax.vjp of JAX's, at 6 density channels (JAX
    pads them to 32) and 20 appearance: bf16 compute on the hat path,
    float32 compute and bf16 under ``EGONERF_LINE_HAT=0`` (float32 line
    weights); the density and the appearance product at rel 1e-6 (float32
    sums in another order), every gradient at 1e-5 of its largest entry.
    The eval form (bf16 tables) gives the training form's values."""
    dtype, hat = CP_FORMS[form]
    line_hat(hat)
    jm, jp, tm = _pair("TensorCP", dtype)
    pts = _points(3000, 6)
    (want_d, want_a), vjp = jax.vjp(lambda p: jm.compute_field(p, jnp.asarray(pts)), jp)
    params = tm.params()
    coords = torch.nn.functional.pad(torch.from_numpy(pts), (0, 1))
    modes = tm._line_hat(tm.fused_lines(params), 3000)
    assert modes == [vm_lookup.HAT if hat and dtype == "bfloat16" else vm_lookup.LINEAR] * 3
    got_d, got_a = tm.compute_field(params, coords)
    _close(got_d, want_d, 1e-6, "density")
    _close(got_a, want_a, 1e-6, "appearance")
    with torch.no_grad():
        ev_d, ev_a = tm.compute_field(params, coords, tm.lookup_tables(params))
    assert torch.equal(ev_d, got_d) and torch.equal(ev_a, got_a)
    rng = np.random.default_rng(7)
    d_dens = rng.normal(size=3000).astype(np.float32)
    d_app = rng.normal(size=(3000, SHAPE["app_dim"])).astype(np.float32)
    want = jax_ckpt._flatten(vjp((jnp.asarray(d_dens), jnp.asarray(d_app)))[0])
    torch.autograd.backward([got_d, got_a], [torch.from_numpy(d_dens), torch.from_numpy(d_app)])
    got = _grads_of(params)
    # on the hat path each term's cotangent is rounded to bf16, and the
    # appearance cotangents come from d_app @ basis^T summed in another
    # order: an ulp there flips a rounding, a bf16 ulp of one term (2^-8 of
    # it): 1e-4 of the largest entry; float32 sums alone: 1e-5
    tol = 1e-4 if modes[0] == vm_lookup.HAT else 1e-5
    for k in ("density_lines/0", "density_lines/1", "density_lines/2", "app_lines/0",
              "app_lines/1", "app_lines/2", "basis"):
        _close(got[k], want[k], tol, k)


def test_cp_plain_versions_match_jax_products():
    """cp_fwd_plain and cp_bwd_plain alone against jax.vjp of JAX's
    ``_line_products`` summed and sliced as ``compute_field`` does, on the
    fused (1, L, 6 + 20) lines in both line modes; the kernel's wrapper on
    CPU tensors is the plain version (bit for bit); the density-only form
    (C == n_density) equals the fused form's density."""
    jm, jp, tm = _pair("TensorCP", "bfloat16")
    pts = _points(2000, 8)
    coords = torch.nn.functional.pad(torch.from_numpy(pts), (0, 1))
    fused = [l.detach() for l in tm.fused_lines(tm.params())]
    rng = np.random.default_rng(9)
    d_dens = rng.normal(size=2000).astype(np.float32)
    d_app = rng.normal(size=(2000, 20)).astype(np.float32)
    for mode, fn in ((vm_lookup.HAT, jvm.sample_line_hat),
                     (vm_lookup.LINEAR, jvm.sample_line_packed)):
        def prod(ls):
            out = None
            for i in range(3):
                l = fn(ls[i], jnp.asarray(pts)[:, VEC_MODE[i]], None)
                out = l if out is None else out * l
            return jnp.sum(out[:, :6], axis=-1), out[:, 6:]
        (want_d, want_a), vjp = jax.vjp(prod, [jnp.asarray(l.numpy()) for l in fused])
        got_d, got_a = cp.cp_fwd_plain(coords, fused, 6, (mode,) * 3)
        _close(got_d, want_d, 1e-6)
        _close(got_a, want_a, 1e-6)
        k_d, k_a = cp.cp_fwd(coords, fused, 6, (mode,) * 3)
        assert torch.equal(k_d, got_d) and torch.equal(k_a, got_a)
        want_g = vjp((jnp.asarray(d_dens), jnp.asarray(d_app)))[0]
        got_g = cp.cp_bwd_plain(coords, fused, torch.from_numpy(d_dens),
                                torch.from_numpy(d_app), 6, (mode,) * 3)
        for g, w in zip(got_g, want_g):
            _close(g, w, 1e-5)
        dens_only = [l[..., :6].contiguous() for l in fused]
        only_d, only_a = cp.cp_fwd(coords, dens_only, 6, (mode,) * 3)
        assert torch.equal(only_d, got_d) and only_a.shape == (2000, 0)
    with pytest.raises(ValueError, match="float32"):
        cp.cp_bwd(coords, [l.to(torch.bfloat16) for l in fused], torch.from_numpy(d_dens),
                  torch.from_numpy(d_app), 6, (1,) * 3)
    with pytest.raises(ValueError, match="line modes"):
        cp._dims(fused, 6, (2, 0, 0), cp.Layout(32, True))


def test_cp_layout():
    """The vector instantiation needs C and n_density multiples of 4 and
    aligned tensors; K17's plan at CP-384 stages 32-channel slices (1,500
    rows x 64 bytes, two tiles' rows and three tiles' coords, two blocks an
    SM: 12 slices, 3 of density, 22 parts of the 1,048,576 samples), at 96
    density channels
    3 slices, at 6 + 20 one slice of 32 written directly; the unstaged
    form's lanes cover C / 4 chunks, at most 32."""
    coords = torch.zeros(8, 4)
    lines = [torch.zeros(1, 5, 384) for _ in range(3)]
    assert cp.cp_layout(coords, lines, 96) == cp.Layout(32, True)
    assert cp.cp_layout(coords, [l[..., :96].contiguous() for l in lines], 96) == cp.Layout(
        32, True)
    narrow = [torch.zeros(1, 5, 26) for _ in range(3)]
    assert cp.cp_layout(coords, narrow, 6) == cp.Layout(8, False)
    assert cp.cp_layout(coords, [torch.zeros(1, 5, 24) for _ in range(3)], 8,
                        d_app=torch.zeros(8, 16)) == cp.Layout(8, True)
    assert not cp.cp_layout(coords, [torch.zeros(1, 5, 24) for _ in range(3)], 8,
                            d_app=torch.zeros(8, 17)[:, 1:]).vector
    plan = cp.fwd_plan(1 << 20, 1500, 384, 96, 132)
    assert plan == cp.Plan(width=32, slices=12, density_slices=3, blocks_per_sm=2, parts=22,
                           per_part=47_663, smem=1500 * 64 + 128 * (2 * 48 + 3 * 16),
                           copies=1)
    assert plan.blocks == 264
    assert cp.fwd_plan(1 << 20, 1500, 96, 96, 132)[:5] == (32, 3, 3, 2, 88)
    assert cp.fwd_plan(1, 15, 26, 6, 132)[:6] == (32, 1, 1, 2, 1, 1)
    # two blocks an SM up to 1,520 rows, then one; 6 channels: one slice
    assert cp.fwd_plan(1 << 20, 1520, 384, 96, 132).blocks_per_sm == 2
    assert cp.fwd_plan(1 << 20, 2217, 384, 96, 132)[:4] == (32, 12, 3, 1)
    assert cp.fwd_plan(1000, 15, 6, 3, 132)[:3] == (32, 1, 1)
    dims = list(cp._dims(lines, 96, (1, 0, 1), cp.Layout(32, True)))
    assert dims == [5, 5, 5, 1, 0, 1, 384, 96, 5, 1]
    assert list(cp._dims(lines, 96, (1, 1, 1), cp.Layout(32, True), plan))[10:] == [
        3, 12, 47_663, 3, plan.smem, 264]


def test_cp_bwd_geometry():
    """K17b's plan at CP-384: the same 32-channel slices, one block of 32
    walkers an SM (the slice; each walker's two chunks of 8 samples' d_app,
    coords and d_dens and one chunk's rows), 11 parts a slice each adding
    into its own copy of
    the gradient (11 x 2.3 MB within WORK_BYTES, in L2); the sparsity
    loss's 10,000 points one copy; the unstaged form's geometry as PR 18's
    for the lines past the staging limit."""
    plan = cp.bwd_plan(1 << 20, 1500, 384, 96, 132)
    assert plan == cp.Plan(width=32, slices=12, density_slices=3, blocks_per_sm=1, parts=11,
                           per_part=95_326,
                           smem=1500 * 64 + 32 * (2 * 8 * (128 + 16 + 4) + 8 * 48), copies=11)
    assert plan.copies * 1500 * 384 * 4 <= cp.WORK_BYTES
    # every sample walked once: the parts cover n, the last one not empty
    assert (plan.parts - 1) * plan.per_part < 1 << 20 <= plan.parts * plan.per_part
    assert list(cp._dims([torch.zeros(1, 500, 384)] * 3, 96, (1, 1, 1), cp.Layout(32, True),
                         plan, backward=True))[10:] == [3, 12, 95_326, 11, plan.smem, 132]
    assert cp.bwd_plan(10_000, 1500, 96, 96, 132)[:6] == (32, 3, 3, 1, 44, 228)
    assert cp.bwd_plan(10_000, 1500, 96, 96, 132).copies == 1
    # a copy a 16,384 samples or part of it: 100,000 samples, 7 copies
    assert cp.bwd_plan(100_000, 1500, 96, 96, 132).copies == 7
    # n = 1: one part a slice, one copy
    assert cp.bwd_plan(1, 15, 26, 6, 132)[:6] == (32, 1, 1, 1, 1, 1)
    # past the staging limit: the unstaged walk
    assert cp.bwd_plan(1 << 20, 30_517, 26, 6, 132) is None
    assert cp.bwd_geometry(1 << 20, 384, 1500, True, 132) == cp.BwdGeometry(32, 497, 132, 14)
    assert cp.bwd_geometry(10, 26, 15, False, 132) == cp.BwdGeometry(32, 1, 1, 1)
    assert cp.bwd_geometry(5000, 6, 15, False, 132).group == 8


# (L_0, L_1, L_2, C, n_density): CP-384, its density-only form, the scalar
# widths, odd and uneven lines, lines near and past the staging limits
CP_PLAN_SHAPES = [(500, 500, 500, 384, 96), (500, 500, 500, 96, 96), (5, 5, 5, 26, 6),
                  (17, 500, 1_700, 384, 96), (17, 500, 12_000, 384, 96), (1, 1, 1, 1, 1),
                  (3, 7, 11, 7, 3), (1, 1, 30_000, 384, 1), (700, 700, 700, 97, 13),
                  (1_000, 1_000, 1_000, 26, 6), (20_000, 5_000, 2_000, 33, 17),
                  (30_000, 1, 1, 2, 1), (64, 128, 256, 130, 2)]


@pytest.mark.parametrize("shape", CP_PLAN_SHAPES)
def test_cp_plans_cover_every_channel_once(shape):
    """Each staged plan: the slices [k W, (k + 1) W) cover the C channels
    once, the first ceil(n_density / W) of them holding every density
    channel; the block's shared bytes at most 232,448 and the blocks an SM
    within the SM's 228 KB; the parts cover the samples; K17b's copies
    within WORK_BYTES (or one); n from 1 to 2^20."""
    *ls, c, nd = shape
    rows = sum(ls)
    for n in (1, 1000, 1 << 20):
        for plan in (cp.fwd_plan(n, rows, c, nd, 132), cp.bwd_plan(n, rows, c, nd, 132)):
            if plan is None:
                continue
            w = plan.width
            assert w == cp.WIDTH and plan.slices * w >= c > (plan.slices - 1) * w
            covered = [ch for k in range(plan.slices) for ch in range(k * w, min(k * w + w, c))]
            assert covered == list(range(c))
            assert plan.density_slices == len([k for k in range(plan.slices) if k * w < nd])
            assert plan.smem <= cp.SMEM_PER_BLOCK == 232_448
            assert plan.blocks_per_sm * (plan.smem + cp.SMEM_RESERVED) <= cp.SMEM_PER_SM
            assert (plan.parts - 1) * plan.per_part < n <= plan.parts * plan.per_part
            assert plan.copies == 1 or plan.copies * rows * c * 4 <= cp.WORK_BYTES
            assert plan.copies <= plan.parts


def test_cp_plans_take_every_shape():
    """Every (L_0, L_1, L_2, C, n_density) the PR 18 kernels took gets a
    launch: 1 to 30,000 rows, C from 1 to 384, odd widths.  A staged plan
    where a 32-channel slice fits (3,344 rows in all for K17, 2,256 for
    K17b), else the unstaged form, and no shape past that limit gets a
    staged plan."""
    rng = np.random.default_rng(20)
    shapes = [tuple(int(x) for x in rng.integers(1, 1_201, 3)) for _ in range(100)] + [
        tuple(int(x) for x in rng.integers(1, 10_001, 3)) for _ in range(50)] + [
        (1, 1, 1), (10_000, 10_000, 10_000), (1, 1, 3_342), (1, 1, 3_343), (1, 1, 2_254),
        (1, 1, 2_255)]
    for ls in shapes:
        rows = sum(ls)
        for c in (1, 3, 4, 26, 97, 384):
            nd = int(rng.integers(1, c + 1))
            fwd, bwd = cp.fwd_plan(4096, rows, c, nd, 132), cp.bwd_plan(4096, rows, c, nd, 132)
            assert (fwd is None) == (cp.fwd_smem(rows, 32) > cp.SMEM_PER_BLOCK), (ls, c)
            assert (bwd is None) == (cp.bwd_smem(rows, 32) > cp.SMEM_PER_BLOCK), (ls, c)
            if bwd is None:
                geo = cp.bwd_geometry(4096, c, rows, c % 4 == 0, 132)
                assert geo.blocks * (cp.UNSTAGED_BWD_THREADS // geo.group) * geo.run >= 4096
    assert cp.fwd_plan(1, 3_344, 384, 96, 132).blocks_per_sm == 1
    assert cp.fwd_plan(1, 3_345, 384, 96, 132) is None
    assert cp.bwd_plan(1, 2_256, 384, 96, 132).width == 32
    assert cp.bwd_plan(1, 2_257, 384, 96, 132) is None


class _Window:
    """Host model of one lane's window in K17b (``csrc/cp_lookup.cu``,
    ``window_add``): two pending rows keyed by row, the one added to less
    recently replaced on a miss; a replaced row is flushed."""

    def __init__(self):
        self.rows, self.sums, self.b_last = [-1, -1], [0.0, 0.0], False
        self.flushed = []

    def add(self, row, w, d):
        if w == 0.0:
            return
        hit = [k for k in (0, 1) if self.rows[k] == row]
        if hit:
            k = hit[0]
            self.sums[k] += w * d
        else:
            k = 0 if self.b_last else 1
            if self.rows[k] >= 0:
                self.flushed.append((self.rows[k], self.sums[k]))
            self.rows[k], self.sums[k] = row, w * d
        self.b_last = k == 1

    def close(self):
        for k in (0, 1):
            if self.rows[k] >= 0:
                self.flushed.append((self.rows[k], self.sums[k]))
        return self.flushed


def _walk_axis(coords, dout, length, mode):
    """One lane's walk on one axis over samples in order: (flushes, the
    scatter they add up to)."""
    win = _Window()
    sel = torch.zeros(coords.shape[0], dtype=torch.int64)
    (i0, w0), (i1, w1) = vm_lookup._line_rows(coords, sel, length, mode)
    for s in range(coords.shape[0]):
        win.add(int(i0[s]), float(w0[s]), float(dout[s]))
        win.add(int(i1[s]), float(w1[s]), float(dout[s]))
    flushed = win.close()
    g = np.zeros(length)
    for row, v in flushed:
        g[row] += v
    return flushed, g


@pytest.mark.parametrize("mode", [HAT, LINEAR])
def test_cp_window_model_flushes_the_scatter(mode):
    """The row-keyed window's flushes add up to cp_bwd_plain's scatter of
    one channel on one axis (float64 sums), for monotone rays, shuffled
    samples and samples outside the line; on a monotone ray each row is
    flushed once."""
    rng = np.random.default_rng(5)
    length = 40
    # four rays of 60 samples, each monotone along the axis, some outside
    rays = np.concatenate([np.sort(rng.uniform(-1.1, 1.1, 60))[:: 1 if k % 2 else -1]
                           for k in range(4)]).astype(np.float32)
    for coords in (rays, rng.permutation(rays)):
        d = torch.from_numpy(rng.normal(size=coords.shape[0]).astype(np.float32))
        c4 = torch.zeros(coords.shape[0], 4)
        c4[:, 2] = torch.from_numpy(coords)  # axis 0 samples coordinate x_2
        # lines of ones: dout_0 = d, rounded to bf16 on the hat
        dout = d.bfloat16().float() if mode == HAT else d
        flushed, g = _walk_axis(c4[:, 2], dout.double().numpy(), length, mode)
        want = cp.cp_bwd_plain(c4, [torch.ones(1, length, 1)] * 3, d,
                               torch.zeros(coords.shape[0], 0), 1, (mode,) * 3,
                               accumulate=torch.float64)[0]
        np.testing.assert_allclose(g, want.reshape(-1).numpy(), rtol=1e-6, atol=1e-6)
    ray = torch.from_numpy(np.sort(rng.uniform(-0.9, 0.9, 200)).astype(np.float32))
    flushed, _ = _walk_axis(ray, rng.normal(size=200), length, mode)
    rows = [r for r, _ in flushed]
    assert len(rows) == len(set(rows))


def test_cp_launch_counters_name_each_form_and_line_mode():
    """K17 counts a launch under (eval | train | density, hat | linear) and
    K17b under (train | density, hat | linear): "hat" only where all three
    axes take the hat; the density-only form takes float32 lines alone."""
    assert set(cp.cp_fwd.forms) == {(f, m) for f in ("eval", "train", "density")
                                    for m in ("hat", "linear")}
    assert set(cp.cp_bwd.forms) == {(f, m) for f in ("train", "density")
                                    for m in ("hat", "linear")}
    assert cp.line_mode_name((HAT, HAT, HAT)) == "hat"
    assert cp.line_mode_name((HAT, LINEAR, HAT)) == "linear"
    assert cp.line_mode_name((LINEAR,) * 3) == "linear"
    coords = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="density-only form"):
        cp.cp_fwd(coords, [torch.zeros(1, 5, 6, dtype=torch.bfloat16) for _ in range(3)], 6,
                  (HAT,) * 3)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_cp_density_sparsity_and_bake_match_jax(compute_dtype):
    """TensorCP's density alone (K17's density-only form: the hat under
    bf16, unlike VMSplit's) against JAX's ``compute_density_feature_only``
    (rel 1e-5), its sparsity density's gradient on fed points (1e-4 of the
    largest entry), and ``get_dense_alpha`` / ``update_alpha_mask`` on a
    non-cubic 9 x 11 x 13 grid (alphas abs 2e-5, volumes equal except
    where the dilation reaches a cell whose JAX alpha lies within 1e-6 of
    the threshold; the tight aabb equal on equal volumes)."""
    jm, jp, tm = _pair("TensorCP", compute_dtype)
    jp["density_lines"] = [8.0 * a for a in jp["density_lines"]]
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    params = tm.params()
    pts = _points(2000, 10)
    want = np.asarray(jm.compute_density_feature_only(jp, jnp.asarray(pts)))
    got = tm.compute_density_feature_only(params, torch.nn.functional.pad(
        torch.from_numpy(pts), (0, 1)))
    _close(got, want, 1e-5)

    def sp(p):
        return jnp.sum(jax_tensorf.feature2density(
            jm.compute_density_feature_only(p, jnp.asarray(pts)), jm.cfg))
    want_g = jax_ckpt._flatten(jax.grad(sp)(jp))
    tm.sparsity_density(params, None, 0, points=torch.from_numpy(pts)).sum().backward()
    got_g = _grads_of(params)
    for i in range(3):
        _close(got_g[f"density_lines/{i}"], want_g[f"density_lines/{i}"], 1e-4)
    gs = [9, 11, 13]
    want_alpha = np.asarray(jm.get_dense_alpha(jp, gs))
    got_alpha = tm.get_dense_alpha(params, gs).numpy()
    assert ((want_alpha > 0.05) & (want_alpha < 0.95)).mean() > 0.05
    np.testing.assert_allclose(got_alpha, want_alpha, rtol=0, atol=2e-5)
    thres = float(np.quantile(want_alpha, 0.9))
    import dataclasses
    jm.cfg = dataclasses.replace(jm.cfg, alpha_mask_thres=thres)
    tm.cfg = dataclasses.replace(tm.cfg, alpha_mask_thres=thres)
    want_aabb = jm.update_alpha_mask(jp, gs)
    got_aabb = tm.update_alpha_mask(params, gs)
    want_vol = np.asarray(jm.alpha_mask.volume)[..., 0]
    got_vol = tm.alpha_mask.volume[..., 0]
    assert got_vol.shape == want_vol.shape and 0.05 < want_vol.mean() < 0.95
    near = np.abs(want_alpha - thres) <= 1e-6 * thres
    near = np.asarray(jax_bake(jnp.asarray(near.astype(np.float32)), 0.5))[None] > 0
    assert np.all((got_vol == want_vol) | near)
    if np.array_equal(got_vol, want_vol):
        np.testing.assert_array_equal(got_aabb, want_aabb)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cp_forward_matches_jax(train):
    """TensorCP.forward against JAX's, as :func:`test_vm_forward_matches_jax`
    (with a mask of about half occupancy in the eval case): rgb abs 1e-5,
    depth abs 1e-4; in training every gradient of the MSE at rel 1e-4."""
    jm, jp, tm = _pair("TensorCP", "float32" if train else "bfloat16")
    rays = _rays(64, seed=11)
    key = jax.random.PRNGKey(12)
    rgbs = np.random.default_rng(12).uniform(size=(64, 3)).astype(np.float32)
    params = tm.params()
    if not train:
        vol = (np.random.default_rng(13).uniform(size=(16, 16, 16)) > 0.5).astype(np.float32)
        jm.alpha_mask, tm.alpha_mask = JaxMask(vol), AlphaGridMask(vol)
        want = jax.jit(lambda p, r: jm.forward(p, r, n_coarse=40))(jp, jnp.asarray(rays))
        with torch.no_grad():
            got = tm.forward(params, torch.from_numpy(rays), n_coarse=40,
                             tables=tm.lookup_tables(params))
    else:
        def loss_fn(p):
            out = jm.forward(p, jnp.asarray(rays), key=key, is_train=True, n_coarse=32)
            return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2), out
        (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
        jitter = torch.tensor(np.asarray(jax.random.uniform(key, (64, 32))))
        got = tm.forward(params, torch.from_numpy(rays), is_train=True, n_coarse=32,
                         jitter=jitter)
        torch.mean((got["rgb"] - torch.from_numpy(rgbs)) ** 2).backward()
        want_g, got_g = jax_ckpt._flatten(grads), _grads_of(params)
        assert sorted(want_g) == sorted(got_g)
        for k in sorted(want_g):
            _close(got_g[k], want_g[k], 1e-4, k)
    np.testing.assert_allclose(got["rgb"].detach().numpy(), np.asarray(want["rgb"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["depth"].detach().numpy(), np.asarray(want["depth"]),
                               rtol=0, atol=1e-4)


def test_cp_regularizers_and_upsample_match_jax():
    """CP's L1 over the density lines, TV over the lines with JAX's 1e-3,
    ``vector_comp_diffs`` and their gradients (rel 1e-5: float32 sums in
    another order), and ``upsample_params`` (the same lerps: abs 1e-6)."""
    jm, jp, tm = _pair("TensorCP", "float32")
    params = tm.params()

    def reg(p):
        return (jm.density_l1(p), jm.tv_loss_density(p), jm.tv_loss_app(p),
                jm.vector_comp_diffs(p))
    want = reg(jp)
    got = (tm.density_l1(params), tm.tv_loss_density(params), tm.tv_loss_app(params),
           tm.vector_comp_diffs(params))
    for g, w in zip(got, want):
        assert g.item() == pytest.approx(float(w), rel=1e-5)
    want_g = jax_ckpt._flatten(jax.grad(lambda p: sum(reg(p)))(jp))
    sum(got).backward()
    got_g = _grads_of(params)
    for k in want_g:
        if k.startswith(("density_lines", "app_lines")):
            _close(got_g[k], want_g[k], 1e-5, k)
    target = [31, 29, 27]
    want_up = jax_ckpt._flatten(jm.upsample_params(jp, target))
    got_up = params_to_jax(tm.upsample_params(tm.params(), target))
    for k in want_up:
        np.testing.assert_allclose(got_up[k], np.asarray(want_up[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# shrink
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["TensorVMSplit", "TensorVM", "TensorCP"])
def test_shrink_matches_jax(name):
    """``shrink`` to a tighter aabb against JAX's: the cropped tensors
    equal, the new grid size, aabb, chart and step equal; the port installs
    the crops as parameters.  CP scales the normalized range by gs - 1, not
    gs (JAX keeps the reference's quirk): on this aabb its crop is one cell
    shorter on an axis than VMSplit's rule gives."""
    jm, jp, tm = _pair(name, reso=[20, 18, 16])
    new_aabb = np.array([[-0.71, -1.02, -0.33], [0.93, 0.41, 1.24]], np.float32)
    want, want_size = jm.shrink(jp, new_aabb)
    got, got_size = tm.shrink(tm.params(), new_aabb)
    assert got_size == want_size
    want = jax_ckpt._flatten(want)
    got = params_to_jax(got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert tm.grid_size == jm.grid_size and tm.step_size == pytest.approx(jm.step_size)
    np.testing.assert_array_equal(tm.aabb, jm.aabb)
    np.testing.assert_array_equal(tm.coordinates.aabb, jm.coordinates.aabb)
    assert all(isinstance(p, torch.nn.Parameter) for p in tm.parameters())
    if name == "TensorCP":
        jc = JaxCartesian(AABB)
        lo, hi = jc.get_normalized_range(new_aabb)
        gs = np.array([20, 18, 16])
        vm_rule = (np.minimum(np.round(np.asarray(hi) * gs).astype(int) + 1, gs)
                   - np.round(np.asarray(lo) * gs).astype(int)).tolist()
        assert got_size != vm_rule


# ---------------------------------------------------------------------------
# NDC rays
# ---------------------------------------------------------------------------
def test_sample_ray_ndc_matches_jax():
    """``sample_ray_ndc`` with JAX's jitter: depths and points within an
    ulp, in_box equal but where a point an ulp off lies on the box's face;
    without jitter the depths are JAX's jitted linspace over [near, far],
    bit for bit."""
    jm, jp, tm = _pair("TensorVMSplit")
    rays = _rays(50, seed=14)
    rays[:, 3:6] *= np.random.default_rng(14).uniform(0.5, 2.0, (50, 1)).astype(np.float32)
    key = jax.random.PRNGKey(15)
    for k in (key, None):
        want = jax.jit(lambda r: jm.sample_ray_ndc(r[:, :3], r[:, 3:6], k, 33))(
            jnp.asarray(rays))
        jitter = None if k is None else torch.tensor(np.asarray(jax.random.uniform(k, (50, 33))))
        got = tm.sample_ray_ndc(torch.from_numpy(rays[:, :3]), torch.from_numpy(rays[:, 3:6]),
                                33, jitter)
        # XLA contracts z + u * step and o + d * z into FMAs (one rounding
        # where the port rounds twice): within an ulp; no jitter, bit for bit
        if k is None:
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2.4e-7, atol=1e-7)
        assert np.mean(got[2].numpy() != np.asarray(want[2])) < 1e-3
    assert torch.equal(port_tensorf.linspace(0.5, 3.5, 33),
                       torch.from_numpy(np.asarray(jax.jit(lambda: jnp.linspace(0.5, 3.5, 33))())))


@pytest.mark.parametrize("name", ["TensorVMSplit", "TensorCP"])
def test_ndc_training_forward_matches_jax(name):
    """The training forward with ``ndc_ray`` against JAX's (fed its
    jitter, rays of non-unit directions): rgb abs 1e-5, depth abs 1e-4,
    every gradient of the MSE rel 1e-4; the composite gets a zero last
    distance and distances scaled by |d|, the shader unit directions."""
    jm, jp, tm = _pair(name, "float32")
    rays = _rays(48, seed=16)
    rays[:, 3:6] *= np.random.default_rng(16).uniform(0.5, 2.0, (48, 1)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    rgbs = np.random.default_rng(17).uniform(size=(48, 3)).astype(np.float32)

    def loss_fn(p):
        out = jm.forward(p, jnp.asarray(rays), key=key, is_train=True, n_coarse=24, ndc_ray=True)
        return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2), out
    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    params = tm.params()
    rec = {}

    def composite(*args, **kw):
        rec["dists"], rec["z"] = args[1], args[2]
        return ops.PLAIN.composite(*args, **kw)

    def shader_rec(orig):
        def apply(params_, prefix, dirs, *a, **kw):
            rec["dirs"] = dirs
            return orig(params_, prefix, dirs, *a, **kw)
        return apply
    tm.ops = ops.KERNELS._replace(composite=composite)
    tm.shader.apply_params = shader_rec(tm.shader.apply_params)
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (48, 24))))
    got = tm.forward(params, torch.from_numpy(rays), is_train=True, n_coarse=24, jitter=jitter,
                     ndc_ray=True)
    torch.mean((got["rgb"] - torch.from_numpy(rgbs)) ** 2).backward()
    np.testing.assert_allclose(got["rgb"].detach().numpy(), np.asarray(want["rgb"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["depth"].detach().numpy(), np.asarray(want["depth"]),
                               rtol=0, atol=1e-4)
    want_g, got_g = jax_ckpt._flatten(grads), _grads_of(params)
    for k in sorted(want_g):
        _close(got_g[k], want_g[k], 1e-4, k)
    norm_d = np.linalg.norm(rays[:, 3:6], axis=-1)
    d = rec["dists"].numpy()
    assert np.all(d[:, -1] == 0.0)
    z = rec["z"].numpy()
    np.testing.assert_allclose(d[:, :-1], (z[:, 1:] - z[:, :-1]) * norm_d[:, None],
                               rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(rec["dirs"].numpy(), axis=-1), 1.0, atol=1e-6)


def test_eval_render_ignores_ndc_ray(tmp_path):
    """JAX's renderer never passes ``ndc_ray`` (its ``from_config`` maps
    none), so its test views march NDC-space rays with ``sample_ray``; the
    port's renderer under ``ndc_ray = 1`` renders what the forward without
    it renders, bit for bit."""
    cfg = load_config(overrides=dict(dataset_name="synthetic", model_name="TensorVMSplit",
                                     coordinates_name="xyz", ndc_ray=1, n_coarse=24,
                                     basedir=str(tmp_path)))
    jcfg = jax_load_config(overrides=dict(dataset_name="synthetic", ndc_ray=1))
    jm, jp, tm = _pair("TensorVMSplit")
    assert "ndc_ray" not in JaxRenderer.from_config(jm, jcfg, True).render_kwargs
    renderer = Renderer.from_config(tm, cfg, True)
    assert "ndc_ray" not in renderer.render_kwargs
    rays = torch.from_numpy(_rays(40, seed=18))
    params = tm.params()
    out = renderer.render_rays(params, rays)
    with torch.no_grad():
        ref = tm.forward(params, rays, n_coarse=24, exp_sampling=cfg.exp_sampling,
                         tables=tm.lookup_tables(params))
    assert torch.equal(out["rgb"], ref["rgb"])


# ---------------------------------------------------------------------------
# filtering_rays and filter_ray
# ---------------------------------------------------------------------------
def _miss_box(rays, corner):
    """Every other ray of ``rays`` moved to start beyond the box's x and y
    faces at ``corner`` and to point further out in x and y, so that its
    line never crosses the box (the slab test drops it; a line that
    crosses behind its origin is kept, in JAX as here)."""
    out = rays[::2]
    d = out[:, 3:6].copy()
    d[:, :2] = np.abs(d[:, :2]) + 0.1
    out[:, 3:6] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    out[:, :2] = corner + 1.0
    return rays


def _rays_half_outside(n, seed):
    return _miss_box(_rays(n, seed), AABB[1, 0])


@pytest.mark.parametrize("bbox_only", [True, False], ids=["bbox", "mask"])
def test_filtering_rays_matches_jax(bbox_only):
    """``filtering_rays`` on rays half of which miss the box (the slab
    test) and, with a mask and ``bbox_only`` off, on its 64 uniform samples
    a ray (K9): the kept rays, colours and depths equal JAX's, in chunks
    smaller than the batch."""
    jm, jp, tm = _pair("TensorVMSplit")
    rays = _rays_half_outside(300, 19)
    rays[1::2, :3] *= 0.2
    if not bbox_only:
        vol = np.zeros((16, 16, 16), np.float32)
        vol[2:6, 3:9, 4:12] = 1.0
        jm.alpha_mask, tm.alpha_mask = JaxMask(vol), AlphaGridMask(vol)
    rgbs = np.random.default_rng(20).uniform(size=(300, 3)).astype(np.float32)
    depths = np.random.default_rng(21).uniform(size=(300,)).astype(np.float32)
    want = jm.filtering_rays(jp, rays, rgbs, depths, n_samples=64, chunk=128,
                             bbox_only=bbox_only)
    got = tm.filtering_rays(tm.params(), rays, rgbs, depths, n_samples=64, chunk=128,
                            bbox_only=bbox_only)
    assert 0 < len(got[0]) < 300
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _filter_cfg(tmp_path, **over):
    return dict(dict(dataset_name="synthetic", model_name="TensorVMSplit",
                     coordinates_name="xyz", filter_ray=1, n_coarse=12, batch_size=64,
                     shadingMode="MLP_Fea",
                     n_iters=2, N_voxel_init=12 ** 3, N_voxel_final=12 ** 3,
                     n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
                     featureC=32, sparsity_lambda=0, basedir=str(tmp_path), expname="filt",
                     N_vis=0, i_weights=10 ** 7, render_test=False, progress_refresh_rate=1),
                **over)


def _scene_half_outside(near_far):
    scene = dict(n_train=2, n_test=1, height=8, width=16, near_far=near_far)
    train = SyntheticEgoDataset(split="train", **scene)
    # beyond the box of the trainer's own scene, which built the model
    train.all_rays = _miss_box(np.asarray(train.all_rays).copy(), 100.0)
    return train, SyntheticEgoDataset(split="test", is_stack=True, **scene)


def test_trainer_filter_ray_keeps_jax_rays(tmp_path):
    """The trainer under ``filter_ray`` with ``simple``: as JAX's, it keeps
    the training rays that touch the aabb (half here), the resident buffer
    and the sampler hold those alone, and a step runs."""
    cfg = load_config(overrides=_filter_cfg(tmp_path))
    jcfg = jax_load_config(overrides=_filter_cfg(tmp_path / "jax"))
    trainer = Trainer(cfg, device="cpu")
    jt = jax_trainer.Trainer(jcfg)
    train, test = _scene_half_outside(cfg.near_far)
    jtrain, jtest = _scene_half_outside(cfg.near_far)
    trainer.set_datasets(train, test)
    jt.set_datasets(jtrain, jtest)
    kept = jtrain.all_rays.shape[0]
    assert 0 < kept < 2 * 8 * 16
    np.testing.assert_array_equal(train.all_rays, jtrain.all_rays)
    np.testing.assert_array_equal(train.all_rgbs, jtrain.all_rgbs)
    assert trainer.sampler.buffer.shape[0] == kept == jt.sampler.total
    assert np.isfinite(float(trainer.train_step(0)))


@pytest.mark.parametrize("case", ["use_depth", "theta_importance"])
def test_filter_ray_with_depth_or_theta_fails_in_jax_and_is_refused(tmp_path, case):
    """What JAX's trainer does where the filter drops rays: under
    ``use_depth`` it filters the rays and colours and not the depths, and
    building its resident buffer raises ValueError; under
    ``theta_importance`` its sampler keeps the unfiltered frames' ids,
    which index past the kept rays (IndexError on the host gather).  The
    port refuses both at construction with a ValueError."""
    over = (dict(use_depth=True) if case == "use_depth"
            else dict(sampling_method="theta_importance"))
    jcfg = jax_load_config(overrides=_filter_cfg(tmp_path / "jax", **over))
    jt = jax_trainer.Trainer(jcfg)
    train, test = _scene_half_outside(jcfg.near_far)
    if case == "use_depth":
        with pytest.raises(ValueError):
            jt.set_datasets(train, test)
    else:
        jt.set_datasets(train, test)
        sam = jt.sampler
        assert sam.img_len * sam.w * sam.h > train.all_rays.shape[0] and not jt.device_data
        with pytest.raises(IndexError):
            for _ in range(20):
                jt._gather_batches(1)
    with pytest.raises(ValueError, match=f"filter_ray with {case}"):
        check_supported(load_config(overrides=_filter_cfg(tmp_path, **over)))


def test_check_supported_takes_the_family_options(tmp_path):
    """``ndc_ray`` and ``filter_ray`` pass for the TensoRF family; on
    EgoNeRF ``filter_ray`` is refused as JAX ignores it, and ``ndc_ray``
    with JAX's reason."""
    for name in ("TensorVMSplit", "TensorVM", "TensorCP"):
        for opt in (dict(ndc_ray=1), dict(filter_ray=1)):
            check_supported(load_config(overrides=_filter_cfg(tmp_path, model_name=name, **opt)))
    with pytest.raises(NotImplementedError, match="accepts and ignores"):
        check_supported(load_config(overrides=_filter_cfg(tmp_path, model_name="EgoNeRF")))
    with pytest.raises(NotImplementedError, match="EgoNeRF.py:504"):
        check_supported(load_config(overrides=_filter_cfg(tmp_path, model_name="EgoNeRF",
                                                          filter_ray=0, ndc_ray=1)))


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["TensorVM", "TensorCP"])
def test_checkpoints_both_ways(tmp_path, name):
    """A JAX checkpoint of the model (with a mask) loads in the port bit
    for bit, as that family; the port's checkpoint loads in JAX's
    ``load_checkpoint`` bit for bit, with JAX's ``model_meta``."""
    jm, jp, tm = _pair(name, seed=3)
    vol = np.random.default_rng(22).uniform(size=(6, 7, 8)) > 0.5
    path = os.path.join(str(tmp_path), "jax.npz")
    jax_ckpt.save_checkpoint(path, jp, global_step=4, coords_spec=jm.coordinates.to_spec(),
                             model_meta=jax_model_meta(None, jm), alpha_masks={"alpha_0": vol})
    model, params, header = load_jax_checkpoint(path, near_far=NEAR_FAR, device="cpu")
    assert type(model).__name__ == name and header["global_step"] == 4
    np.testing.assert_array_equal(model.alpha_mask.volume[0, ..., 0], vol)
    flat = jax_ckpt._flatten(jp)
    back = params_to_jax(params)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg=k)
    out = os.path.join(str(tmp_path), "port.npz")
    save_checkpoint(out, params, global_step=6, coords_spec=model.coordinates.to_spec(),
                    model_meta=model_meta(None, model), alpha_masks=mask_volumes(model))
    jflat, jheader, masks = jax_ckpt.load_checkpoint(out)
    assert jheader["model_meta"] == jax_model_meta(None, jm)
    np.testing.assert_array_equal(masks["alpha_0"], vol)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(jflat[k]), np.asarray(flat[k]), err_msg=k)
    _, header = load_checkpoint(out)
    assert header["model_meta"]["model_name"] == name


def _e2e_cfg(tmp_path, name, **over):
    """JAX's ``test_tensorf_variants_train_e2e`` config (tests/test_e2e.py:
    322-348)."""
    return dict(dict(dataset_name="synthetic", model_name=name, coordinates_name="xyz",
                     n_coarse=12, batch_size=256, n_iters=8, N_voxel_init=14 ** 3,
                     N_voxel_final=14 ** 3, n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]",
                     data_dim_color=12, shadingMode="MLP_Fea", density_shift="-8",
                     featureC=32, view_pe=2, fea_pe=2, lr_init=0.02, sparsity_lambda=0,
                     near_far="[0.05, 8.5]", basedir=str(tmp_path), expname=f"var_{name}",
                     N_vis=0, i_weights=10 ** 7, eval_chunk=256, steps_per_call=4,
                     progress_refresh_rate=1, render_test=False), **over)


@pytest.mark.parametrize("name", ["TensorVM", "TensorCP"])
def test_trainer_trains_each_model(tmp_path, name):
    """The port's trainer on JAX's end-to-end config for the model: eight
    finite MSEs that fall, as JAX's test asserts; the model is the named
    family, and a resumed run continues from its checkpoint."""
    import json

    cfg = load_config(overrides=_e2e_cfg(tmp_path, name))
    t = Trainer(cfg, device="cpu")
    assert type(t.model).__name__ == name
    t.train()
    with open(os.path.join(t.logdir, "metrics.jsonl")) as f:
        mses = [json.loads(l)["value"] for l in f if json.loads(l)["tag"] == "train/mse"]
    assert len(mses) >= 8 and np.isfinite(mses).all()
    assert mses[-1] < mses[0], f"{name}: {mses[0]} -> {mses[-1]}"
    resumed = Trainer(load_config(overrides=_e2e_cfg(tmp_path, name, n_iters=9)), device="cpu")
    assert resumed.start_step == 8 and type(resumed.model).__name__ == name


def test_cli_trains_resumes_and_evaluates_tensorcp(tmp_path, monkeypatch):
    """``python -m egonerf_torch --model_name TensorCP`` trains (on the CPU
    here: the entry points' device resolution is pointed there), resumes
    from its checkpoint, and ``--evaluation 1`` renders the test set."""
    from egonerf_torch import __main__ as cli
    from egonerf_torch.models import convert
    from egonerf_torch.train import trainer as trainer_module

    for module in (trainer_module, port_tensorf, convert):
        monkeypatch.setattr(module, "resolve_device", lambda device="cuda": torch.device("cpu"))
    argv = []
    for k, v in _e2e_cfg(tmp_path, "TensorCP", n_iters=3, n_lamb_sigma="[8]",
                         n_lamb_sh="[12]").items():
        argv += [f"--{k}", str(v)]
    cli.main(argv)
    logdir = os.path.join(str(tmp_path), "var_TensorCP")
    _, header = load_checkpoint(os.path.join(logdir, "var_TensorCP.npz"))
    assert header["model_meta"]["model_name"] == "TensorCP"
    assert header["model_meta"]["density_n_comp"] == [8] and header["global_step"] == 3
    cli.main(argv + ["--n_iters", "4"])
    _, header = load_checkpoint(os.path.join(logdir, "var_TensorCP.npz"))
    assert header["global_step"] == 4
    cli.main(argv + ["--evaluation", "1"])
    row = np.loadtxt(os.path.join(logdir, "evaluation", "mean.txt"))
    assert row.shape == (5,) and np.isfinite(row[0])


@pytest.mark.parametrize("name", ["TensorVM", "TensorCP"])
def test_optimizer_groups_take_each_family(name):
    """Adam's groups as JAX's per-leaf lrs (``train/optim.py``): the grid
    group holds TensorVM's planes and lines, TensorCP's six lines and no
    plane; the network group the basis and the shader."""
    from egonerf_torch.train.optim import Optimizer

    _, _, tm = _pair(name)
    opt = Optimizer(tm.params(), 0.02, 1e-3, 0.0)
    groups = {g["group"]: len(g["params"]) for g in opt.adam.param_groups}
    assert groups == {"grid": 12 if name == "TensorVM" else 6, "network": 7}
    assert not any("planes" in k for k in tm.params()) or name == "TensorVM"
