"""The fine field's relu mask, K3's lane-order density, K2's layout and the
host ray sampler, on the CPU against the JAX package: K1's plain version
writes the relu state of every density partial from the sums that gave the
relu; K2's plain version, fed that mask, passes half the cotangent where a
partial is exactly zero, as ``jnp.maximum``'s gradient does; K3's plain
version sums in the kernel's lane order; ``bwd_layout`` picks K2's lanes
from the shapes alone; ``SimpleSampler`` gives JAX's
ids, and ``device_sampling = False`` trains through it.  Inputs come from
numpy seeds and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.data.samplers import SimpleSampler as JaxSimpleSampler
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch import ops
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.data import samplers
from egonerf_torch.models import EgoNeRF, FieldConfig, params_from_jax, params_to_jax
from egonerf_torch.ops import vm_lookup
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
NEAR_FAR = (0.05, 8.5)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _tables(rng, c, s=2, hw=(6, 8), l=10):
    planes = [_bf16_exact(rng.normal(size=(s, *hw, c)).astype(np.float32)) for _ in range(3)]
    lines = [_bf16_exact(rng.normal(size=(s, l, c)).astype(np.float32)) for _ in range(3)]
    return planes, lines


def _coords(rng, n, s=2):
    return np.concatenate([rng.uniform(-1.1, 1.1, (n, 3)),
                           rng.integers(0, s, (n, 1))], -1).astype(np.float32)


def _zero_plane_cells(plane, coords, i, rows):
    """Zero every channel of plane ``i``'s cells under the four corners of
    the samples ``rows``: there each of those samples reads exactly 0, so
    its density partial of decomposition ``i`` is exactly 0."""
    s, h, w, c = plane.shape
    m0, m1 = MAT_MODE[i]
    ct = torch.from_numpy(coords[rows])
    flat = plane.reshape(s * h * w, c)
    for idx, _ in vm_lookup._plane_corners(ct[:, m0], ct[:, m1], ct[:, 3].to(torch.int64),
                                           h, w):
        flat[idx.numpy()] = 0.0


@pytest.mark.parametrize("hat", [False, True], ids=["f32_lines", "hat_lines"])
def test_plain_mask_is_the_state_of_its_partials(hat):
    """K1's plain version returns, per decomposition, 2 / 1 / 0 where its
    own ``.sum(-1)`` partial is > 0 / == 0 / < 0, and the density is the
    sum of the relus of those same partials; the mask adds nothing to the
    eval outputs."""
    rng = np.random.default_rng(0)
    n, c, cd = 600, 12, 4
    planes, lines = _tables(rng, c)
    coords = _coords(rng, n)
    _zero_plane_cells(planes[1], coords, 1, np.arange(40))
    bf = [torch.tensor(t).to(torch.bfloat16) for t in planes + lines]
    ct = torch.from_numpy(coords)
    dens, app, mask = vm_lookup.field_fwd_plain(ct, bf[:3], bf[3:], (cd,) * 3, (hat,) * 3,
                                                with_mask=True)
    assert mask.dtype == torch.uint8 and mask.shape == (n,)
    want_dens = torch.zeros(n)
    sel = ct[:, 3].to(torch.int64)
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        line_fn = vm_lookup.sample_line_hat if hat else vm_lookup.sample_line
        prod = (vm_lookup.sample_plane(bf[i], ct[:, m0], ct[:, m1], sel)
                * line_fn(bf[3 + i], ct[:, VEC_MODE[i]], sel))
        part = prod[:, :cd].sum(-1)
        state = (mask >> (2 * i)) & 3
        assert torch.equal(state == 2, part > 0) and torch.equal(state == 1, part == 0)
        assert torch.equal(state == 0, part < 0)
        want_dens = want_dens + torch.relu(part)
    assert torch.equal(dens, want_dens)
    # the zeroed cells give exact ties on decomposition 1, random tables none
    assert ((mask >> 2) & 3 == 1)[:40].all()
    assert not ((mask & 3) == 1).any() and not ((mask >> 4) & 3 == 1).any()
    assert mask.max() < 64
    eval_dens, eval_app = vm_lookup.field_fwd_plain(ct, bf[:3], bf[3:], (cd,) * 3, (hat,) * 3)
    assert torch.equal(eval_dens, dens) and torch.equal(eval_app, app)
    assert torch.equal(vm_lookup.relu_scale(mask, 1)[:40], torch.full((40,), 0.5))


def _model_pair(compute_dtype):
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    jm = JaxEgoNeRF(AABB, jc.resolution, jc,
                    JaxFieldConfig(**SHAPE, compute_dtype=compute_dtype), near_far=NEAR_FAR)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**SHAPE, compute_dtype=compute_dtype),
                 near_far=NEAR_FAR, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, tm


class _Recorder:
    """An ``Ops`` field_bwd that keeps its arguments (for the bf16 bound)."""

    def __init__(self):
        self.args = None

    def __call__(self, *args, **kwargs):
        self.args = args
        return vm_lookup.field_bwd_plain(*args, **kwargs)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_field_gradient_at_exact_zero_partials_matches_jax_vjp(compute_dtype):
    """The port's ``compute_field`` (K1/K2's plain versions through the
    autograd Function, then the basis) against ``jax.vjp`` of JAX's
    ``compute_field``, on a batch where decomposition 0's partial is exactly
    0 under 60 samples (their plane cells zeroed, density and appearance).
    ``jnp.maximum`` passes half the density cotangent there, so those
    samples' density channels still send w * d_dens * line / 2 into the
    plane cells they read.  Under float32 JAX takes the float32 custom VJPs:
    float32 sums in another order, rel 1e-5 of each tensor's largest entry.
    Under bfloat16 JAX scatter-adds the planes in bf16 (fastgrad): each plane
    cell is held to test_torch_grad's (hits + 1) * 2**-8 * sum|terms|, the
    hat lines to one bf16 ulp of their cotangent, 2**-7 * sum|terms| (the
    basis matmul's backward gives d_app in other last bits on each side),
    the terms from this call's own cotangents."""
    rng = np.random.default_rng(3)
    jm, jp, tm = _model_pair(compute_dtype)
    n = 800
    coords = _coords(rng, n)
    flat = {k: np.array(v) for k, v in jax_ckpt._flatten(jp).items()}
    for key in ("density_planes/0", "app_planes/0"):
        _zero_plane_cells(flat[key], coords, 0, np.arange(60))
    jp = jax_ckpt.unflatten_params(jp, flat)
    tm.load_state_dict(params_from_jax(flat, device="cpu"))
    d_dens = rng.normal(size=n).astype(np.float32)
    d_app = rng.normal(size=(n, SHAPE["app_dim"])).astype(np.float32)

    _, vjp = jax.vjp(lambda p: jm.compute_field(p, jnp.asarray(coords)), jp)
    (want,) = vjp((jnp.asarray(d_dens), jnp.asarray(d_app)))
    want = {k: np.asarray(v) for k, v in jax_ckpt._flatten(want).items()}

    rec = _Recorder()
    tm.ops = ops.PLAIN._replace(field_bwd=rec)
    params = tm.params()
    dens, app = tm.compute_field(params, torch.from_numpy(coords))
    torch.autograd.backward((dens, app), (torch.from_numpy(d_dens), torch.from_numpy(d_app)))
    c_t, planes, lines, dd_k, da_k, mask, n_density, line_hat = rec.args
    assert ((mask & 3) == 1)[:60].all()  # the ties are there
    mag_p, mag_l = vm_lookup.field_bwd_plain(c_t, planes, lines, dd_k, da_k, mask, n_density,
                                             line_hat, magnitude=True)
    grads = {k: p.grad for k, p in params.items() if p.grad is not None}
    got = params_to_jax(grads)
    # the field's tables and the basis; the shader is not on this path
    assert sorted(got) == sorted(k for k in want if not k.startswith("shader"))
    for k, g in sorted(got.items()):
        w = want[k]
        assert g.shape == w.shape, k
        if compute_dtype == "bfloat16" and ("planes" in k or "lines" in k):
            i = int(k.split("/")[1])
            cd = n_density[i]
            sl = slice(None, cd) if k.startswith("density") else slice(cd, None)
            if "planes" in k:
                hits = torch.zeros(planes[i].shape[:-1]).flatten()
                s_, h, w_, _ = planes[i].shape
                m0, m1 = MAT_MODE[i]
                for idx, wt in vm_lookup._plane_corners(c_t[:, m0], c_t[:, m1],
                                                        c_t[:, 3].to(torch.int64), h, w_):
                    hits.index_add_(0, idx, (wt != 0).float())
                hits = hits.reshape(*planes[i].shape[:-1], 1).numpy()
                bound = (hits + 1) * 2.0 ** -8 * mag_p[i][..., sl].numpy()
            else:
                bound = 2.0 ** -7 * mag_l[i][..., sl].numpy()
            assert np.all(np.abs(g - w) <= bound + 1e-5 * np.abs(w).max() + 1e-12), k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("c", [8, 16, 20, 64])
def test_density_fwd_plain_is_the_lane_order_sum(c):
    """K3's plain version sums each partial in K3's lane order
    (``_warp_order_sum``), bit for bit, at the coarse widths and at one off
    the 8-channel grid; the values span six decades, so ``.sum(-1)`` would
    give other bits somewhere."""
    rng = np.random.default_rng(c)
    n = 2000
    planes = [_bf16_exact(rng.normal(size=(2, 6, 8, c)) * 10.0 ** rng.uniform(-3, 3, (2, 6, 8, c)))
              for _ in range(3)]
    lines = [_bf16_exact(rng.normal(size=(2, 10, c)) * 10.0 ** rng.uniform(-3, 3, (2, 10, c)))
             for _ in range(3)]
    coords = torch.from_numpy(_coords(rng, n))
    bf = [torch.tensor(t.astype(np.float32)).to(torch.bfloat16) for t in planes + lines]
    got = vm_lookup.density_fwd_plain(coords, bf[:3], bf[3:])
    sel = coords[:, 3].to(torch.int64)
    want = torch.zeros(n)
    seq = torch.zeros(n)
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        prod = (vm_lookup.sample_plane(bf[i], coords[:, m0], coords[:, m1], sel)
                * vm_lookup.sample_line(bf[3 + i], coords[:, VEC_MODE[i]], sel))
        want = want + torch.relu(vm_lookup._warp_order_sum(prod))
        seq = seq + torch.relu(prod.sum(-1))
    assert torch.equal(got, want)
    if c > 8:
        assert not torch.equal(seq, want)


# (plane shapes, n_density) -> (group, vector)
BWD_LAYOUTS = {
    # production EgoNeRF: grid [150, 172, 516] on two charts, n_lamb 16/48
    "production": (([(2, 172, 150, 64), (2, 516, 150, 64), (2, 516, 172, 64)], (16, 16, 16)),
                   (16, True)),
    # TensoRF at 256^3 and at the tensorf preset's first grid, 128^3
    "tensorf_256": (([(1, 256, 256, 64)] * 3, (16, 16, 16)), (16, True)),
    "tensorf_128": (([(1, 128, 128, 64)] * 3, (16, 16, 16)), (16, True)),
    # the smoke config's fine and coarse widths
    "smoke_fine": (([(2, 40, 40, 24)] * 3, (8, 8, 8)), (8, True)),
    "smoke_coarse_widths": (([(2, 40, 40, 8)] * 3, (4, 4, 4)), (2, True)),
    # C = 20 is on the 4-channel grid; with n_density 5 it is not: one
    # channel a lane, 32 lanes a sample
    "c20": (([(2, 40, 40, 20)] * 3, (4, 4, 4)), (8, True)),
    "c20_cd5": (([(2, 40, 40, 20)] * 3, (5, 5, 5)), (32, False)),
    # the widest row sets the lanes: 96 channels take 32 lanes (8 of 4 would
    # not cover them)
    "widest_row": (([(2, 8, 8, 32), (2, 8, 8, 96), (2, 8, 8, 16)], (16,) * 3), (32, True)),
}


@pytest.mark.parametrize("case", sorted(BWD_LAYOUTS))
def test_bwd_layout_choices(case):
    (p_shapes, n_density), want = BWD_LAYOUTS[case]
    assert tuple(vm_lookup.bwd_layout(p_shapes, n_density)) == want
    # off 16-byte alignment the same shapes take the scalar instantiation,
    # one channel a lane
    scalar = vm_lookup.bwd_layout(p_shapes, n_density, aligned=False)
    assert not scalar.vector
    assert scalar.group == min(32, 1 << (max(p[-1] for p in p_shapes) - 1).bit_length())


def test_bwd_dims_carry_the_layout():
    """K2's two entries of the kernels' int array: log2 of the lanes a
    sample, the vector flag."""
    planes = [torch.zeros(2, 5, 6, 64, dtype=torch.bfloat16) for _ in range(3)]
    lines = [torch.zeros(2, l, 64, dtype=torch.bfloat16) for l in (500, 7, 9)]
    coords = torch.zeros(16, 4)
    layout = vm_lookup._bwd_layout_of(coords, planes, lines, (16,) * 3, torch.zeros(16, 144))
    dims = list(vm_lookup._dims(coords, planes, lines, (16,) * 3, (True,) * 3, layout))
    assert len(dims) == 23 and dims[21:] == [4, 1]
    # a d_app view off 16 bytes takes the scalar instantiation
    d_app = torch.zeros(16 * 144 + 1)[1:].view(16, 144)
    layout = vm_lookup._bwd_layout_of(coords, planes, lines, (16,) * 3, d_app)
    assert not layout.vector and layout.group == 32


@pytest.mark.parametrize("total, batch", [(1000, 64), (4096, 4096), (5000, 999)])
def test_simple_sampler_matches_jax_across_epochs(total, batch):
    """The port's copy of ``SimpleSampler`` draws JAX's ids for the same
    seed, through several permutation wraps; both are numpy."""
    mine = samplers.SimpleSampler(total, batch, seed=7)
    theirs = JaxSimpleSampler(total, batch, seed=7)
    wraps = 0
    for _ in range(3 * total // batch + 3):
        a, b = mine.nextids(), theirs.nextids()
        wraps += mine.curr == 0
        assert np.array_equal(a, b) and len(a) == batch
    assert wraps >= 3


def test_host_sampling_follows_jax_rule():
    assert samplers.host_sampling(1000, False)
    assert not samplers.host_sampling(1000, True)
    limit = samplers.DEVICE_BUFFER_LIMIT // (32 * 4)
    assert not samplers.host_sampling(limit - 1, True)
    assert samplers.host_sampling(limit, True)


def test_device_sampling_false_trains_through_the_host_sampler(tmp_path):
    """Under ``device_sampling = False`` the trainer draws JAX's
    ``SimpleSampler`` ids (seed ``cfg.seed``) from the resident buffer, and
    trains; with it on, the device sampler."""
    base = dict(dataset_name="synthetic", model_name="EgoNeRF", coordinates_name="yinyang",
                exp_sampling=True, interval_th=True, r0="0.05", resampling=True,
                use_coarse_sample=True, n_coarse=16, n_fine=16, batch_size=256, n_iters=4,
                N_voxel_init=24 ** 3, N_voxel_final=24 ** 3, n_lamb_sigma="[4,4,4]",
                n_lamb_sh="[8,8,8]", data_dim_color=12, shadingMode="MLP_Fea",
                fea2denseAct="softplus", density_shift="-8", featureC=32, view_pe=2,
                fea_pe=2, lr_init=0.02, sparsity_lambda=0, near_far="[0.05, 8.5]",
                progress_refresh_rate=2, basedir=str(tmp_path), expname="host", N_vis=0,
                i_weights=10 ** 7, eval_chunk=512, seed=3)
    trainer = Trainer(load_config(overrides=dict(base, device_sampling=False)), device="cpu")
    assert isinstance(trainer.sampler, samplers.HostRaySampler)
    ref = JaxSimpleSampler(trainer.sampler.buffer.shape[0], 256, seed=3)
    buf = trainer.sampler.buffer.clone()
    for _ in range(3):
        assert torch.equal(trainer.sampler.next_batch(), buf[torch.from_numpy(ref.nextids())])
    before = {k: p.detach().clone() for k, p in trainer.params.items()}
    mse = float(trainer.train_step(1))
    assert np.isfinite(mse)
    assert any(not torch.equal(before[k], p) for k, p in trainer.params.items())
    on = Trainer(load_config(overrides=dict(base, expname="device")), device="cpu")
    assert isinstance(on.sampler, samplers.DeviceRaySampler)
