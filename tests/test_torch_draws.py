"""The draws of the port's training path on the CPU: K5's sorted uniforms
drawn from a key inside K4 and K4c (``ops/pdf.py``'s ``draw``), and the
theta sampler's one-launch batch (K14f, ``ops/sampler.py::theta_batch``).

The key forms are held bit for bit to the same ops on K5's plain uniforms
for the key, and through them to JAX's composition on those uniforms (JAX's
``sorted_uniform`` handed the port's draws); the sampler's plain version to
Philox's known answers, a numpy recomputation of its mapping, and its
distribution."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.ops import merge as jmerge
from egonerf_torch import ops
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.data.samplers import DeviceThetaSampler, ThetaImportanceSampler
from egonerf_torch.models import EgoNeRF, FieldConfig
from egonerf_torch.models.egonerf import StepKey, _dists
from egonerf_torch.ops import merge, pdf, philox, sampler
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer
from test_torch_cull import NEAR_FAR, SHAPE
from test_torch_cull import AABB as CULL_AABB
from test_torch_cull import _rays as _cull_rays
from test_torch_envmap import _tiny_cfg as _envmap_cfg
from test_torch_resample import (AABB, ACT, F, R, S, _boundary_distance, _exp_depths,
                                 _jax_fused, _rays, _t)

KEYS = [(0, 1), (7, 123456), (2 ** 32 + 5, 2 ** 33 + 9)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=7, n_rays=R, n_coarse=S):
    rng = np.random.default_rng(seed)
    z = _exp_depths(n_rays, n_coarse)
    d = np.asarray(_dists(_t(z)))
    feat = rng.normal(4.0, 0.5, (n_rays, n_coarse)).astype(np.float32)
    o, dirs = _rays(rng, n_rays)
    return feat, z, d, o, dirs


def _coords(interval_th=True):
    return YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05,
                                  interval_th=interval_th)


# ----------------------------------------------------------------------
# K4 and K4c with a draw key
# ----------------------------------------------------------------------
@pytest.mark.parametrize("use_coarse_sample", [True, False])
@pytest.mark.parametrize("key", KEYS)
def test_resample_chart_with_a_key_is_the_op_on_k5s_draws(key, use_coarse_sample):
    """The training form of K4 (a key in place of u) equals the same op on
    K5's plain uniforms for the key, bit for bit: depths, dists, coords."""
    feat, z, d, o, dirs = _inputs()
    args = (_t(feat), _t(z), _t(d), F)
    rays = (_t(o), _t(dirs), _coords())
    u = merge.sorted_uniform_plain(R, F, *key)
    got = ops.KERNELS.resample_chart(*args, None, use_coarse_sample, *ACT, *rays, draw=key)
    want = ops.KERNELS.resample_chart(*args, u, use_coarse_sample, *ACT, *rays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = ops.PLAIN.resample_chart(*args, None, use_coarse_sample, *ACT, *rays, draw=key)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_fine", [1, 16, 33])
@pytest.mark.parametrize("key", KEYS[:2])
def test_resample_score_with_a_key_is_the_op_on_k5s_draws(key, n_fine):
    """K4c's training form equals the same op on K5's plain uniforms for
    the key bit for bit (depths, dists, scores), and its depths equal K4's
    training form's."""
    feat, z, d, o, dirs = _inputs(seed=11)
    args = (_t(feat), _t(z), _t(d), n_fine)
    u = merge.sorted_uniform_plain(R, n_fine, *key)
    got = ops.KERNELS.resample_score(*args, None, True, *ACT, draw=key)
    want = ops.KERNELS.resample_score(*args, u, True, *ACT)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    k4 = ops.KERNELS.resample_chart(*args, None, True, *ACT, _t(o), _t(dirs), _coords(),
                                    draw=key)
    assert torch.equal(got[0], k4[0]) and torch.equal(got[1], k4[1])


@pytest.mark.parametrize("interval_th", [True, False])
def test_resample_chart_with_a_key_matches_jax_on_its_draws(interval_th, monkeypatch):
    """The key form against JAX's composition (``sample_pdf`` with sorted
    draws, ``merge_sorted``, the chart) where JAX's ``sorted_uniform`` hands
    back the port's draws for the key: the limits of
    tests/test_torch_resample.py (depths rtol 1e-5; coords 2e-5, a chart
    flag flipping only within 1e-5 rad of a boundary)."""
    key = (3, 41)
    feat, z, d, o, dirs = _inputs(seed=5)
    u = merge.sorted_uniform_plain(R, F, *key)
    monkeypatch.setattr(jmerge, "sorted_uniform", lambda k, shape: jnp.asarray(u.numpy()))
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=interval_th)
    want_z, want_c, xyz = _jax_fused(feat, z, d, o, dirs, jc, "drawn", True)
    got_z, _, got_c = ops.KERNELS.resample_chart(_t(feat), _t(z), _t(d), F, None, True, *ACT,
                                                 _t(o), _t(dirs), _coords(interval_th),
                                                 draw=key)
    np.testing.assert_allclose(got_z.numpy(), want_z, rtol=1e-5, atol=1e-6)
    got_c = got_c.numpy()
    flip = got_c[:, 3] != want_c[:, 3]
    assert np.all(_boundary_distance(xyz[flip]) < 1e-5)
    np.testing.assert_allclose(got_c[~flip], want_c[~flip], rtol=0, atol=2e-5)


def test_two_sources_of_u_raise():
    """u and a draw key together are refused by the wrappers and by the
    plain versions; a key is two ints."""
    feat, z, d, o, dirs = _inputs()
    args = (_t(feat), _t(z), _t(d), F, merge.sorted_uniform_plain(R, F, 0, 1), True, *ACT)
    rays = (_t(o), _t(dirs), _coords())
    for call in (lambda: ops.KERNELS.resample_chart(*args, *rays, draw=(0, 1)),
                 lambda: ops.PLAIN.resample_chart(*args, *rays, draw=(0, 1)),
                 lambda: ops.KERNELS.resample_score(*args, draw=(0, 1)),
                 lambda: ops.PLAIN.resample_score(*args, draw=(0, 1))):
        with pytest.raises(ValueError, match="not both"):
            call()
    no_u = args[:4] + (None,) + args[5:]
    for bad in ((0.5, 1), (0,), (0, 1, 2)):
        with pytest.raises(TypeError, match="two ints"):
            ops.KERNELS.resample_score(*no_u, draw=bad)


def test_draw_key_counts_its_shared_memory():
    """The training instantiation keeps each warp's F + 1 draws beside K4's
    rows: a width that fits without them may not fit with them."""
    feat, z, d, o, dirs = _inputs(n_rays=2, n_coarse=3)
    args = (_t(feat), _t(z), _t(d), 5000, None, True, *ACT)
    assert pdf._check(*args[:6], ACT[2]) == (2, 5003)
    with pytest.raises(ValueError, match="cannot take"):
        pdf._check(*args[:6], ACT[2], draw=(0, 0))


def test_key_forms_launch_nothing_on_cpu():
    feat, z, d, o, dirs = _inputs()
    counters = (pdf.resample, pdf.resample_score, pdf.resample_chart.draw_form,
                pdf.resample_score.draw_form, merge.sorted_uniform)
    before = [c.launches for c in counters]
    ops.KERNELS.resample_chart(_t(feat), _t(z), _t(d), F, None, True, *ACT, _t(o), _t(dirs),
                               _coords(), draw=(0, 1))
    ops.KERNELS.resample_score(_t(feat), _t(z), _t(d), F, None, True, *ACT, draw=(0, 1))
    assert [c.launches for c in counters] == before


@pytest.fixture(scope="module")
def model():
    tc = YinYangSphericalCoords(CULL_AABB, exp_r=True, N_voxel=32 ** 3, r0=0.05,
                                interval_th=True)
    tm = EgoNeRF(CULL_AABB, tc.resolution, tc, FieldConfig(**SHAPE), near_far=NEAR_FAR,
                 device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            p.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(p.numel()))
    return tm


@pytest.mark.parametrize("cull", [{}, dict(train_keep=12), dict(train_keep=12,
                                                              train_cull_tau=1.0)])
def test_training_forward_with_a_key_is_the_one_on_k5s_draws(model, cull):
    """A training forward with a StepKey (K4, or K4c under the cull, draws
    u from the key) equals the forward handed the key's jitter, K5's plain
    uniforms and the cull's uniforms explicitly, bit for bit."""
    rays = torch.from_numpy(_cull_rays(40, seed=4))
    n_c = n_f = 16
    outs = []
    for explicit in (False, True):
        gen = torch.Generator().manual_seed(9)
        kw = dict(key=StepKey(gen, 5, 17))
        if explicit:
            kw = dict(jitter=torch.rand(40, n_c, generator=gen),
                      u=merge.sorted_uniform_plain(40, n_f, 5, 17))
            if cull:
                kw["cull_u"] = torch.rand(40, n_c + n_f, generator=gen)
        with torch.no_grad():
            outs.append(model.forward(model.params(), rays, is_train=True, n_coarse=n_c,
                                      n_fine=n_f, **cull, **kw))
    for k in ("rgb", "depth", "acc"):
        assert torch.equal(outs[0][k], outs[1][k])


# ----------------------------------------------------------------------
# K14f: the theta sampler's batch
# ----------------------------------------------------------------------
def _philox_ref(ctr, key):
    """Philox4x32-10 on Python ints: an implementation apart from the
    port's int64 tensor one."""
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
        k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return c


def test_philox_known_answers_and_the_theta_counters():
    """The shared generator against the Random123 known-answer vectors, and
    the sampler's words: draw i of batch t is the block at counter (i, i >>
    32, 0, THETA_STREAM) under key (seed, t), K5's stream word apart."""
    for ctr, key, want in (([0] * 4, [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
                           ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2,
                            [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD])):
        got = philox.philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
        assert [int(w) for w in got] == want == _philox_ref(ctr, key)
    assert merge.philox4x32_10 is philox.philox4x32_10
    assert philox.THETA_STREAM != philox.SORTED_STREAM
    words = sampler.theta_words(70, 11, 2 ** 32 + 3)
    for i in (0, 1, 69):
        assert [int(w[i]) for w in words] == _philox_ref([i, 0, 0, philox.THETA_STREAM],
                                                         [11, 3])


def _raster(full_wh=(37, 19), roi=(0.13, 0.77, 0.21, 0.9), n_img=3, lam=4.0, seed=0):
    """A theta sampler's raster, its float32 cdf and a buffer whose rows
    carry their own index."""
    w = int(roi[3] * full_wh[0]) - int(roi[2] * full_wh[0])
    h = int(roi[1] * full_wh[1]) - int(roi[0] * full_wh[1])
    sam = ThetaImportanceSampler(lam, n_img * w * h, full_wh, 8, roi, seed=seed)
    cdf = np.cumsum(sam.weight).astype(np.float32)
    n = n_img * w * h
    buffer = np.arange(n * 9, dtype=np.float32).reshape(n, 9)
    return sam, cdf, buffer


@pytest.mark.parametrize("seed,t", [(0, 1), (5, 2), (2 ** 40 + 1, 7)])
def test_theta_batch_follows_its_mapping(seed, t):
    """K14f's plain version: img = (x img_len) >> 32, col = (y w) >> 32,
    u = (z >> 8) 2^-24, the row the lower bound of u in the cdf clamped to
    h - 1 (a numpy recomputation from the Python-int Philox), and the rows
    the buffer's at the ids."""
    sam, cdf, buffer = _raster()
    n = 300
    ids, rows = ops.PLAIN.theta_batch(torch.from_numpy(buffer), torch.from_numpy(cdf), sam.w,
                                      sam.h, n, seed, t)
    words = np.array([_philox_ref([i, 0, 0, philox.THETA_STREAM],
                                  [seed & 0xFFFFFFFF, t & 0xFFFFFFFF]) for i in range(n)],
                     dtype=np.uint64)
    img = (words[:, 0] * np.uint64(sam.img_len)) >> np.uint64(32)
    col = (words[:, 1] * np.uint64(sam.w)) >> np.uint64(32)
    u = (words[:, 2] >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    row = np.minimum(np.searchsorted(cdf, u, side="left"), sam.h - 1)
    want = img.astype(np.int64) * sam.w * sam.h + row * sam.w + col.astype(np.int64)
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(rows.numpy(), buffer[want])
    got = sampler.theta_batch(torch.from_numpy(buffer), torch.from_numpy(cdf), sam.w, sam.h, n,
                              seed, t)
    assert torch.equal(got[0], ids) and torch.equal(got[1], rows)


def test_theta_batch_on_ties_a_short_cdf_and_one_row():
    """K14's hard cdfs through the batch: runs of equal values (the first
    row of a run is taken), a cdf ending below 1 (u above it takes the
    last row), and h = 1 (every draw row 0)."""
    ties = torch.tensor([0.1, 0.1, 0.1, 0.5, 0.5, 0.9999])
    buffer = torch.arange(2 * 6 * 9, dtype=torch.float32).reshape(12, 9)
    ids, _ = ops.PLAIN.theta_batch(buffer, ties, 1, 6, 1 << 14, 0, 1)
    rows = (ids % 6).numpy()
    assert set(np.unique(rows)) == {0, 3, 5}
    one, _ = ops.PLAIN.theta_batch(buffer[:10], torch.ones(1), 5, 1, 1000, 0, 1)
    assert int(one.max()) < 10 and set(np.unique(one.numpy() // 5)) == {0, 1}


def test_theta_batch_distribution():
    """2^20 draws: every row's count within 6 binomial deviations of
    draws x weight[row] (u above the float32 cdf's end takes the last row),
    every image's and column's of the uniform count."""
    sam, cdf, buffer = _raster(full_wh=(64, 40), roi=(0.05, 0.95, 0.0, 1.0), n_img=5)
    n = 1 << 20
    ids, _ = ops.PLAIN.theta_batch(torch.from_numpy(buffer), torch.from_numpy(cdf), sam.w,
                                   sam.h, n, 3, 1)
    ids = ids.numpy()
    weight = np.diff(np.concatenate([[0.0], cdf.astype(np.float64)]))
    weight[-1] += 1.0 - float(cdf[-1])
    plane = sam.w * sam.h
    for idx, p in (((ids % plane) // sam.w, weight),
                   (ids // plane, np.full(sam.img_len, 1.0 / sam.img_len)),
                   (ids % sam.w, np.full(sam.w, 1.0 / sam.w))):
        count = np.bincount(idx, minlength=p.shape[0])
        assert count.shape == p.shape
        z = np.abs(count - n * p) / np.sqrt(n * p * (1 - p))
        assert z.max() < 6.0, z.max()


def test_theta_batch_repeats_its_key_and_moves_with_t():
    sam, cdf, buffer = _raster()
    args = (torch.from_numpy(buffer), torch.from_numpy(cdf), sam.w, sam.h, 512)
    a, b = ops.PLAIN.theta_batch(*args, 0, 1), ops.PLAIN.theta_batch(*args, 0, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for other in (ops.PLAIN.theta_batch(*args, 0, 2), ops.PLAIN.theta_batch(*args, 1, 1)):
        assert float((other[0] == a[0]).float().mean()) < 0.1


@pytest.mark.parametrize("case", ["buffer width", "cdf rows", "partial image", "negative n",
                                  "cdf dtype"])
def test_theta_batch_rejects_bad_arguments(case):
    sam, cdf, buffer = _raster()
    b, c = torch.from_numpy(buffer), torch.from_numpy(cdf)
    bad = {"buffer width": ((b[:, :6].contiguous(), c, sam.w, sam.h, 8), ValueError),
           "cdf rows": ((b, c[:-1], sam.w, sam.h, 8), ValueError),
           "partial image": ((b[:-1], c, sam.w, sam.h, 8), ValueError),
           "negative n": ((b, c, sam.w, sam.h, -1), ValueError),
           "cdf dtype": ((b, c.double(), sam.w, sam.h, 8), TypeError)}
    args, error = bad[case]
    with pytest.raises(error):
        sampler.theta_batch(*args, 0, 1)


def test_theta_batch_registry_and_no_launch_on_cpu():
    assert ops.KERNELS.theta_batch is sampler.theta_batch
    assert ops.PLAIN.theta_batch is sampler.theta_batch_plain
    sam, cdf, buffer = _raster()
    before = (sampler.theta_batch.launches, sampler.theta_ids.launches)
    sampler.theta_batch(torch.from_numpy(buffer), torch.from_numpy(cdf), sam.w, sam.h, 64, 0, 1)
    assert (sampler.theta_batch.launches, sampler.theta_ids.launches) == before


def test_trainer_steps_advance_the_theta_batch(tmp_path):
    """The device theta sampler counts its own batches: an envmap pretrain
    step and a training step each take the next one, and a batch is the
    one that (seed, t) draws."""
    cfg = _envmap_cfg(tmp_path, sampling_method="theta_importance", theta_importance_lambda=4.0,
                      iter_pretrain_envmap=0, batch_size=64)
    trainer = Trainer(load_config(overrides=cfg), device="cpu")
    s = trainer.sampler
    assert isinstance(s, DeviceThetaSampler) and s.t == 0 and s.seed == trainer.cfg.seed
    seen = []
    orig = s.draw

    def record(t):
        out = orig(t)
        seen.append((t, out[1]))
        return out
    s.draw = record
    trainer.pretrain_step()
    trainer.train_step(1)
    trainer.train_step(2)
    assert [t for t, _ in seen] == [1, 2, 3] and s.t == 3
    for t, rows in seen:
        assert torch.equal(rows, ops.PLAIN.theta_batch(s.buffer, s.cdf, s.w, s.h, 64, s.seed,
                                                       t)[1])
    assert not torch.equal(seen[0][1], seen[1][1])
