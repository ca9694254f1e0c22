"""The empty-space cull of the port (``ops/cull.py``, K12 and K13, K4's
weights instantiation and the fused coarse pass K4c, ``pdf.resample_score``)
against the JAX package, on the CPU, at the ``tests/test_cull.py`` model
(N_voxel 32^3, featureC 32): the scores and the compaction bit for bit,
the coarse pass against JAX's raw2alpha -> sample_pdf -> merge ->
coarse_importance chain, the perturbations on JAX's own uniforms, the
culled forward, step and trainer, the oracle scorer, and the selection
rules the kernels implement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.egonerf import feature2density as jax_feature2density
from egonerf_tpu.ops import cull as jcull
from egonerf_tpu.ops import merge as jmerge
from egonerf_tpu.ops import pdf as jpdf
from egonerf_tpu.ops import volrend as jvol
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.render.renderer import Renderer as JaxRenderer
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch import ops
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.data.datasets import SyntheticEgoDataset
from egonerf_torch.models import EgoNeRF, FieldConfig, params_from_jax, params_to_jax
from egonerf_torch.models.egonerf import _dists
from egonerf_torch.ops import cull, pdf
from egonerf_torch.render.renderer import Renderer
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer, check_supported
from test_torch_train import _tiny_cfg

AABB = np.array([[-4.0] * 3, [4.0] * 3], np.float32)
NEAR_FAR = (0.05, 4.0)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32)
RENDER = dict(n_coarse=16, n_fine=16)
S = 32  # merged samples a ray
N_RAYS = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(compute_dtype="bfloat16"):
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=32 ** 3, r0=0.05, interval_th=True)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=32 ** 3, r0=0.05, interval_th=True)
    jm = JaxEgoNeRF(AABB, jc.resolution, jc,
                    JaxFieldConfig(**SHAPE, compute_dtype=compute_dtype), near_far=NEAR_FAR)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**SHAPE, compute_dtype=compute_dtype),
                 near_far=NEAR_FAR, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _rays(n=N_RAYS, seed=3):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    return np.concatenate([o, d], -1)


# ----------------------------------------------------------------------
# K12 and K13's plain versions against JAX, bit for bit
# ----------------------------------------------------------------------
def _score_case(name, seed=0, n=24, s=40, c=20):
    """(z_vals, coarse_z, coarse_weight): sorted depths, weights with many
    exact ties (a few levels) and zeros; the cases add samples below the
    first coarse depth, repeated coarse depths (the merged depths hold
    them, as with use_coarse_sample) and a spike."""
    rng = np.random.default_rng(seed)
    cz = np.sort(rng.uniform(0.5, 8.0, (n, c)).astype(np.float32), -1)
    w = (rng.integers(0, 4, (n, c)) * 0.125).astype(np.float32)
    if name == "repeated coarse depths":
        cz = np.repeat(cz[:, ::2], 2, axis=1)[:, :c]
    if name == "one spike":
        w = np.zeros_like(w)
        w[np.arange(n), rng.integers(0, c, n)] = 0.75
    z = np.sort(np.concatenate(
        [cz, rng.uniform(0.0, 9.0, (n, s - c)).astype(np.float32)], -1), -1)
    if name == "below coarse_z[0]":
        z[:, :3] = cz[:, :1] - np.float32([3.0, 2.0, 1.0])
    return z, cz, w


SCORE_CASES = ["ties", "repeated coarse depths", "below coarse_z[0]", "one spike"]


@pytest.mark.parametrize("name", SCORE_CASES)
def test_coarse_importance_plain_matches_jax(name):
    """K12's plain version against JAX's coarse_importance: bit for bit
    (the same compares, and a sum over C of one surviving term)."""
    z, cz, w = _score_case(name)
    want = np.asarray(jcull.coarse_importance(jnp.asarray(z), jnp.asarray(cz), jnp.asarray(w)))
    got = cull.coarse_importance_plain(_t(z), _t(cz), _t(w)).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "below coarse_z[0]":
        assert (got[:, :3] == 0).all()


@pytest.mark.parametrize("name", SCORE_CASES)
def test_coarse_importance_is_one_interval_lookup(name):
    """K12's rule: with sorted coarse depths (repeated ones too, whose empty
    intervals [z, z) hold nothing) at most one interval holds a sample,
    c = #(coarse_z <= z) - 1, so one search gives JAX's sum exactly."""
    z, cz, w = _score_case(name, seed=1)
    lower, upper = cz[:, None, :], np.concatenate([cz[:, 1:], np.full_like(cz[:, :1], np.inf)],
                                                  -1)[:, None, :]
    holders = ((z[..., None] >= lower) & (z[..., None] < upper)).sum(-1)
    assert holders.max() <= 1
    c = np.stack([np.searchsorted(cz[i], z[i], side="right") for i in range(z.shape[0])]) - 1
    wd = cull.dilate(_t(w)).numpy()
    want = np.where(c >= 0, np.take_along_axis(wd, np.maximum(c, 0), -1), 0.0)
    np.testing.assert_array_equal(cull.coarse_importance_plain(_t(z), _t(cz), _t(w)).numpy(),
                                  want)


def _top_k_case(name, seed=0, n=32, s=48):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.1, 9.0, (n, s)).astype(np.float32), -1)
    d = np.asarray(_dists(_t(z)))
    if name == "random":
        score = rng.uniform(size=(n, s)).astype(np.float32)
    elif name == "equal runs and zeros":
        # piecewise constant along the ray, empty space exactly 0
        levels = (rng.integers(0, 3, (n, s // 8)) * 0.25).astype(np.float32)
        score = np.repeat(levels, 8, axis=1)
    elif name == "all zero":
        score = np.zeros((n, s), np.float32)
    else:  # one spike
        score = np.zeros((n, s), np.float32)
        score[np.arange(n), rng.integers(0, s, n)] = 0.5
    return z, d, score


TOP_K_CASES = ["random", "equal runs and zeros", "all zero", "one spike"]


@pytest.mark.parametrize("k", [1, 17, 47])
@pytest.mark.parametrize("name", TOP_K_CASES)
def test_select_top_k_plain_matches_jax(name, k):
    """K13's plain version against JAX's select_top_k (lax.top_k, ties to
    the lower index, then the one-hot HIGHEST matmul): bit for bit, with
    K = 1 and K = S - 1."""
    z, d, score = _top_k_case(name)
    wz, wd = jcull.select_top_k(jnp.asarray(z), jnp.asarray(d), jnp.asarray(score), k)
    gz, gd = cull.select_top_k_plain(_t(z), _t(d), _t(score), k)
    assert gz.shape == (z.shape[0], k)
    np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("k", [48, 60])
def test_select_top_k_keep_all_is_identity(k):
    z, d, score = _top_k_case("random")
    for fn in (cull.select_top_k_plain, cull.select_top_k):
        gz, gd = fn(_t(z), _t(d), _t(score), k)
        np.testing.assert_array_equal(gz.numpy(), z)
        np.testing.assert_array_equal(gd.numpy(), d)


def _order_key(f):
    """csrc/cull.cu's order_key: an order-preserving uint32 of a float,
    -0 taken as +0."""
    b = np.where(f == 0, np.float32(0), f).astype(np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _kernel_rule_top_k(score, k):
    """K13's selection as csrc/cull.cu takes it, one ray (one warp) at a
    time, sample 32 t + lane in lane `lane`, key 0 past S: T, the K-th
    largest key, bit by bit from the top (one-bit digits: a candidate
    stays when #(key >= candidate) >= K, a warp sum of the lanes' counts),
    stopping once exactly K keys are >= T; then the keys above T and the
    first need = K - #(key > T) keys equal to T, ranked in index order by
    the equal keys of the rows before and of the lower lanes (a ballot),
    each kept sample's slot the kept samples before it counted the same
    way.  Returns (kept mask, slots: -1 where not kept, bit steps a ray)."""
    n, s = score.shape
    rows = -(-s // 32)
    keep = np.zeros((n, 32 * rows), bool)
    slots = np.full((n, 32 * rows), -1)
    steps = np.zeros(n, int)
    for r in range(n):
        key = np.zeros(32 * rows, np.uint32)
        key[:s] = _order_key(score[r])
        t_key, ge = 0, s
        for bit in range(31, -1, -1):
            if ge == k:
                break
            cand = t_key | 1 << bit
            cnt = int((key >= cand).sum())
            if cnt >= k:
                t_key, ge = cand, cnt
            steps[r] += 1
        need = k - int((key > t_key).sum())
        # an early stop leaves T below every kept key or at some of them
        assert 0 <= need <= int((key == t_key).sum())
        eq_before = slot = 0
        for t in range(rows):
            kk = key[32 * t:32 * t + 32]
            eq = kk == t_key
            kept = (kk > t_key) | (eq & (eq_before + np.cumsum(eq) - eq < need))
            keep[r, 32 * t:32 * t + 32] = kept
            slots[r, 32 * t:32 * t + 32] = np.where(kept, slot + np.cumsum(kept) - kept, -1)
            eq_before += int(eq.sum())
            slot += int(kept.sum())
    return keep[:, :s], slots[:, :s], steps


def _rank(score):
    """rank_i = #(s_j > s_i) + #(s_j == s_i, j < i), as lax.top_k orders."""
    idx = np.arange(score.shape[1])
    return ((score[:, None, :] > score[:, :, None])
            | ((score[:, None, :] == score[:, :, None])
               & (idx[None, None, :] < idx[None, :, None]))).sum(-1)


def _signed_case(s=48, seed=5):
    rng = np.random.default_rng(seed)
    score = (rng.integers(-2, 3, (32, s)) * 0.5).astype(np.float32)
    score[rng.uniform(size=score.shape) < 0.2] = -0.0
    z = np.sort(rng.uniform(0.1, 9.0, score.shape).astype(np.float32), -1)
    return z, score


def _check_kernel_rule(z, score, k):
    keep, slots, _ = _kernel_rule_top_k(score, k)
    np.testing.assert_array_equal(keep, _rank(score) < k)
    for row_keep, row_slots in zip(keep, slots):  # slots 0..K-1 in index order
        np.testing.assert_array_equal(row_slots[row_keep], np.arange(k))
    gz, _ = cull.select_top_k_plain(_t(z), _t(z), _t(score), k)
    np.testing.assert_array_equal(gz.numpy(), z[keep].reshape(-1, k))


@pytest.mark.parametrize("k", [1, 17, 47])
@pytest.mark.parametrize("name", TOP_K_CASES + ["signed with -0"])
def test_kernel_selection_rule_equals_plain(name, k):
    """The rule K13 implements (order keys, the bitwise select of T with its
    early stop, the ties' room, ballot-order ranks and slots) keeps the
    samples of rank < K, rank = #(s_j > s_i) + #(s_j == s_i, j < i), in
    index order: the plain version's set, also on signed scores with -0
    and +0 (equal as floats, one key)."""
    if name == "signed with -0":
        z, score = _signed_case()
    else:
        z, _, score = _top_k_case(name)
    _check_kernel_rule(z, score, k)


def test_kernel_rule_stops_early_only_where_the_kth_key_is_apart():
    """The bitwise select stops before its 32nd step once exactly K keys
    are >= T: on distinct scores (random) every ray does; where the K-th
    and (K+1)-th scores tie (all zero) none can, and T is the tied key."""
    _, _, score = _top_k_case("random", n=8, s=256)
    assert (_kernel_rule_top_k(score, 192)[2] < 32).all()
    _, _, zeros = _top_k_case("all zero", n=8, s=256)
    keep, _, steps = _kernel_rule_top_k(zeros, 192)
    assert (steps == 32).all() and (keep.sum(1) == 192).all() and keep[:, :192].all()


@pytest.mark.parametrize("s,k", [(256, 192), (256, 128), (256, 255), (296, 150), (512, 384)])
@pytest.mark.parametrize("name", ["random", "equal runs and zeros", "signed with -0"])
def test_kernel_selection_rule_at_production_widths(name, s, k):
    """The same at the production chunk's 256 merged samples (8 full rows of
    32 lanes), a partial last row (296) and the most a ray takes (512),
    with the recorded keeps."""
    if name == "signed with -0":
        z, score = _signed_case(s)
    else:
        z, _, score = _top_k_case(name, n=8, s=s)
    _check_kernel_rule(z[:8], score[:8], k)


def test_train_tiebreak_matches_jax():
    """train_tiebreak on the uniform jax.random.uniform draws from the same
    key: bit for bit (a compare, a product and a sum in float32)."""
    rng = np.random.default_rng(6)
    score = (rng.uniform(size=(48, S)) * (rng.uniform(size=(48, S)) > 0.5)).astype(np.float32)
    score[:, :4] = np.float32([1.5e-4, 0.9e-4, 0.99e-4, 1.0001e-4])
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, score.shape, dtype=jnp.float32))
    want = np.asarray(jcull.train_tiebreak(jnp.asarray(score), key))
    np.testing.assert_array_equal(cull.train_tiebreak(_t(score), _t(u)).numpy(), want)


@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_gumbel_perturb_matches_jax(tau):
    """gumbel_perturb on JAX's uniform from the same key: three logs from
    two libraries, a few float32 ulps apart: abs <= 2e-6 on values of
    magnitude up to ~30 (rel ~1e-7)."""
    rng = np.random.default_rng(7)
    score = (rng.uniform(size=(48, S)) * (rng.uniform(size=(48, S)) > 0.5)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    u = np.asarray(jax.random.uniform(key, score.shape, dtype=jnp.float32))
    want = np.asarray(jcull.gumbel_perturb(jnp.asarray(score), key, tau))
    got = cull.gumbel_perturb(_t(score), _t(u), tau).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# ----------------------------------------------------------------------
# K4's weights instantiation and the CPU wrappers
# ----------------------------------------------------------------------
def _k4_inputs(seed=0, r=24, s=16, f=16):
    rng = np.random.default_rng(seed)
    cz = np.sort(rng.uniform(0.05, 4.0, (r, s)).astype(np.float32), -1)
    feat = rng.normal(4.0, 3.0, (r, s)).astype(np.float32)
    return _t(feat), _t(cz), _dists(_t(cz)), f


def test_resample_weights_match_jax_raw2alpha():
    """K4's weights (plain version, K4's order) against JAX's raw2alpha
    weights (a cumprod in another association): rel 1e-5 of the largest;
    z_vals and dists equal resample_plain's bit for bit."""
    feat, cz, cd, f = _k4_inputs()
    z, d, w = pdf.resample_weights_plain(feat, cz, cd, f)
    sigma = jax.nn.softplus(jnp.asarray(feat.numpy()) - 8.0)
    _, want, _ = jvol.raw2alpha(sigma, jnp.asarray(cd.numpy()) * 25.0)
    np.testing.assert_allclose(w.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    pz, pd = pdf.resample_plain(feat, cz, cd, f)
    assert torch.equal(z, pz) and torch.equal(d, pd) and w.is_contiguous()


def _launch_counts():
    return (ops.pdf.resample.launches, pdf.resample_weights.launches,
            pdf.resample_score.launches, cull.coarse_importance.launches,
            cull.select_top_k.launches)


@pytest.mark.parametrize("op", ["resample_weights", "coarse_importance", "select_top_k",
                                "resample_score"])
def test_cpu_wrappers_take_the_plain_versions(op):
    """On CPU tensors the wrappers return their plain versions' results and
    launch nothing."""
    feat, cz, cd, f = _k4_inputs(1)
    z, d, w = pdf.resample_weights_plain(feat, cz, cd, f)
    score = cull.coarse_importance_plain(z, cz, w)
    wrapper, plain, args = {
        "resample_weights": (pdf.resample_weights, pdf.resample_weights_plain, (feat, cz, cd, f)),
        "coarse_importance": (cull.coarse_importance, cull.coarse_importance_plain, (z, cz, w)),
        "select_top_k": (cull.select_top_k, cull.select_top_k_plain, (z, d, score, 20)),
        "resample_score": (pdf.resample_score, pdf.resample_score_plain, (feat, cz, cd, f)),
    }[op]
    before = _launch_counts()
    got, want = wrapper(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert before == _launch_counts()


def test_wrappers_check_their_arguments():
    z = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="at least one"):
        cull.select_top_k(z, z, z, 0)
    with pytest.raises(ValueError, match="up to"):
        big = torch.zeros(2, cull.MAX_TOP_K_SAMPLES + 1)
        cull.select_top_k(big, big, big, 3)
    with pytest.raises(ValueError, match="one weight per coarse depth"):
        cull.coarse_importance(z, torch.zeros(4, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="contiguous"):
        cull.coarse_importance(z, torch.zeros(3, 4).T, torch.zeros(4, 3))
    feat, cz, cd, _ = _k4_inputs(2, r=2, s=400)
    with pytest.raises(ValueError, match="up to 512"):
        pdf.resample_score(feat, cz, cd, 200)


# ----------------------------------------------------------------------
# K4c, the fused coarse pass: its plain version against JAX's chain, and
# the rule its kernel takes each merged sample's interval by
# ----------------------------------------------------------------------
COARSE_PASS_CASES = ["linspace", "sorted draws", "repeated coarse depths", "ray from depth 0",
                     "draws out of order", "no coarse samples merged", "45 rays"]


def _coarse_pass_case(name, seed=4, s=16, f=16):
    """(c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample, JAX
    key, JAX sorted_draws) for each case: sorted coarse depths; the JAX
    draws' uniforms given to the port as ``u`` (None: eval's linspace).
    Repeated coarse depths take sorted draws below 1: their empty
    intervals put half the bins at the pdf's floor, and eval's u = 1 at
    the cdf's end would take the denom guard on one side only."""
    r = 45 if name == "45 rays" else 24
    rng = np.random.default_rng(seed)
    # the exponential sampler's spacing from NEAR_FAR, each ray jittered
    ratio = 1.0 + (np.pi / 2.0) / s
    steps = (NEAR_FAR[1] - NEAR_FAR[0]) * (ratio - 1.0) / (ratio ** s - 1.0) * ratio ** np.arange(s)
    jitter = rng.uniform(0.0, 1.0, (r, s))
    cz = (NEAR_FAR[0] + np.cumsum(steps * jitter, -1) + np.concatenate(
        [[0.0], np.cumsum(steps * (1 - jitter[0]))[:-1]])).astype(np.float32)
    cz = np.sort(cz, -1)
    if name == "repeated coarse depths":
        cz = np.repeat(cz[:, ::2], 2, axis=1)[:, :s]
    if name == "ray from depth 0":
        cz[:, 0] = 0.0
    # moderate densities, as test_torch_resample: every interior bin keeps a
    # mass well above the pdf's 1e-5 floor, so no draw sits at the
    # reference's denom-guard jump, where another cumsum order moves it a bin
    feat = rng.normal(4.0, 0.5, (r, s)).astype(np.float32)
    key, sorted_draws, u = None, True, None
    if name in ("sorted draws", "repeated coarse depths", "draws out of order"):
        key = jax.random.PRNGKey(seed)
        sorted_draws = name == "sorted draws"
        u = _t(jmerge.sorted_uniform(key, (r, f)) if sorted_draws
               else jax.random.uniform(key, (r, f), dtype=jnp.float32))
    return (_t(feat), _t(cz), _dists(_t(cz)), f, u, name != "no coarse samples merged", key,
            sorted_draws)


def _jax_coarse_pass(feat, cz, cd, f, key, sorted_draws, use_coarse_sample):
    """The JAX forward's culled coarse pass (egonerf_tpu/models/egonerf.py:
    390-411, 445): raw2alpha's weights, sample_pdf, the merge (a sort of
    the union where the draws are not sorted), the dists, coarse_importance."""
    sigma = jax_feature2density(jnp.asarray(feat.numpy()), JaxFieldConfig())
    _, cw, _ = jvol.raw2alpha(sigma, jnp.asarray(cd.numpy()) * 25.0)
    zj = jnp.asarray(cz.numpy())
    fine = jpdf.sample_pdf(0.5 * (zj[:, 1:] + zj[:, :-1]), cw[:, 1:-1], f, key=key,
                           sorted_draws=sorted_draws)
    if not use_coarse_sample:
        z_vals = fine if sorted_draws else jnp.sort(fine, axis=-1)
    elif sorted_draws:
        z_vals = jmerge.merge_sorted(zj, fine)
    else:
        z_vals = jnp.sort(jnp.concatenate([zj, fine], axis=-1), axis=-1)
    dists = jnp.diff(z_vals, axis=-1)
    dists = jnp.concatenate([dists, dists[..., -1:]], axis=-1)
    score = jcull.coarse_importance(z_vals, zj, cw)
    return np.asarray(z_vals), np.asarray(dists), np.asarray(score), np.asarray(cw)


@pytest.mark.parametrize("name", COARSE_PASS_CASES)
def test_resample_score_plain_matches_jax_chain(name):
    """K4c's plain version (the ``Ops`` entry on CPU tensors) against JAX's
    chain.  Depths and dists: the cdf's cumsum in another association moves
    a draw by its ulps over the bin's mass (abs 1e-4, the culled forward's
    depth tolerance above); scores: the weights' association (rel 1e-5 of
    the largest, as test_resample_weights_match_jax_raw2alpha), each sample
    in the same coarse interval on both sides."""
    feat, cz, cd, f, u, merge, key, sorted_draws = _coarse_pass_case(name)
    want_z, want_d, want_s, cw = _jax_coarse_pass(feat, cz, cd, f, key, sorted_draws, merge)
    got_z, got_d, got_s = ops.KERNELS.resample_score(feat, cz, cd, f, u, merge)
    assert got_z.shape == got_d.shape == got_s.shape == want_z.shape
    np.testing.assert_allclose(got_z.numpy(), want_z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-4)
    cz_np = cz.numpy()
    interval = lambda z: np.stack([np.searchsorted(c, zz, side="right")  # noqa: E731
                                   for c, zz in zip(cz_np, z)])
    np.testing.assert_array_equal(interval(got_z.numpy()), interval(want_z))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                               atol=1e-5 * float(np.abs(cw).max()))
    if name == "ray from depth 0":  # depth 0 lies in the first interval, not below it
        assert (got_z[:, 0] == 0).all()
        np.testing.assert_allclose(got_s.numpy()[:, 0], cull.dilate(_t(cw)).numpy()[:, 0],
                                   rtol=0, atol=1e-5 * float(np.abs(cw).max()))


def _kernel_rule_scores(zc, zf, wd):
    """K4c's interval rule, one ray, as csrc/resample.cu's merge path takes
    it: the union in merged order (coarse before fine on ties); a fine depth
    output with i coarse depths before it has c = i - 1 (score 0 at i = 0),
    a coarse depth zc[i] the last index of the coarse depths equal to it."""
    i = j = 0
    z, score = [], []
    while i < len(zc) or j < len(zf):
        if j >= len(zf) or (i < len(zc) and zc[i] <= zf[j]):
            c = i
            while c + 1 < len(zc) and zc[c + 1] <= zc[i]:
                c += 1
            z.append(zc[i])
            score.append(wd[c])
            i += 1
        else:
            z.append(zf[j])
            score.append(wd[i - 1] if i > 0 else np.float32(0))
            j += 1
    return np.float32(z), np.float32(score)


@pytest.mark.parametrize("name", ["random", "repeated coarse depths", "fine on coarse depths",
                                  "fine outside the coarse range"])
def test_kernel_interval_rule_equals_search(name):
    """The merge path's counts give K12's interval c = #(coarse_z <= z) - 1
    for every merged sample: the kernel's rule equals the plain score (a
    search, bit for bit) on sorted depths with repeats, ties and depths
    below and above the coarse ones."""
    rng = np.random.default_rng(8)
    for _ in range(16):
        zc = np.sort(rng.uniform(1.0, 4.0, 24).astype(np.float32))
        zf = np.sort(rng.uniform(1.0, 4.0, 20).astype(np.float32))
        if name == "repeated coarse depths":
            zc = np.sort(np.repeat(zc[::3], 3)[:24])
        if name == "fine on coarse depths":
            zc = np.sort(np.repeat(zc[::2], 2)[:24])
            zf = np.sort(np.concatenate([zc[rng.integers(0, 24, 12)], zf[:8]]))
        if name == "fine outside the coarse range":
            zf = np.sort(np.concatenate([zf[:14], np.float32([0.1, 0.5, 0.9, 4.5, 5.0, 9.0])]))
        w = (rng.integers(0, 4, 24) * 0.125).astype(np.float32)
        wd = cull.dilate(_t(w)).numpy()
        z, score = _kernel_rule_scores(zc, zf, wd)
        np.testing.assert_array_equal(z, np.sort(np.concatenate([zc, zf])))
        want = cull.coarse_importance_plain(_t(z)[None], _t(zc)[None], _t(w)[None])[0].numpy()
        np.testing.assert_array_equal(score, want)


# ----------------------------------------------------------------------
# the culled forward, step and trainer
# ----------------------------------------------------------------------
def _jax_eval(jm, jp, rays, **kw):
    return jax.jit(lambda p, r: jm.forward(p, r, key=None, is_train=False, **RENDER, **kw))(
        jp, jnp.asarray(rays))


@pytest.mark.parametrize("keep", [8, 20])
@pytest.mark.parametrize("score", ["coarse", "oracle"])
def test_forward_eval_keep_matches_jax(pair, keep, score):
    """eval_keep = K (and the ORACLE scorer) against JAX: float32 sums in
    another order through the cdf, the weights, the field and the
    composite; the same samples kept (rgb 1e-5, depth 1e-4, as the
    unculled forward in test_torch_model)."""
    jm, jp, tm = pair
    rays = _rays()
    want = _jax_eval(jm, jp, rays, eval_keep=keep, eval_keep_score=score)
    with torch.no_grad():
        got = tm.forward(tm.params(), torch.from_numpy(rays), **RENDER, eval_keep=keep,
                         eval_keep_score=score)
    assert np.asarray(want["alpha"]).shape[-1] == keep
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("keep", [S, S + 8])
def test_keep_of_s_or_more_is_the_unculled_forward(pair, keep):
    """keep >= S merged samples is the unculled forward, bit for bit, at
    eval and in training; eval_keep is ignored in training."""
    _, _, tm = pair
    rays = torch.from_numpy(_rays(32, seed=5))
    with torch.no_grad():
        a = tm.forward(tm.params(), rays, **RENDER)
        b = tm.forward(tm.params(), rays, **RENDER, eval_keep=keep)
        draws = dict(jitter=torch.rand(32, 16, generator=torch.Generator().manual_seed(1)),
                     u=ops.sorted_uniform(32, 16, 0, 0, "cpu"))
        c = tm.forward(tm.params(), rays, **RENDER, is_train=True, **draws)
        d = tm.forward(tm.params(), rays, **RENDER, is_train=True, train_keep=keep, **draws)
        e = tm.forward(tm.params(), rays, **RENDER, is_train=True, eval_keep=8, **draws)
    for k in ("rgb", "depth", "acc"):
        assert torch.equal(a[k], b[k]) and torch.equal(c[k], d[k]) and torch.equal(c[k], e[k])


def _pair_score(*args):
    """The culled forward's coarse pass as two ops, K4's weights and then
    K12 on its depths (what K4c replaces)."""
    z_vals, dists, weights = pdf.resample_weights(*args)
    return z_vals, dists, cull.coarse_importance(z_vals, args[1], weights)


@pytest.mark.parametrize("mode", ["eval_keep", "train_keep"])
def test_forward_through_resample_score_equals_the_pair(pair, mode):
    """EgoNeRF.forward under the cull gives the same output through K4c's
    op as through K4's weights followed by K12, bit for bit, at eval and in
    a training step with the cull's uniforms."""
    _, _, tm = pair
    rays = torch.from_numpy(_rays(40, seed=10))
    gen = torch.Generator().manual_seed(2)
    kw = (dict(eval_keep=12) if mode == "eval_keep" else
          dict(is_train=True, train_keep=12, jitter=torch.rand(40, 16, generator=gen),
               u=ops.sorted_uniform(40, 16, 0, 0, "cpu"), cull_u=torch.rand(40, S, generator=gen)))
    outs = []
    for o in (ops.KERNELS, ops.KERNELS._replace(resample_score=_pair_score)):
        tm.ops = o
        try:
            with torch.no_grad():
                outs.append(tm.forward(tm.params(), rays, **RENDER, **kw))
        finally:
            tm.ops = ops.KERNELS
    for k in ("rgb", "depth", "acc"):
        assert torch.equal(outs[0][k], outs[1][k])


def test_culled_forward_kernels_and_plain_agree_on_cpu(pair):
    _, _, tm = pair
    rays = torch.from_numpy(_rays(32, seed=6))
    outs = []
    for o in (ops.KERNELS, ops.PLAIN):
        tm.ops = o
        try:
            with torch.no_grad():
                outs.append(tm.forward(tm.params(), rays, **RENDER, eval_keep=12))
        finally:
            tm.ops = ops.KERNELS
    for k in ("rgb", "depth", "acc"):
        assert torch.equal(outs[0][k], outs[1][k])


def test_renderer_passes_eval_keep_through(pair):
    jm, jp, tm = pair
    rays = _rays(70, seed=8)
    want = JaxRenderer(jm, chunk=32, **RENDER, eval_keep=16).render_rays(jp, rays)
    got = Renderer(tm, chunk=32, **RENDER, eval_keep=16).render_rays(tm.params(), rays)
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"], rtol=0, atol=1e-4)


def _step_draws(key, n_merged):
    """JAX's draws of a culled training step with ``key``: the jitter and
    K5's uniforms from split(key), the cull's uniform from fold_in(key, 2)."""
    k_coarse, k_pdf = jax.random.split(key)
    return dict(jitter=_t(jax.random.uniform(k_coarse, (N_RAYS, RENDER["n_coarse"]))),
                u=_t(jax_sorted_uniform(k_pdf, (N_RAYS, RENDER["n_fine"]))),
                cull_u=_t(jax.random.uniform(jax.random.fold_in(key, 2), (N_RAYS, n_merged))))


@pytest.mark.parametrize("draws", ["no key", "tie-break", "gumbel"])
def test_culled_step_matches_jax(draws):
    """One training step at train_keep = 20 against jax.value_and_grad:
    with key=None (no jitter, no perturbation), and with JAX's draws fed to
    the port (jitter, u, cull_u) under the tie-break and under Gumbel
    scores (tau 1).  float32 compute: the loss to rel 1e-5, each gradient
    to rel 1e-4 of its largest entry (float32 sums in another order, as
    test_torch_train)."""
    jm, jp, tm = _pair("float32")
    rays = _rays(N_RAYS, seed=9)
    rgbs = np.random.default_rng(9).uniform(size=(N_RAYS, 3)).astype(np.float32)
    tau = 1.0 if draws == "gumbel" else 0.0
    key = None if draws == "no key" else jax.random.PRNGKey(13)
    kw = dict(is_train=True, **RENDER, train_keep=20, train_cull_tau=tau)

    def loss_fn(p):
        out = jm.forward(p, jnp.asarray(rays), key=key, **kw)
        return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    params = tm.params()
    extra = {} if key is None else _step_draws(key, S)
    out = tm.forward(params, torch.from_numpy(rays), **kw, **extra)
    loss = torch.mean((out["rgb"] - torch.from_numpy(rgbs)) ** 2)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = params_to_jax({k: p.grad for k, p in params.items()})
    want = jax_ckpt._flatten(want_grads)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def _train(tmp_path, name, **over):
    cfg = load_config(overrides=_tiny_cfg(tmp_path, expname=name, n_iters=6, N_vis=0,
                                          vis_list="[100]", progress_refresh_rate=3,
                                          batch_size=256, seed=7, **over))
    trainer = Trainer(cfg, device="cpu")
    ds = dict(near_far=cfg.near_far, n_train=2, n_test=1, height=20, width=40)
    trainer.set_datasets(SyntheticEgoDataset(split="train", is_stack=False, **ds),
                         SyntheticEgoDataset(split="test", is_stack=True, **ds))
    trainer.train()
    return {k: p.detach().clone() for k, p in trainer.params.items()}


@pytest.mark.parametrize("cull_kw", [dict(train_keep=24), dict(train_keep=24, train_cull_tau=1.0)],
                         ids=["tie-break", "gumbel"])
def test_trainer_runs_with_train_keep(tmp_path, cull_kw):
    """The trainer drives culled steps end to end (tests/test_cull.py's
    counterpart): finite parameters that moved."""
    params = _train(tmp_path, "tk", **cull_kw)
    assert all(torch.isfinite(p).all() for p in params.values())
    plain = _train(tmp_path, "plain")
    assert any(not torch.equal(params[k], plain[k]) for k in params)


def test_train_keep_full_every_one_is_the_uncull_path(tmp_path):
    """full_every = 1 runs every step unculled: the train_keep = 0 trainer
    bit for bit (the port runs the branch eagerly, so no fusion differs)."""
    hybrid = _train(tmp_path, "fe1", train_keep=24, train_keep_full_every=1)
    plain = _train(tmp_path, "plain", train_keep=0)
    for k in plain:
        assert torch.equal(hybrid[k], plain[k]), k


def test_train_keep_full_every_period_mixes_both_branches(tmp_path):
    """full_every = 3 differs from the pure cull and from the pure full
    run: each branch runs on its steps."""
    hybrid = _train(tmp_path, "fe3", train_keep=24, train_keep_full_every=3)
    for other in (_train(tmp_path, "cull", train_keep=24), _train(tmp_path, "full")):
        assert any(not torch.equal(hybrid[k], other[k]) for k in other)


def test_check_supported_takes_the_cull_for_egonerf_only(tmp_path):
    check_supported(load_config(overrides=_tiny_cfg(
        tmp_path, train_keep=24, eval_keep=16, train_keep_full_every=4, train_cull_tau=1.0)))
    with pytest.raises(NotImplementedError, match="accepts and ignores"):
        check_supported(load_config(overrides=_tiny_cfg(
            tmp_path, model_name="TensorVMSplit", coordinates_name="xyz", train_keep=24)))


def test_tensorvmsplit_refuses_eval_keep():
    """JAX's TensorVMSplit accepts eval_keep and renders unculled; the
    port's refuses it and says so, rather than accept and ignore it."""
    from test_torch_tensorf import _pair as tensorf_pair
    from test_torch_tensorf import _rays as tensorf_rays

    _, _, tm = tensorf_pair()
    with pytest.raises(NotImplementedError, match="accepts and ignores"):
        tm.forward(tm.params(), torch.from_numpy(tensorf_rays(4)), eval_keep=8)
