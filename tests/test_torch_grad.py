"""The backward kernels' plain versions against the JAX package, on the CPU:
K2 (the fine field's backward) against ``jax.vjp`` of the lookups it
replaces, K6b (the composite's backward) against ``jax.vjp`` of raw2alpha +
composite, and K5 (sorted uniforms) against JAX's formula and the law it
must have.  Inputs come from numpy seeds and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from egonerf_tpu.ops import vm_lookup as jvm
from egonerf_tpu.ops.volrend import raw2alpha as jax_raw2alpha
from egonerf_torch.ops import merge, vm_lookup, volrend

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
N_DENSITY = (4, 4, 4)
C = 12  # 4 density + 8 appearance channels per decomposition


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_exact(a):
    """float32 values that bf16 holds exactly: the JAX forward reads the
    tables as bf16, so float32 autograd then sees the same values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def plane_hits(coords, shape, i):
    """(S, H, W, 1) count of the corner entries with a nonzero weight that
    land in each cell of plane ``i``: the number of terms its sum adds."""
    s, h, w, _ = shape
    m0, m1 = MAT_MODE[i]
    c = torch.from_numpy(coords)
    hits = torch.zeros(s * h * w)
    for idx, wt in vm_lookup._plane_corners(c[:, m0], c[:, m1], c[:, 3].to(torch.int64), h, w):
        hits.index_add_(0, idx, (wt != 0).float())
    return hits.reshape(s, h, w, 1).numpy()


def _problem(seed, n, hw=(6, 8), l=10):
    rng = np.random.default_rng(seed)
    planes = [_bf16_exact(rng.normal(size=(2, *hw, C)).astype(np.float32)) for _ in range(3)]
    lines = [_bf16_exact(rng.normal(size=(2, l, C)).astype(np.float32)) for _ in range(3)]
    xyz = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    sel = rng.integers(0, 2, (n, 1)).astype(np.float32)
    coords = np.concatenate([xyz, sel], -1)
    d_dens = rng.normal(size=n).astype(np.float32)
    d_app = rng.normal(size=(n, 3 * (C - 4))).astype(np.float32)
    return planes, lines, coords, d_dens, d_app


def _jax_field_grads(plane_fn, line_fn, planes, lines, coords, d_dens, d_app):
    """jax.vjp of EgoNeRF.compute_field's fused products (density sum of
    relus, appearance channels side by side) in the tables."""
    c = jnp.asarray(coords)
    sel = c[:, 3].astype(jnp.int32)

    def field(ps, ls):
        dens, app = 0.0, []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            pr = (plane_fn(ps[i], c[:, m0], c[:, m1], sel)
                  * line_fn(ls[i], c[:, VEC_MODE[i]], sel))
            dens = dens + jnp.maximum(jnp.sum(pr[:, :N_DENSITY[i]], axis=-1), 0.0)
            app.append(pr[:, N_DENSITY[i]:])
        return dens, jnp.concatenate(app, axis=-1)

    _, vjp = jax.vjp(field, [jnp.asarray(p) for p in planes], [jnp.asarray(l) for l in lines])
    gp, gl = vjp((jnp.asarray(d_dens), jnp.asarray(d_app)))
    return [np.asarray(g) for g in gp], [np.asarray(g) for g in gl]


def _port_grads(planes, lines, coords, d_dens, d_app, line_hat, magnitude=False):
    """K2's plain version, with the relu mask of K1's plain version."""
    bf = [torch.tensor(t).to(torch.bfloat16) for t in planes + lines]
    c = torch.from_numpy(coords)
    _, _, mask = vm_lookup.field_fwd_plain(c, bf[:3], bf[3:], N_DENSITY, line_hat, with_mask=True)
    gp, gl = vm_lookup.field_bwd_plain(c, bf[:3], bf[3:], torch.from_numpy(d_dens),
                                       torch.from_numpy(d_app), mask, N_DENSITY, line_hat,
                                       magnitude=magnitude)
    return [g.numpy() for g in gp], [g.numpy() for g in gl]


@pytest.mark.parametrize("hat", [False, True], ids=["f32_lines", "hat_lines"])
def test_field_bwd_matches_jax_vjp(hat):
    """K2's plain version against the float32 custom VJPs: _plane_bwd, and
    _line_bwd or _hat_bwd.  Both sum float32 terms, in another order:
    rel 1e-5 of each gradient's largest entry."""
    planes, lines, coords, d_dens, d_app = _problem(0, 3000)
    line_fn = jvm.sample_line_hat if hat else jvm.sample_line_packed
    want_p, want_l = _jax_field_grads(jvm.sample_plane_packed, line_fn, planes, lines, coords,
                                      d_dens, d_app)
    got_p, got_l = _port_grads(planes, lines, coords, d_dens, d_app, (hat,) * 3)
    for got, want in zip(got_p + got_l, want_p + want_l):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n, hw", [(3000, (6, 8)), (200, (40, 40))],
                         ids=["many_hits", "few_hits"])
def test_field_bwd_against_bf16_scatter(n, hw):
    """K2 accumulates the planes in float32; JAX's fastgrad backward
    (_plane_bwd_bf16) rounds each corner cotangent to bf16 and scatter-adds
    in bf16.  Recursive summation of k terms in a format of unit roundoff
    u = 2**-8 errs by at most about k * u * sum|terms| (Higham, first
    order), so per cell |port - jax| <= (hits + 1) * 2**-8 * sum|terms|.
    With few hits per cell the bound is tight."""
    planes, lines, coords, d_dens, d_app = _problem(1, n, hw=hw)
    want_p, _ = _jax_field_grads(jvm.sample_plane_packed_fastgrad, jvm.sample_line_hat,
                                 planes, lines, coords, d_dens, d_app)
    got_p, _ = _port_grads(planes, lines, coords, d_dens, d_app, (True,) * 3)
    mag_p, _ = _port_grads(planes, lines, coords, d_dens, d_app, (True,) * 3, magnitude=True)
    for i, (got, want, mag) in enumerate(zip(got_p, want_p, mag_p)):
        hits = plane_hits(coords, got.shape, i)
        bound = (hits + 1) * 2.0 ** -8 * mag + 1e-30
        assert np.all(np.abs(got - want) <= bound), i
        if n == 200:
            # the sparse case really is sparse: most touched cells see one
            # or two corner entries
            assert np.median(hits[hits > 0]) <= 2


def test_field_bwd_matches_torch_autograd():
    """K2's plain version against torch autograd through K1's plain version
    on float32 tables (the same values as the bf16 tables).  With float32
    line weights the two compute the same terms: rel 1e-6 of the largest
    entry (float32 sums in another order)."""
    planes, lines, coords, d_dens, d_app = _problem(2, 2000)
    p = [torch.from_numpy(t).requires_grad_(True) for t in planes]
    l = [torch.from_numpy(t).requires_grad_(True) for t in lines]
    dens, app = vm_lookup.field_fwd_plain(torch.from_numpy(coords), p, l, N_DENSITY,
                                          (False,) * 3)
    torch.autograd.backward((dens, app), (torch.from_numpy(d_dens), torch.from_numpy(d_app)))
    got_p, got_l = _port_grads(planes, lines, coords, d_dens, d_app, (False,) * 3)
    for got, t in zip(got_p + got_l, p + l):
        want = t.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_field_function_runs_k2_on_backward():
    """The autograd Function gives K1's outputs forward and K2's gradients
    backward, through the float32 tables it was given."""
    planes, lines, coords, d_dens, d_app = _problem(3, 500)
    p = [torch.from_numpy(t).requires_grad_(True) for t in planes]
    l = [torch.from_numpy(t).requires_grad_(True) for t in lines]
    c = torch.from_numpy(coords)
    dens, app = vm_lookup.field_train(c, p, l, N_DENSITY, (True,) * 3)
    bf = [t.detach().to(torch.bfloat16) for t in p + l]
    want_d, want_a = vm_lookup.field_fwd_plain(c, bf[:3], bf[3:], N_DENSITY, (True,) * 3)
    assert torch.equal(dens, want_d) and torch.equal(app, want_a)
    torch.autograd.backward((dens, app), (torch.from_numpy(d_dens), torch.from_numpy(d_app)))
    got_p, got_l = _port_grads(planes, lines, coords, d_dens, d_app, (True,) * 3)
    for t, want in zip(p + l, got_p + got_l):
        assert torch.equal(t.grad, torch.from_numpy(want))


def _composite_problem(seed, r=48, s=40):
    rng = np.random.default_rng(seed)
    # densities from nearly empty to fully opaque (alpha rounds to 1)
    feat = rng.normal(6.0, 5.0, (r, s)).astype(np.float32)
    dists = rng.uniform(0.0, 0.08, (r, s)).astype(np.float32)
    # colors outside [0, 1] push some sums past the clip
    rgb = rng.uniform(-0.3, 1.3, (r, s, 3)).astype(np.float32)
    # ray 0 sums to exactly 0 (all black); ray 1 to exactly 1: an opaque
    # white first sample, and the rest weighs 1e-10 at most
    rgb[0] = 0.0
    feat[1, 0], dists[1, 0], rgb[1, 0] = 1000.0, 0.05, 1.0
    g = rng.normal(size=(r, 3)).astype(np.float32)
    return feat, dists, rgb, g


def _jax_composite_grads(feat, dists, rgb, g, act):
    def rgb_map(f, c):
        sigma = jax.nn.softplus(f - 8.0) if act == "softplus" else jnp.maximum(f, 0.0)
        _, weight, _ = jax_raw2alpha(sigma, jnp.asarray(dists) * 25.0)
        return jnp.clip(jnp.sum(weight[..., None] * c, axis=-2), 0.0, 1.0)

    out, vjp = jax.vjp(rgb_map, jnp.asarray(feat), jnp.asarray(rgb))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("act", ["softplus", "relu"])
def test_composite_bwd_matches_jax_vjp(act):
    """K6b's plain version against jax.vjp of raw2alpha + the composite +
    clip: rel 1e-5 of each gradient's largest entry (float32 sums in
    another order).  The clip gradient is JAX's, 1/2 at exactly 0 and 1."""
    feat, dists, rgb, g = _composite_problem(0)
    if act == "relu":
        feat = feat - 6.0  # a mix of signs; JAX splits relu's gradient at exactly 0
    out, (want_f, want_c) = _jax_composite_grads(feat, dists, rgb, g, act)
    assert out[0].tolist() == [0.0] * 3 and out[1].tolist() == [1.0] * 3
    assert (out == 0).any() and (out == 1).any() and ((out > 0) & (out < 1)).any()
    got_f, got_c = volrend.composite_bwd(torch.from_numpy(feat), torch.from_numpy(dists),
                                         torch.from_numpy(rgb), torch.from_numpy(g),
                                         -8.0, 25.0, act)
    for got, want in ((got_f.numpy(), want_f), (got_c.numpy(), want_c)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the half-gradient rays: d rgb = w * g / 2 on ray 1's opaque sample
    assert got_c[1, 0].tolist() == pytest.approx((0.5 * g[1]).tolist())


def test_composite_function_backward_is_k6b():
    feat, dists, rgb, g = _composite_problem(1)
    f = torch.from_numpy(feat).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    d = torch.from_numpy(dists)
    rgb_map, depth, acc, bg = volrend.composite_train(f, d, d.cumsum(-1), c,
                                                      torch.zeros(feat.shape[0]), -8.0, 25.0,
                                                      "softplus")
    assert not (depth.requires_grad or acc.requires_grad or bg.requires_grad)
    rgb_map.backward(torch.from_numpy(g))
    want_f, want_c = volrend.composite_bwd_plain(f.detach(), d, c.detach(), torch.from_numpy(g))
    assert torch.equal(f.grad, want_f) and torch.equal(c.grad, want_c)


def test_sorted_uniform_from_exp_matches_jax_formula():
    """JAX's sorted_uniform on given exponentials: c = cumsum(e);
    c[:-1] / c[-1].  The cumulative sums associate differently (XLA vs
    torch): rel 1e-6."""
    e = np.random.default_rng(0).exponential(size=(64, 129)).astype(np.float32)
    c = jnp.cumsum(jnp.asarray(e), axis=-1)
    want = np.asarray(c[..., :-1] / c[..., -1:])
    got = merge.sorted_uniform_from_exp(torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sorted_uniform_draws_have_beta_marginals():
    """The i-th of n sorted U(0, 1) draws is Beta(i, n + 1 - i); a KS test
    per marginal over 4000 rays (fixed seed, so deterministic) at p > 1e-3.
    The draws are sorted, in (0, 1), keyed by (seed, step) and no others."""
    n = 8
    u = merge.sorted_uniform(4000, n, 7, 3, "cpu").numpy()
    assert u.shape == (4000, n) and u.dtype == np.float32
    assert np.all(np.diff(u, axis=1) >= 0) and u.min() > 0 and u.max() < 1
    for i in range(1, n + 1):
        p = scipy.stats.kstest(u[:, i - 1], scipy.stats.beta(i, n + 1 - i).cdf).pvalue
        assert p > 1e-3, (i, p)
    assert np.array_equal(u, merge.sorted_uniform_plain(4000, n, 7, 3).numpy())
    for seed, step in ((7, 4), (8, 3)):
        assert not np.array_equal(u, merge.sorted_uniform_plain(4000, n, seed, step).numpy())
    # ray r's draws do not depend on how many rays are drawn
    assert np.array_equal(u[:10], merge.sorted_uniform_plain(10, n, 7, 3).numpy())


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    def run(ctr, key):
        words = merge.philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
        return [int(w) for w in words]

    assert run([0, 0, 0, 0], [0, 0]) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                                      0x6D5451FD]
    assert run([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0]) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
