"""The shader forms of the port against the JAX package, on the CPU: the
switches (``EGONERF_MIXED_MM``, ``EGONERF_BIAS_DOT``, ``EGONERF_SPLIT_L1``,
``EGONERF_HOIST_DIRS``, ``EGONERF_LINE_HAT``) and their defaults; K10's
plain versions (``mixed_matmul``: the forward and both gradients) against
``jax.vjp`` of JAX's ``mixed_matmul``; the bias-dot Function (K11's plain
version) against ``_bias_add``; ``MLPFea`` under each form against
``make_shader``; EgoNeRF's eval forward and one training step under
``EGONERF_MIXED_MM=1``, the combined forms' forward, and TensoRF's forward
under the hoist.  The JAX switch and the port's are flipped together with
``monkeypatch``.  Inputs come from numpy seeds and go to both sides."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.models import egonerf as jeg
from egonerf_tpu.models import shading as jsh
from egonerf_tpu.models import tensorf as jtf
from egonerf_tpu.ops import mm as jmm
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch import ops
from egonerf_torch.models import egonerf as teg
from egonerf_torch.models import params_to_jax
from egonerf_torch.models import shading as tsh
from egonerf_torch.models import tensorf as ttf
from egonerf_torch.ops import bias, mm, vm_lookup
from test_torch_tensorf import _pair as _tf_pair
from test_torch_tensorf import _rays as _tf_rays
from test_torch_train import N_RAYS, RENDER, _batch, plane_hits
from test_torch_train import _pair as _ego_pair
from test_torch_train import _Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U32 = 2.0 ** -24  # float32 unit roundoff

# where each switch lives on each side, as the models read it
SWITCHES = {
    "MIXED_MM": ((jeg, "_MIXED_MM"), (teg, "_MIXED_MM")),
    "BIAS_DOT": ((jsh, "_BIAS_DOT"), (tsh, "_BIAS_DOT")),
    "SPLIT_L1": ((jsh, "_SPLIT_L1"), (tsh, "_SPLIT_L1")),
    "HOIST_DIRS": ((jeg, "_HOIST_DIRS"), (jtf, "_HOIST_DIRS"), (teg, "_HOIST_DIRS"),
                   (ttf, "_HOIST_DIRS")),
    "LINE_HAT": ((jeg, "_LINE_HAT"), (jtf, "_LINE_HAT"), (teg, "_LINE_HAT"),
                 (ttf, "_LINE_HAT")),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flip(monkeypatch, **values):
    """Set switches on both sides, e.g. ``flip(mp, MIXED_MM=True)``."""
    for name, value in values.items():
        for module, attr in SWITCHES[name]:
            monkeypatch.setattr(module, attr, value)


def _bf16(x: np.ndarray) -> np.ndarray:
    """bf16 rounding (to nearest even) as float64, through torch."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16().double().numpy()


# ---------------------------------------------------------------------------
# the switches
# ---------------------------------------------------------------------------
_READ = """
import json
from egonerf_tpu.models import egonerf as je, shading as js, tensorf as jt
from egonerf_tpu.ops import vm_lookup as jv
from egonerf_torch.models import egonerf as te, shading as ts, tensorf as tt
from egonerf_torch.ops import vm_lookup as tv
side = lambda eg, sh, tf, vm: dict(
    MIXED_MM=eg._MIXED_MM, BIAS_DOT=sh._BIAS_DOT, SPLIT_L1=sh._SPLIT_L1,
    HOIST_DIRS=[eg._HOIST_DIRS, tf._HOIST_DIRS, sh._HOIST_DIRS],
    LINE_HAT=[eg._LINE_HAT, tf._LINE_HAT, vm.LINE_HAT])
print(json.dumps([side(je, js, jt, jv), side(te, ts, tt, tv)]))
"""


def test_switches_read_jax_names_and_defaults():
    """The port reads the five variables JAX reads, at import, with JAX's
    defaults: run with none of them set and with each at its other value,
    both packages see the same switches."""
    names = {f"EGONERF_{k}": v for k, v in (("MIXED_MM", "1"), ("BIAS_DOT", "1"),
                                           ("SPLIT_L1", "1"), ("HOIST_DIRS", "1"),
                                           ("LINE_HAT", "0"))}
    base = {k: v for k, v in os.environ.items() if k not in names}
    seen = []
    for env in (base, {**base, **names}):
        out = subprocess.run([sys.executable, "-c", _READ], cwd=REPO,
                             env={**env, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO},
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        jax_side, port_side = json.loads(out.stdout.strip().splitlines()[-1])
        assert port_side == jax_side
        seen.append(port_side)
    assert seen[0] == dict(MIXED_MM=False, BIAS_DOT=False, SPLIT_L1=False,
                           HOIST_DIRS=[False] * 3, LINE_HAT=[True] * 3)
    assert seen[1] == dict(MIXED_MM=True, BIAS_DOT=True, SPLIT_L1=True,
                           HOIST_DIRS=[True] * 3, LINE_HAT=[False] * 3)


# ---------------------------------------------------------------------------
# K10 and K11's plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [128, 27, 3])
@pytest.mark.parametrize("k", [150, 144, 15])
def test_mixed_matmul_matches_jax_vjp(k, n):
    """``mixed_matmul`` on (5, 7, K) @ (K, N): the forward and both
    gradients against ``jax.vjp`` of JAX's.  Both round every operand (and
    the cotangent, in both contractions) to bf16 and sum exact float32
    products in float32, in another order: two recursive float32 sums of
    the same q terms differ by at most 2 q u sum|terms| (u = 2**-24), per
    element, with q = K, N and M = 35 for the three.  A port that left the
    cotangent unrounded in either contraction misses this by about 2**-9."""
    rng = np.random.default_rng(1000 * k + n)
    a = rng.normal(size=(5, 7, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    dout = rng.normal(size=(5, 7, n)).astype(np.float32)
    want, vjp = jax.vjp(jmm.mixed_matmul, jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(dout))

    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = mm.mixed_matmul(ta, tb, ops.PLAIN.mm, ops.PLAIN.mm_da, ops.PLAIN.mm_db)
    got.backward(torch.from_numpy(dout))

    a16, b16, d16 = (np.abs(_bf16(x)) for x in (a.reshape(-1, k), b, dout.reshape(-1, n)))
    checks = ((got.detach().numpy().reshape(-1, n), want, a16 @ b16, k),
              (ta.grad.numpy().reshape(-1, k), want_da, d16 @ b16.T, n),
              (tb.grad.numpy(), want_db, a16.T @ d16, a16.shape[0]))
    for g, w, terms, q in checks:
        w = np.asarray(w).reshape(g.shape)
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.all(np.abs(g.astype(np.float64) - w) <= 2 * q * U32 * terms + 1e-30)


@pytest.mark.parametrize("m", [17, 1025])
@pytest.mark.parametrize("n", [128, 54, 3])
@pytest.mark.parametrize("k", [150, 144, 135, 128, 15])
def test_mixed_mm_and_db_match_jax_vjp_at_odd_rows(k, n, m):
    """K10's forward and db wrappers (``mm.mixed_mm``, ``mm.mixed_mm_db``:
    their plain versions on CPU tensors) on an odd number of rows, fewer
    than one stage of db's ring and more, at the depths and widths the
    production shader and basis give them, b as a weight's transpose:
    against the primal and db of ``jax.vjp`` of JAX's ``mixed_matmul``,
    per element within 2 q u sum|terms| (q = K for the forward, M for db),
    and the forward equal to ``mixed_mm_plain`` bit for bit."""
    rng = np.random.default_rng(10_000 * k + 10 * n + m)
    a = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    dout = rng.normal(size=(m, n)).astype(np.float32)
    want, vjp = jax.vjp(jmm.mixed_matmul, jnp.asarray(a), jnp.asarray(w.T))
    _, want_db = vjp(jnp.asarray(dout))

    ta, tb = torch.from_numpy(a), torch.from_numpy(w).t()
    got = mm.mixed_mm(ta, tb)
    got_db = mm.mixed_mm_db(ta, torch.from_numpy(dout))
    assert torch.equal(got, mm.mixed_mm_plain(ta, tb))
    a16, b16, d16 = (np.abs(_bf16(x)) for x in (a, w.T, dout))
    for g, want_g, terms, q in ((got, want, a16 @ b16, k), (got_db, want_db, a16.T @ d16, m)):
        g = g.numpy()
        want_g = np.asarray(want_g)
        assert g.dtype == np.float32 and g.shape == want_g.shape
        assert np.all(np.abs(g.astype(np.float64) - want_g) <= 2 * q * U32 * terms + 1e-30)


def test_mixed_matmul_kernels_entry_takes_the_plain_versions_on_cpu():
    """On CPU tensors the ``Ops`` entries of K10 give the plain versions'
    values and launch nothing; a weight view (``W.t()``, a column slice)
    is taken at its strides."""
    counters = (mm.mixed_mm, mm.mixed_mm_da, mm.mixed_mm_db, bias.bias_grad)
    before = [f.launches for f in counters]
    gen = torch.Generator().manual_seed(0)
    a, w, d = (torch.randn(*s, generator=gen) for s in ((40, 9), (6, 20), (40, 6)))
    wt = w[:, 4:13].t()  # (9, 6), strides (1, 20)
    for kern, plain, args in ((ops.KERNELS.mm, ops.PLAIN.mm, (a, wt)),
                              (ops.KERNELS.mm_da, ops.PLAIN.mm_da, (d, wt)),
                              (ops.KERNELS.mm_db, ops.PLAIN.mm_db, (a, d)),
                              (ops.KERNELS.bias_grad, ops.PLAIN.bias_grad, (d,))):
        assert torch.equal(kern(*args), plain(*args))
    assert mm.mixed_mm(a, wt).shape == (40, 6)
    assert mm.mixed_mm_da(d, wt).shape == (40, 9)
    assert mm.mixed_mm_db(a, d).shape == (9, 6)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("call, error", [
    (lambda: mm.mixed_mm(torch.zeros(4, 5), torch.zeros(6, 3)), ValueError),
    (lambda: mm.mixed_mm(torch.zeros(4, 5, dtype=torch.float64), torch.zeros(5, 3)), TypeError),
    (lambda: mm.mixed_mm(torch.zeros(4, 10)[:, ::2], torch.zeros(5, 3)), ValueError),
    (lambda: mm.mixed_mm(torch.zeros(4, 5), torch.zeros(5, 3, 1)), ValueError),
    (lambda: mm.mixed_mm_da(torch.zeros(4, 3), torch.zeros(5, 4)), ValueError),
    (lambda: mm.mixed_mm_db(torch.zeros(4, 5), torch.zeros(3, 2)), ValueError),
    (lambda: bias.bias_grad(torch.zeros(4, 3, dtype=torch.float16)), TypeError),
    (lambda: bias.bias_grad(torch.zeros(4)), ValueError),
], ids=["mm depth", "mm dtype", "mm strided a", "mm 3-D b", "da width", "db rows",
        "bias dtype", "bias 1-D"])
def test_k10_k11_wrappers_reject_bad_arguments(call, error):
    with pytest.raises(error):
        call()


def test_bias_add_matches_jax():
    """The bias-dot Function against JAX's ``_bias_add``: the forward is the
    plain add and the input's gradient is dout, both bit for bit; the bias
    gradient sums M = 4 x 9 rows of float32 in another order: per column
    within 2 M u sum|dout|."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 9, 128)).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32)
    dout = rng.normal(size=(4, 9, 128)).astype(np.float32)
    want, vjp = jax.vjp(jsh._bias_add, jnp.asarray(x), jnp.asarray(b))
    want_dx, want_db = vjp(jnp.asarray(dout))
    tx = torch.from_numpy(x).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = bias.bias_add(tx, tb, ops.PLAIN.bias_grad)
    got.backward(torch.from_numpy(dout))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_dx))
    bound = 2 * 36 * U32 * np.abs(dout).reshape(-1, 128).astype(np.float64).sum(0)
    assert np.all(np.abs(tb.grad.numpy() - np.asarray(want_db)) <= bound)


# ---------------------------------------------------------------------------
# MLP_Fea's forms
# ---------------------------------------------------------------------------
FORMS = {
    "split": dict(SPLIT_L1=True),
    "hoist": dict(HOIST_DIRS=True),
    "bias_dot": dict(BIAS_DOT=True),
    "mixed": dict(MIXED_MM=True),
    "hoist_mixed": dict(HOIST_DIRS=True, MIXED_MM=True),
    "mixed_bias_hoist": dict(MIXED_MM=True, BIAS_DOT=True, HOIST_DIRS=True),
}
R, S, APP_DIM = 33, 17, 27


@pytest.mark.parametrize("form", sorted(FORMS))
def test_mlp_fea_form_matches_jax(form, monkeypatch):
    """``MLPFea.apply_params`` under each form against JAX's ``make_shader``
    (``matmul=mixed_matmul`` where the form mixes), at the production
    widths (app_dim 27, featureC 128, PE 2) on 33 rays x 17 samples: the
    output, every parameter's gradient and the features' gradient.  The
    float32 forms reorder float32 sums only: the output within 1e-6 (as
    JAX's own hoist test holds it), the gradients within 1e-5 of each
    tensor's largest entry.  The mixed forms also round every operand to
    bf16, and where the two sides' float32 sums differ in a last bit that
    rounding can land one bf16 ulp (2**-8) apart: one such step in a hidden
    unit h moves the outputs of its row by about 6e-5 |h| (measured 5.6e-5
    here) and a gradient entry by up to 2**-8 of one of its terms.  So the
    output within 5e-4 (|h| stays under 5 on these inputs), each gradient
    within 1e-3 of its norm (relative L2; measured <= 1e-5) and within
    2**-6 of its largest entry anywhere.  The bf16 arithmetic itself is
    held tightly by test_mixed_matmul_matches_jax_vjp."""
    switches = FORMS[form]
    flip(monkeypatch, **{k: v for k, v in switches.items() if k != "MIXED_MM"})
    mixed = switches.get("MIXED_MM", False)
    hoist = switches.get("HOIST_DIRS", False)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(R, S, APP_DIM)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_in = dirs if hoist else np.broadcast_to(dirs[:, None, :], (R, S, 3)).copy()

    shader = jsh.make_shader("MLP_Fea", APP_DIM, view_pe=2, fea_pe=2, feature_c=128,
                             matmul=jmm.mixed_matmul if mixed else None)
    jp = shader.init(jax.random.PRNGKey(3))

    def jax_loss(p, f):
        return jnp.sum(shader.apply(p, None, jnp.asarray(dirs_in), f) ** 2)

    want = np.asarray(shader.apply(jp, None, jnp.asarray(dirs_in), jnp.asarray(feats)))
    want_gp, want_gf = jax.grad(jax_loss, argnums=(0, 1))(jp, jnp.asarray(feats))

    port = tsh.MLPFea(APP_DIM, view_pe=2, fea_pe=2, feature_c=128)
    params = {}
    for i in (1, 2, 3):
        params[f"shader.l{i}.weight"] = torch.tensor(np.asarray(jp[f"l{i}"]["w"]).T.copy(),
                                                     requires_grad=True)
        params[f"shader.l{i}.bias"] = torch.tensor(np.asarray(jp[f"l{i}"]["b"]),
                                                   requires_grad=True)
    tf = torch.from_numpy(feats).requires_grad_(True)
    got = port.apply_params(params, "shader.", torch.from_numpy(dirs_in), tf, ops.PLAIN, mixed)
    (got ** 2).sum().backward()

    assert tuple(got.shape) == (R, S, 3)
    out_tol = 5e-4 if mixed else 1e-6
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=out_tol)
    pairs = [(tf.grad.numpy(), np.asarray(want_gf))]
    for i in (1, 2, 3):
        pairs.append((params[f"shader.l{i}.weight"].grad.numpy().T,
                      np.asarray(want_gp[f"l{i}"]["w"])))
        pairs.append((params[f"shader.l{i}.bias"].grad.numpy(), np.asarray(want_gp[f"l{i}"]["b"])))
    for g, w in pairs:
        assert g.shape == w.shape
        if mixed:
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)
            assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the models under the forms
# ---------------------------------------------------------------------------
def _ego_eval(monkeypatch, switches, n_rays=64):
    """EgoNeRF's eval forward (key=None, the render path with the bf16
    tables) on both sides under ``switches``, the models built after the
    flip (EGONERF_MIXED_MM is read at construction)."""
    flip(monkeypatch, **switches)
    jm, jp, tm = _ego_pair("bfloat16")
    rays, _ = _batch(seed=3)
    rays = rays[:n_rays]
    want = jax.jit(lambda p, r: jm.forward(p, r, key=None, is_train=False, **RENDER))(
        jp, jnp.asarray(rays))
    with torch.no_grad():
        params = tm.params()
        got = tm.forward(params, torch.from_numpy(rays), tables=tm.lookup_tables(params),
                         **RENDER)
    return tm, got, want


@pytest.mark.parametrize("form", ["mixed", "mixed_bias_hoist"])
def test_egonerf_eval_forward_under_the_forms(form, monkeypatch):
    """EgoNeRF's eval forward under ``EGONERF_MIXED_MM=1`` (the shader and
    the basis through ``mixed_matmul``, the charts' products in one call)
    and under the three switches together, against JAX's: depth as the
    default path holds it (the shader does not reach it), rgb within 1e-5
    as the default path's test holds it: a bf16 step of a hidden unit
    (test_mlp_fea_form_matches_jax) reaches rgb times its sample's weight,
    and no sample weighs much at these random weights (measured 6e-8)."""
    tm, got, want = _ego_eval(monkeypatch, FORMS[form])
    assert tm.mixed_mm
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)


def test_mixed_mm_is_decided_at_construction(monkeypatch):
    """``EGONERF_MIXED_MM`` applies to EgoNeRF under bf16 compute only, read
    when the model is built, as JAX's ``self._mm``; TensoRF never mixes."""
    flip(monkeypatch, MIXED_MM=True)
    jm, _, tm = _ego_pair("bfloat16")
    assert tm.mixed_mm and jm._mm is jmm.mixed_matmul
    jm, _, tm = _ego_pair("float32")
    assert not tm.mixed_mm and jm._mm is None
    flip(monkeypatch, MIXED_MM=False)
    _, _, tm = _ego_pair("bfloat16")
    assert not tm.mixed_mm


def test_egonerf_step_under_mixed_mm(monkeypatch):
    """One EgoNeRF training step under ``EGONERF_MIXED_MM=1`` against
    ``jax.value_and_grad`` with JAX's draws, at test_torch_train's shape:
    the loss to rel 1e-5; the planes and lines to test_torch_train's bf16
    bounds (JAX's fastgrad planes add in bf16; the hat lines round each
    cotangent to bf16 on both sides); the shader's and the basis's
    gradients, which now come out of bf16 x bf16 contractions, within 1e-3
    of their norm (relative L2; measured <= 4e-5), as in the MLP test; the
    others as the float32 step (1e-4 of the largest entry)."""
    flip(monkeypatch, MIXED_MM=True)
    jm, jp, tm = _ego_pair("bfloat16")
    assert tm.mixed_mm
    rays, rgbs = _batch()
    key = jax.random.PRNGKey(5)
    k_coarse, k_pdf = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k_coarse, (N_RAYS, RENDER["n_coarse"])))
    u = np.asarray(jax_sorted_uniform(k_pdf, (N_RAYS, RENDER["n_fine"])))

    def loss_fn(p):
        out = jm.forward(p, jnp.asarray(rays), key=key, is_train=True, **RENDER)
        return jnp.mean((out["rgb"] - jnp.asarray(rgbs)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    want = jax_ckpt._flatten(want_grads)
    rec = _Recorder()
    tm.ops = ops.KERNELS._replace(field_bwd=rec)
    params = tm.params()
    out = tm.forward(params, torch.from_numpy(rays), is_train=True,
                     jitter=torch.tensor(jitter), u=torch.tensor(u), **RENDER)
    loss = torch.mean((out["rgb"] - torch.from_numpy(rgbs)) ** 2)
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in params.items()})
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)

    coords, planes, lines, d_dens, d_app, mask, n_density, line_hat = rec.args
    mag_p, mag_l = vm_lookup.field_bwd_plain(coords, planes, lines, d_dens, d_app, mask,
                                             n_density, line_hat, magnitude=True)
    for k in sorted(want):
        g, w = got[k], np.asarray(want[k])
        assert g.shape == w.shape and np.isfinite(g).all(), k
        if "planes" in k or "lines" in k:
            i = int(k.split("/")[1])
            cd = n_density[i]
            sl = slice(None, cd) if k.startswith("density") else slice(cd, None)
            if "planes" in k:
                bound = (plane_hits(coords, planes[i].shape, i) + 1) * 2.0 ** -8 \
                    * mag_p[i][..., sl].numpy()
            else:
                assert line_hat[i]
                bound = 2.0 ** -7 * mag_l[i][..., sl].numpy()
            assert np.all(np.abs(g - w) <= bound + 1e-4 * np.abs(w).max() + 1e-12), k
        elif k.startswith(("shader", "basis")):
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("form", ["hoist", "split", "bias_dot"])
def test_tensorf_eval_forward_under_the_forms(form, monkeypatch):
    """TensorVMSplit's eval forward under the hoist (unexpanded viewdirs to
    the shader), the split first layer and the bias-dot add, against JAX's:
    float32 sums in another order, rgb abs 1e-5 and depth abs 1e-4 as the
    default test holds them."""
    flip(monkeypatch, **FORMS[form])
    jm, jp, tm = _tf_pair()
    rays = _tf_rays(64, seed=5)
    want = jax.jit(lambda p, r: jm.forward(p, r, n_coarse=40))(jp, jnp.asarray(rays))
    with torch.no_grad():
        params = tm.params()
        got = tm.forward(params, torch.from_numpy(rays), n_coarse=40,
                         tables=tm.lookup_tables(params))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)
