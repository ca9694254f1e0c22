"""``EGONERF_LINE_HAT=0`` in the port against the JAX package, on the CPU:
the fine lines off the hat path.  JAX's EgoNeRF then takes
``sample_line_packed_fastgrad`` (float32 linear weights forward; backward
``_line_bwd_onehot``: each corner cotangent rounded to bf16, summed in
float32, while its one-hot gate holds), and TensoRF ``sample_line_packed``
(float32 both ways).  The port's line modes, K2's plain version in the new
mode against ``jax.vjp``, the gate, the models' choice of mode, EgoNeRF's
eval forward and one training step, and TensoRF's forward.  Inputs come from
numpy seeds and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.ops import vm_lookup as jvm
from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch import ops
from egonerf_torch.models import params_to_jax
from egonerf_torch.ops import vm_lookup
from egonerf_torch.ops.vm_lookup import HAT, LINEAR, LINEAR_BF16_GRAD
from test_torch_grad import N_DENSITY, _jax_field_grads, _port_grads, _problem
from test_torch_shader_forms import flip
from test_torch_tensorf import _pair as _tf_pair
from test_torch_tensorf import _rays as _tf_rays
from test_torch_train import N_RAYS, RENDER, _batch, _Recorder, plane_hits
from test_torch_train import _pair as _ego_pair


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_line_onehot_gate_matches_jax():
    """``line_onehot_ok`` is JAX's ``_onehot_ok`` with the backward's cap of
    4,096 rows (and the 3e9-byte matrix); the production fine lines (1,032
    stacked rows at 4096 x 256 samples) hold it, twice the samples do not."""
    assert vm_lookup.line_onehot_ok(1032, 4096 * 256)
    assert not vm_lookup.line_onehot_ok(1032, 2 * 4096 * 256)
    assert vm_lookup.line_onehot_ok(4096, 10) and not vm_lookup.line_onehot_ok(4097, 10)
    for rows in (1, 300, 1152, 1153, 4096, 4097):
        for n in (10, 4096 * 256, 3 * 10 ** 6):
            assert vm_lookup.line_onehot_ok(rows, n) == jvm._onehot_ok(rows, n, 4096)


def test_field_bwd_linear_bf16_matches_jax_vjp():
    """K2's plain version in line mode 2 against ``jax.vjp`` through
    ``sample_line_packed_fastgrad`` (float32 planes, so that the lines'
    rounding is what differs): both round the same float32 corner
    cotangents w * dl to bf16 and sum them in float32, in another order:
    rel 1e-5 of each gradient's largest entry, as the float32 test.  The
    float32 mode misses JAX's lines by more: the rounding is there."""
    planes, lines, coords, d_dens, d_app = _problem(4, 3000)
    want_p, want_l = _jax_field_grads(jvm.sample_plane_packed, jvm.sample_line_packed_fastgrad,
                                      planes, lines, coords, d_dens, d_app)
    got_p, got_l = _port_grads(planes, lines, coords, d_dens, d_app, (LINEAR_BF16_GRAD,) * 3)
    for got, want in zip(got_p + got_l, want_p + want_l):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _, f32_l = _port_grads(planes, lines, coords, d_dens, d_app, (LINEAR,) * 3)
    assert max(np.abs(g - w).max() / np.abs(w).max() for g, w in zip(f32_l, want_l)) > 1e-4


def test_line_modes_share_the_linear_forward():
    """Mode 2 is mode 0 forward (K1's off-gate lookup, JAX's ``_line_fwd``):
    the same density, appearance and relu mask bit for bit; the kernels'
    int array carries the mode, and an unknown mode raises."""
    planes, lines, coords, _, _ = _problem(5, 500)
    bf = [torch.tensor(t).to(torch.bfloat16) for t in planes + lines]
    c = torch.from_numpy(coords)
    lin = vm_lookup.field_fwd_plain(c, bf[:3], bf[3:], N_DENSITY, (LINEAR,) * 3, with_mask=True)
    two = vm_lookup.field_fwd_plain(c, bf[:3], bf[3:], N_DENSITY, (LINEAR_BF16_GRAD,) * 3,
                                    with_mask=True)
    for a, b in zip(lin, two):
        assert torch.equal(a, b)
    dims = list(vm_lookup._dims(c, bf[:3], bf[3:], N_DENSITY, (LINEAR_BF16_GRAD, HAT, LINEAR)))
    assert [dims[6 * i + 5] for i in range(3)] == [2, 1, 0]
    with pytest.raises(ValueError, match="line mode"):
        vm_lookup._dims(c, bf[:3], bf[3:], N_DENSITY, (3, 0, 0))


def test_models_pick_the_line_modes(monkeypatch):
    """As JAX's ``_fused_products`` picks the line function: EgoNeRF under
    bf16 compute takes the hat path by default and mode 2 under
    ``EGONERF_LINE_HAT=0`` (mode 0 past the one-hot gate, and always under
    float32 compute); TensoRF takes mode 0 under the switch."""
    _, _, tm = _ego_pair("bfloat16")
    lines = [tm.density_lines[i] for i in range(3)]
    assert tm._line_hat(lines, 1000) == [HAT] * 3
    flip(monkeypatch, LINE_HAT=False)
    assert tm._line_hat(lines, 1000) == [LINEAR_BF16_GRAD] * 3
    rows = lines[0].shape[0] * lines[0].shape[1]
    too_many = int(3e9 / (2 * rows)) + 1
    assert not vm_lookup.line_onehot_ok(rows, too_many)
    assert tm._line_hat(lines[:1], too_many) == [LINEAR]
    _, _, t32 = _ego_pair("float32")
    assert t32._line_hat(lines, 1000) == [LINEAR] * 3
    _, _, tf = _tf_pair()
    assert tf._line_hat([tf.density_lines[0]], 1000) == [LINEAR]
    flip(monkeypatch, LINE_HAT=True)
    assert tf._line_hat([tf.density_lines[0]], 1000) == [HAT]


def test_egonerf_eval_forward_line_hat_off(monkeypatch):
    """EgoNeRF's eval forward with the fine lines off the hat path against
    JAX's: rgb abs 1e-5, depth abs 1e-4, as the default path's test."""
    flip(monkeypatch, LINE_HAT=False)
    jm, jp, tm = _ego_pair("bfloat16")
    rays, _ = _batch(seed=4)
    want = jax.jit(lambda p, r: jm.forward(p, r, key=None, is_train=False, **RENDER))(
        jp, jnp.asarray(rays))
    with torch.no_grad():
        params = tm.params()
        got = tm.forward(params, torch.from_numpy(rays), tables=tm.lookup_tables(params),
                         **RENDER)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)


def test_egonerf_step_line_hat_off(monkeypatch):
    """One EgoNeRF training step with the fine lines off the hat path
    against ``jax.value_and_grad`` with JAX's draws: the loss to rel 1e-5;
    the planes to test_torch_train's bf16 bound (JAX's fastgrad planes add
    in bf16); the lines to 2**-7 x sum|terms| beyond the float32 limit: both
    sides round each corner's w * dl to bf16, and float32 cotangents that
    differ in their last bits (d_app comes out of the basis matmul's
    backward) may round to neighbouring bf16 values; the rest as the
    float32 step (1e-4 of each tensor's largest entry)."""
    flip(monkeypatch, LINE_HAT=False)
    jm, jp, tm = _ego_pair("bfloat16")
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
    assert list(line_hat) == [LINEAR_BF16_GRAD] * 3
    mag_p, mag_l = vm_lookup.field_bwd_plain(coords, planes, lines, d_dens, d_app, mask,
                                             n_density, line_hat, magnitude=True)
    for k in sorted(want):
        g, w = got[k], np.asarray(want[k])
        assert g.shape == w.shape and np.isfinite(g).all(), k
        slack = 1e-4 * np.abs(w).max() + 1e-12
        if "planes" in k or "lines" in k:
            i = int(k.split("/")[1])
            cd = n_density[i]
            sl = slice(None, cd) if k.startswith("density") else slice(cd, None)
            if "planes" in k:
                bound = (plane_hits(coords, planes[i].shape, i) + 1) * 2.0 ** -8 \
                    * mag_p[i][..., sl].numpy()
            else:
                bound = 2.0 ** -7 * mag_l[i][..., sl].numpy()
            assert np.all(np.abs(g - w) <= bound + slack), k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=slack, err_msg=k)


def test_tensorf_eval_forward_line_hat_off(monkeypatch):
    """TensorVMSplit's eval forward with float32 line weights (JAX's
    ``sample_line_packed`` under the switch) against JAX's: rgb abs 1e-5,
    depth abs 1e-4, as the default test."""
    flip(monkeypatch, LINE_HAT=False)
    jm, jp, tm = _tf_pair()
    rays = _tf_rays(64, seed=6)
    want = jax.jit(lambda p, r: jm.forward(p, r, n_coarse=40))(jp, jnp.asarray(rays))
    with torch.no_grad():
        params = tm.params()
        got = tm.forward(params, torch.from_numpy(rays), n_coarse=40,
                         tables=tm.lookup_tables(params))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-4)
