"""The theta-importance sampler of the port against the JAX package's: the
row weights and raster, the host ids for the same seed, and K14's plain
version (``ops/sampler.py::theta_ids_plain``) against the arithmetic of
JAX's ``make_device_id_sampler`` on the same draws, hard uniforms
included.  Every comparison is exact: the ids are integers and the weights
the same numpy expressions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_torch import ops
from egonerf_torch.data.samplers import DeviceThetaSampler, HostRaySampler
from egonerf_torch.data.samplers import ThetaImportanceSampler as PortSampler
from egonerf_torch.ops import sampler
from egonerf_tpu.data.samplers import ThetaImportanceSampler as JaxSampler
from egonerf_tpu.data.samplers import make_device_id_sampler

# (full w, h, roi): the Ricoh raster, its roi crop, fractional crops
RASTERS = [((1920, 960), [0.0, 1.0, 0.0, 1.0]), ((1920, 960), [0.05, 0.95, 0.0, 1.0]),
           ((240, 120), [0.05, 0.95, 0.0, 1.0]), ((37, 19), [0.13, 0.77, 0.21, 0.9]),
           ((20, 10), [0.0, 0.9, 0.0, 1.0])]


def _pair(full_wh, roi, lam=4.0, n_img=3, batch=512, seed=0):
    w = int(roi[3] * full_wh[0]) - int(roi[2] * full_wh[0])
    h = int(roi[1] * full_wh[1]) - int(roi[0] * full_wh[1])
    n = n_img * w * h
    return (PortSampler(lam, n, full_wh, batch, roi, seed=seed),
            JaxSampler(lam, n, full_wh, batch, roi, seed=seed))


@pytest.mark.parametrize("full_wh,roi", RASTERS)
def test_weights_and_raster_equal_jax(full_wh, roi):
    got, want = _pair(full_wh, roi)
    assert (got.w, got.h, got.img_len) == (want.w, want.h, want.img_len)
    assert got.weight.dtype == want.weight.dtype
    np.testing.assert_array_equal(got.weight, want.weight)


@pytest.mark.parametrize("full_wh,roi", RASTERS[1:3])
def test_host_ids_equal_jax(full_wh, roi):
    got, want = _pair(full_wh, roi, seed=5)
    for _ in range(50):
        np.testing.assert_array_equal(got.nextids(), want.nextids())


def test_flat_layout_is_required():
    with pytest.raises(ValueError, match="multiple"):
        PortSampler(4.0, 1001, (20, 10), 8, [0.0, 1.0, 0.0, 1.0])


def _jax_draws(sam, batch, seed):
    """JAX's draw for ``seed`` and the (img, col, u) it drew (the same key
    splits as inside ``make_device_id_sampler``'s theta branch)."""
    draw = make_device_id_sampler(sam, batch, sam.img_len * sam.w * sam.h)
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    img = jax.random.randint(k1, (batch,), 0, sam.img_len)
    col = jax.random.randint(k2, (batch,), 0, sam.w)
    u = jax.random.uniform(k3, (batch,))
    return np.asarray(draw(key)), np.asarray(img), np.asarray(col), np.asarray(u)


def _port_ids(sam, img, col, u, fn=sampler.theta_ids):
    cdf = torch.as_tensor(np.cumsum(sam.weight).astype(np.float32))
    return fn(torch.from_numpy(np.array(img, np.int64)), torch.from_numpy(np.array(col, np.int64)),
              torch.from_numpy(np.array(u, np.float32)), cdf, sam.w, sam.h).numpy()


@pytest.mark.parametrize("full_wh,roi", RASTERS)
def test_device_draw_equals_jax_on_its_uniforms(full_wh, roi):
    _, sam = _pair(full_wh, roi)
    for seed in range(3):
        want, img, col, u = _jax_draws(sam, 4096, seed)
        np.testing.assert_array_equal(_port_ids(sam, img, col, u), want)


def _jax_rows(cdf, u, h):
    return np.asarray(jnp.minimum(jnp.searchsorted(jnp.asarray(cdf), jnp.asarray(u),
                                                   side="left", method="compare_all"), h - 1))


def _hard_u(cdf):
    """0, every cdf value, its float32 neighbours, 1 - ulp, and values above
    cdf[-1] (where the cast left it below 1)."""
    up = np.nextafter(cdf, np.float32(2))
    down = np.nextafter(cdf, np.float32(-1))
    top = np.float32(1) - np.finfo(np.float32).epsneg
    return np.concatenate([[0.0, top, np.nextafter(cdf[-1], np.float32(2))], cdf, up,
                           down]).astype(np.float32)


@pytest.mark.parametrize("full_wh,roi", RASTERS)
def test_row_draw_on_hard_uniforms(full_wh, roi):
    _, sam = _pair(full_wh, roi)
    cdf = np.cumsum(sam.weight).astype(np.float32)
    u = _hard_u(cdf)
    zeros = np.zeros(u.shape[0], np.int64)
    rows = _port_ids(sam, zeros, zeros, u) // sam.w
    np.testing.assert_array_equal(rows, _jax_rows(cdf, u, sam.h))
    # lower bound on ties: u equal to cdf[i] takes row i, its float32
    # successor row i + 1 (clamped)
    first = np.searchsorted(cdf, cdf, side="left")
    np.testing.assert_array_equal(rows[3:3 + cdf.shape[0]], np.minimum(first, sam.h - 1))


def test_row_draw_on_a_cdf_ending_below_one_and_with_ties():
    """A cdf whose last value sits below u (the clamp to h - 1) and runs of
    equal values (the first of a run is taken)."""
    cdf = np.array([0.1, 0.1, 0.1, 0.5, 0.5, 0.9999], np.float32)
    u = np.array([0.0, 0.05, 0.1, np.nextafter(np.float32(0.1), np.float32(1)), 0.5, 0.7,
                  0.9999, 0.99995, 0.99999994], np.float32)
    got = sampler.theta_ids_plain(torch.zeros(9, dtype=torch.int64),
                                  torch.zeros(9, dtype=torch.int64), torch.as_tensor(u),
                                  torch.as_tensor(cdf), 1, 6).numpy()
    np.testing.assert_array_equal(got, _jax_rows(cdf, u, 6))
    np.testing.assert_array_equal(got, [0, 0, 0, 3, 3, 5, 5, 5, 5])


def test_single_row():
    """h = 1: every draw takes row 0."""
    cdf = np.array([1.0], np.float32)
    u = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
    img = np.array([0, 1, 2, 3])
    col = np.array([4, 3, 2, 1])
    got = sampler.theta_ids_plain(torch.as_tensor(img), torch.as_tensor(col),
                                  torch.as_tensor(u), torch.as_tensor(cdf), 5, 1).numpy()
    np.testing.assert_array_equal(got, img * 5 + col)
    np.testing.assert_array_equal(_jax_rows(cdf, u, 1), 0)


def test_wrapper_on_cpu_takes_the_plain_version():
    _, sam = _pair((240, 120), [0.05, 0.95, 0.0, 1.0])
    _, img, col, u = _jax_draws(sam, 1000, 9)
    before = sampler.theta_ids.launches
    np.testing.assert_array_equal(_port_ids(sam, img, col, u),
                                  _port_ids(sam, img, col, u, sampler.theta_ids_plain))
    assert ops.KERNELS.theta_ids is sampler.theta_ids
    assert ops.PLAIN.theta_ids is sampler.theta_ids_plain
    assert sampler.theta_ids.launches == before


def test_samplers_gather_the_rows_of_their_ids():
    """The device sampler's batch is the buffer's rows at its ids, each in
    the flat (img, row, col) layout, and its first batch is batch t = 1;
    the host sampler's rows are those of ``nextids``."""
    host, _ = _pair((24, 12), [0.0, 0.75, 0.0, 1.0], n_img=2, batch=64, seed=3)
    n = host.img_len * host.w * host.h
    rays = np.arange(n * 6, dtype=np.float32).reshape(n, 6)
    rgbs = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    dev = DeviceThetaSampler(rays, rgbs, host, 64, "cpu", seed=0)
    assert dev.cdf.dtype == torch.float32
    np.testing.assert_array_equal(dev.cdf.numpy(), np.cumsum(host.weight).astype(np.float32))
    ids, rows = dev.draw(1)
    assert ids.dtype == torch.int64 and ids.shape == (64,)
    assert int(ids.min()) >= 0 and int(ids.max()) < n
    assert torch.equal(rows, dev.buffer[ids])
    batch = dev.next_batch()
    assert batch.shape == (64, 9) and float(batch[:, 0].remainder(6).abs().max()) == 0.0
    assert torch.equal(batch, rows)
    twin, _ = _pair((24, 12), [0.0, 0.75, 0.0, 1.0], n_img=2, batch=64, seed=3)
    hs = HostRaySampler(rays, rgbs, host, "cpu")
    want = twin.nextids()
    np.testing.assert_array_equal(hs.next_batch().numpy(),
                                  np.concatenate([rays, rgbs], 1)[want])
