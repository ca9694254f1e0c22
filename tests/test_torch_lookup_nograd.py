"""K15 and K16's plain versions against the JAX functions they replace.

* K15 (``vm_lookup.sample_plane_nograd`` / ``sample_line_nograd``) against
  ``sample_plane_packed_nograd`` / ``sample_line_packed_nograd`` on the
  packed bf16 tables of the same float32 planes and lines: to 1e-6 of
  max|JAX|, since JAX combines the corners per axis ((y0 pair) then (x0
  pair)) where the port sums ((c00 + c01) + c10) + c11, float32 sums of
  the same four products in another order.
* K16 (``grid_sample.sample_line``) against
  ``egonerf_tpu/ops/grid_sample.py::sample_line``, with ``sel`` and with
  ``sel=None``: equal (the same products, each corner outside the grid
  adding an exact zero).

Coordinates from numpy seeds cover [-1.2, 1.2], so corners on and beyond
both edges are included, and the grid's exact corner points."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_torch.ops import grid_sample, vm_lookup
from egonerf_tpu.ops import grid_sample as jax_grid_sample
from egonerf_tpu.ops import vm_lookup as jax_vm

TOL = 1e-6


def _coords(rng, n, size):
    c = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    # the exact grid points (t = 0) and the edges, in and just out
    grid = np.linspace(-1, 1, size).astype(np.float32)
    edge = np.array([-1, 1, np.nextafter(np.float32(-1), np.float32(-2)),
                     np.nextafter(np.float32(1), np.float32(2)), -1 - 2 / max(size - 1, 1)],
                    np.float32)
    return np.concatenate([c, grid, edge]).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("s,h,w,c", [(2, 9, 13, 16), (1, 7, 5, 12), (2, 4, 6, 5)])
def test_plane_nograd_equals_jax(s, h, w, c):
    rng = np.random.default_rng(s * 100 + c)
    plane = rng.normal(size=(s, h, w, c)).astype(np.float32)
    x = _coords(rng, 700, w)
    n = x.shape[0]
    y = np.resize(_coords(rng, 700, h), n).astype(np.float32)
    sel = rng.integers(0, s, n)
    packed = jax_vm.pack_plane(jnp.asarray(plane))
    bf = torch.from_numpy(plane).to(torch.bfloat16)
    for sl in (sel, None):
        want = np.asarray(jax_vm.sample_plane_packed_nograd(
            packed, h, w, jnp.asarray(x), jnp.asarray(y),
            None if sl is None else jnp.asarray(sl, jnp.int32), c))
        got = vm_lookup.sample_plane_nograd(
            bf, torch.from_numpy(x), torch.from_numpy(y),
            None if sl is None else torch.from_numpy(sl)).numpy()
        assert got.shape == want.shape == (n, c)
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("s,l,c", [(2, 33, 16), (1, 9, 12), (2, 5, 3)])
def test_line_nograd_equals_jax(s, l, c):
    rng = np.random.default_rng(s * 10 + l)
    line = rng.normal(size=(s, l, c)).astype(np.float32)
    z = _coords(rng, 700, l)
    sel = rng.integers(0, s, z.shape[0])
    packed = jax_vm.pack_line(jnp.asarray(line))
    bf = torch.from_numpy(line).to(torch.bfloat16)
    for sl in (sel, None):
        want = np.asarray(jax_vm.sample_line_packed_nograd(
            packed, l, jnp.asarray(z), None if sl is None else jnp.asarray(sl, jnp.int32), c))
        got = vm_lookup.sample_line_nograd(
            bf, torch.from_numpy(z), None if sl is None else torch.from_numpy(sl)).numpy()
        assert got.shape == want.shape == (z.shape[0], c)
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("s,l,c", [(2, 33, 16), (1, 516, 16), (3, 2, 7), (1, 1, 4)])
def test_grid_sample_line_equals_jax(s, l, c):
    rng = np.random.default_rng(l + c)
    lines = rng.normal(size=(s, l, c)).astype(np.float32)
    z = _coords(rng, 900, l)
    sel = rng.integers(0, s, z.shape[0])
    for sl in (sel, None):
        want = np.asarray(jax_grid_sample.sample_line(
            jnp.asarray(lines), jnp.asarray(z), None if sl is None else jnp.asarray(sl)))
        got = grid_sample.sample_line(torch.from_numpy(lines), torch.from_numpy(z),
                                      None if sl is None else torch.from_numpy(sl)).numpy()
        assert got.shape == want.shape == (z.shape[0], c)
        np.testing.assert_array_equal(got, want)


def test_wrappers_on_cpu_take_the_plain_versions():
    rng = np.random.default_rng(0)
    plane = torch.from_numpy(rng.normal(size=(2, 6, 8, 16)).astype(np.float32)).bfloat16()
    line = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    x = torch.from_numpy(_coords(rng, 50, 8))
    sel = torch.from_numpy(rng.integers(0, 2, x.shape[0]))
    counters = (vm_lookup.sample_plane_nograd, vm_lookup.sample_line_nograd,
                grid_sample.sample_line)
    before = [f.launches for f in counters]
    for kern, plain, args in (
            (vm_lookup.sample_plane_nograd, vm_lookup.sample_plane_nograd_plain,
             (plane, x, x.flip(0), sel)),
            (vm_lookup.sample_line_nograd, vm_lookup.sample_line_nograd_plain,
             (line.bfloat16(), x, sel)),
            (grid_sample.sample_line, grid_sample.sample_line_plain, (line, x, None))):
        assert torch.equal(kern(*args), plain(*args))
    assert [f.launches for f in counters] == before
