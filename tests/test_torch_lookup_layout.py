"""The lane layout of the VM-grid lookup kernels K1/K3 and their density
order, on the CPU: the wrapper's pure-Python geometry (lanes a sample
takes, samples a warp holds, the vector or the scalar instantiation),
``_warp_order_sum`` against a numpy emulation of the lane order written
down in ``csrc/vm_lookup.cu``, and K2's plain version, with the relu mask
of K1's plain version, against ``jax.vjp`` at the widths the kernels meet.  Inputs come
from numpy seeds and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonerf_tpu.ops import vm_lookup as jvm
from egonerf_torch.ops import vm_lookup

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
# C -> lanes a sample takes: the power of two that covers ceil(C / 8)
# chunks of 8 channels.  8 and 16 are the smoke and production coarse
# grids, 24 the smoke fine grid, 64 the production fine grid, 20 a width
# that is not a multiple of 8 (scalar loads).
GROUP = {8: 1, 16: 2, 24: 4, 64: 8, 20: 4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(c, s, c_other=None):
    """bf16 tables of a stack of ``s`` grids with ``c`` channels (planes 1
    and 2 with ``c_other`` if given)."""
    widths = (c, c_other or c, c_other or c)
    planes = [torch.zeros(s, 5, 6, w, dtype=torch.bfloat16) for w in widths]
    lines = [torch.zeros(s, 7, w, dtype=torch.bfloat16) for w in widths]
    return planes, lines


@pytest.mark.parametrize("s", [1, 2], ids=["one_grid", "two_grids"])
@pytest.mark.parametrize("c", sorted(GROUP))
def test_layout_geometry(c, s):
    planes, lines = _tables(c, s)
    layout = vm_lookup.lookup_layout(torch.zeros(16, 4), planes, lines)
    g = GROUP[c]
    assert layout == vm_lookup.Layout(group=g, samples_per_warp=32 // g,
                                      samples_per_block=256 // g, vector=c % 8 == 0)
    # the kernel's int array carries the stack size, log2 of the group and
    # the vector flag after the 18 per-decomposition entries; K2's two
    # entries follow, zeros for K1/K3
    dims = list(vm_lookup._dims(torch.zeros(16, 4), planes, lines, (c // 2,) * 3, (True,) * 3))
    assert dims[18:] == [s, g.bit_length() - 1, int(c % 8 == 0), 0, 0]
    assert dims[3:5] == [c, c // 2]


def test_layout_takes_the_widest_table_and_caps_the_group():
    # the group covers the widest decomposition; the narrower ones idle lanes
    planes, lines = _tables(64, 2, c_other=16)
    assert vm_lookup.lookup_layout(torch.zeros(4, 4), planes, lines)[:2] == (8, 4)
    # past 256 channels a warp is one sample and each lane loops over chunks
    planes, lines = _tables(264, 1)
    assert vm_lookup.lookup_layout(torch.zeros(4, 4), planes, lines) == vm_lookup.Layout(
        32, 1, 8, True)
    # one width off the 8-grid makes all three decompositions scalar
    planes, lines = _tables(64, 2, c_other=20)
    assert not vm_lookup.lookup_layout(torch.zeros(4, 4), planes, lines).vector


def test_layout_takes_scalar_stores_where_the_bulk_copy_cannot_go():
    # K1's bulk copy moves whole rows of n_app floats in 16-byte units
    planes, lines = _tables(16, 2)
    coords = torch.zeros(4, 4)
    assert vm_lookup.lookup_layout(coords, planes, lines, n_app=3 * 12).vector
    assert not vm_lookup.lookup_layout(coords, planes, lines, n_app=3 * 11).vector
    assert not vm_lookup._dims(coords, planes, lines, (5, 5, 5), (True,) * 3)[20]
    assert vm_lookup._dims(coords, planes, lines, (16, 16, 16), (True,) * 3)[20]
    # and a block's rows must fit the 48 KB tile: 8 samples x 3 x 1024 floats do not
    planes, lines = _tables(1024, 1)
    assert vm_lookup.lookup_layout(coords, planes, lines, n_app=3 * 512).vector
    assert not vm_lookup.lookup_layout(coords, planes, lines, n_app=3 * 1024).vector


def test_layout_takes_scalar_loads_off_16_byte_alignment():
    planes, lines = _tables(64, 2)
    # a contiguous view two bytes into its storage
    flat = torch.zeros(planes[0].numel() + 1, dtype=torch.bfloat16)
    planes[0] = flat[1:].view(planes[0].shape)
    assert planes[0].is_contiguous() and planes[0].data_ptr() % 16 == 2
    assert not vm_lookup.lookup_layout(torch.zeros(4, 4), planes, lines).vector
    coords = torch.zeros(16 * 4 + 1)[1:].view(16, 4)
    assert not vm_lookup.lookup_layout(coords, *_tables(64, 2)).vector


def _lane_order_sum(prod: np.ndarray, group: int) -> np.ndarray:
    """K1's density sum as the source note at the head of
    csrc/vm_lookup.cu writes it down, in float32 numpy: channel c in chunk
    c // 8, chunk q to lane q mod ``group``, each lane adds its channels in
    increasing c from 0, then a butterfly over xor offsets group/2 .. 1."""
    n, cd = prod.shape
    lanes = np.zeros((n, group), np.float32)
    for c in range(cd):
        g = (c // 8) % group
        lanes[:, g] = (lanes[:, g] + prod[:, c]).astype(np.float32)
    idx = np.arange(group)
    off = group // 2
    while off:
        lanes = (lanes + lanes[:, idx ^ off]).astype(np.float32)
        off //= 2
    return lanes[:, 0]


@pytest.mark.parametrize("cd, c", [(8, 24), (16, 64), (16, 16), (13, 20), (13, 64), (300, 304)],
                         ids=["cd8_c24", "cd16_c64", "cd16_c16", "cd13_c20", "cd13_c64",
                              "cd300_c304"])
def test_warp_order_sum_is_the_documented_lane_order(cd, c):
    """``_warp_order_sum`` (32 lanes) equals K1's lane-group order bit
    for bit, for the group K1 takes at width ``c``; the values span six
    decades and both signs, so another order gives other bits."""
    rng = np.random.default_rng(cd * 1000 + c)
    prod = (rng.normal(size=(4000, cd)) * 10.0 ** rng.uniform(-3, 3, (4000, cd))).astype(
        np.float32)
    group = vm_lookup.lookup_layout(torch.zeros(1, 4), *_tables(c, 2)).group
    want = _lane_order_sum(prod, group)
    got = vm_lookup._warp_order_sum(torch.from_numpy(prod)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if cd > 8:
        # past one chunk the order matters on these values: the sequential
        # sum differs somewhere
        seq = np.zeros(4000, np.float32)
        for k in range(cd):
            seq = (seq + prod[:, k]).astype(np.float32)
        assert (seq != want).any()


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _jax_field_grads(line_fn, planes, lines, coords, d_dens, d_app, n_density):
    """jax.vjp of EgoNeRF.compute_field's fused products in the tables."""
    c = jnp.asarray(coords)
    sel = c[:, 3].astype(jnp.int32)

    def field(ps, ls):
        dens, app = 0.0, []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            pr = (jvm.sample_plane_packed(ps[i], c[:, m0], c[:, m1], sel)
                  * line_fn(ls[i], c[:, VEC_MODE[i]], sel))
            dens = dens + jnp.maximum(jnp.sum(pr[:, :n_density], axis=-1), 0.0)
            app.append(pr[:, n_density:])
        return dens, jnp.concatenate(app, axis=-1)

    _, vjp = jax.vjp(field, [jnp.asarray(p) for p in planes], [jnp.asarray(l) for l in lines])
    gp, gl = vjp((jnp.asarray(d_dens), jnp.asarray(d_app)))
    return [np.asarray(g) for g in gp], [np.asarray(g) for g in gl]


@pytest.mark.parametrize("hat", [False, True], ids=["f32_lines", "hat_lines"])
@pytest.mark.parametrize("c, cd", [(8, 8), (16, 5), (24, 8), (64, 16), (20, 4)],
                         ids=["c8_cd8", "c16_cd5", "c24_cd8", "c64_cd16", "c20_cd4"])
def test_field_bwd_plain_in_lane_order_matches_jax_vjp(c, cd, hat):
    """K2's plain version, its relu mask from K1's plain version, against
    the float32 custom VJPs (_plane_bwd and _line_bwd or _hat_bwd): float32
    sums in another order, rel 1e-5 of each gradient's largest entry."""
    rng = np.random.default_rng(c * 100 + cd)
    n = 1500
    planes = [_bf16_exact(rng.normal(size=(2, 6, 8, c)).astype(np.float32)) for _ in range(3)]
    lines = [_bf16_exact(rng.normal(size=(2, 10, c)).astype(np.float32)) for _ in range(3)]
    coords = np.concatenate([rng.uniform(-1.1, 1.1, (n, 3)),
                             rng.integers(0, 2, (n, 1))], -1).astype(np.float32)
    d_dens = rng.normal(size=n).astype(np.float32)
    d_app = rng.normal(size=(n, 3 * (c - cd))).astype(np.float32)
    line_fn = jvm.sample_line_hat if hat else jvm.sample_line_packed
    want_p, want_l = _jax_field_grads(line_fn, planes, lines, coords, d_dens, d_app, cd)
    bf = [torch.tensor(t).to(torch.bfloat16) for t in planes + lines]
    c_t = torch.from_numpy(coords)
    _, _, mask = vm_lookup.field_fwd_plain(c_t, bf[:3], bf[3:], (cd,) * 3, (hat,) * 3,
                                           with_mask=True)
    got_p, got_l = vm_lookup.field_bwd_plain(c_t, bf[:3], bf[3:], torch.from_numpy(d_dens),
                                             torch.from_numpy(d_app), mask, (cd,) * 3,
                                             (hat,) * 3)
    for got, want in zip(got_p + got_l, want_p + want_l):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_ptxas_report_reads_registers_and_spills(monkeypatch, tmp_path):
    """The build log's ptxas lines become (kernel, registers, spilled
    bytes), which the chip smoke prints and fails on for vm_lookup."""
    from egonerf_torch import _build

    (tmp_path / "libvm_lookup.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function 'kern_a' for 'sm_90a'\n"
        "ptxas info    : Function properties for kern_a\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers, 392 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function 'kern_b' for 'sm_90a'\n"
        "ptxas info    : Function properties for kern_b\n"
        "    8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]\n")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert _build.ptxas_report("vm_lookup") == [("kern_a", 40, 0), ("kern_b", 255, 20)]
