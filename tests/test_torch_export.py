"""The port's mesh export against the JAX package's, on the CPU: marching
tetrahedra's vertices and faces on seeded volumes (one with no crossing),
the PLY's bytes, the density grid of a small EgoNeRF, TensorVMSplit (on
the xyz chart and on generic_sphere, K7s's plain version) and TensorCP
against JAX's ``export_density_mesh``, and the trainer's export at the end
of training.  Inputs come from numpy seeds and go to both sides."""
import os

import jax
import numpy as np
import pytest
import torch

from egonerf_tpu.coords import make_coordinates as jax_make_coordinates
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.models.tensorf import TensorCP as JaxTensorCP
from egonerf_tpu.models.tensorf import TensorVMSplit as JaxTensorVMSplit
from egonerf_tpu.render import export as jexport
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch import ops
from egonerf_torch.coords import make_coordinates
from egonerf_torch.models import EgoNeRF, FieldConfig, TensorCP, TensorVMSplit, params_from_jax
from egonerf_torch.render import export
from egonerf_torch.train import trainer as trainer_module
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer

SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2, fea_pe=2,
             feature_c=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volumes():
    """(name, volume, level): a distance field's sphere, a seeded smooth
    noise field, a field with values exactly at the level, and two with no
    crossing (all below, all at or above)."""
    rng = np.random.default_rng(0)
    ax = np.linspace(-1, 1, 21, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    noise = rng.normal(size=(9, 11, 13)).astype(np.float32)
    noise = (noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1) + np.roll(noise, 1, 2)) / 4
    steps = np.round(rng.uniform(0, 4, size=(7, 8, 9))).astype(np.float32) / 4
    return [("sphere", sphere, 0.6), ("noise", noise, 0.1), ("ties", steps, 0.5),
            ("none below", np.zeros((5, 6, 7), np.float32), 0.5),
            ("none above", np.ones((5, 6, 7), np.float32), 0.5)]


@pytest.mark.parametrize("case", _volumes(), ids=lambda c: c[0] if isinstance(c, tuple) else c)
def test_marching_tetrahedra_matches_jax(case):
    """Vertices and faces equal to JAX's, in JAX's order, bit for bit (the
    same numpy arithmetic), with a spacing and an origin; no crossing gives
    the empty mesh in both."""
    _, vol, level = case
    spacing, origin = (0.1, 0.2, 0.05), (-1.0, 0.5, 2.0)
    want_v, want_f = jexport.marching_tetrahedra(vol, level, spacing=spacing, origin=origin)
    got_v, got_f = export.marching_tetrahedra(vol, level, spacing=spacing, origin=origin)
    assert got_v.dtype == want_v.dtype == np.float32 and got_f.dtype == want_f.dtype
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    if case[0].startswith("none"):
        assert got_v.shape == (0, 3) and got_f.shape == (0, 3)
    else:
        assert len(got_f) > 10


def test_write_ply_bytes_match_jax(tmp_path):
    """The binary PLY of a mesh, and of the empty mesh, byte for byte."""
    vol, level = _volumes()[1][1:]
    verts, faces = export.marching_tetrahedra(vol, level)
    for name, (v, f) in (("mesh", (verts, faces)),
                         ("empty", (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)))):
        a, b = tmp_path / f"jax_{name}.ply", tmp_path / f"port_{name}.ply"
        jexport.write_ply(str(a), v, f)
        export.write_ply(str(b), v, f)
        assert a.read_bytes() == b.read_bytes()


def _models(name, chart="xyz"):
    """JAX's model and the port's with the same weights, the density tables
    scaled x20 so that alphas spread over (0, 1)."""
    if name == "EgoNeRF":
        aabb = np.array([[-2.0] * 3, [2.0] * 3], np.float32)
        kw = dict(exp_r=True, N_voxel=20 ** 3, r0=0.05, interval_th=True)
        jc, tc = jax_make_coordinates("yinyang", aabb, **kw), make_coordinates("yinyang", aabb,
                                                                               **kw)
        jcls, tcls, shape = JaxEgoNeRF, EgoNeRF, SHAPE
    else:
        aabb = np.array([[-1.5, -1.2, -1.0], [1.5, 1.3, 1.1]], np.float32)
        kw = dict(exp_r=chart == "generic_sphere", N_voxel=12 ** 3, r0=0.05,
                  interval_th=chart == "generic_sphere")
        jc, tc = jax_make_coordinates(chart, aabb, **kw), make_coordinates(chart, aabb, **kw)
        for c in (jc, tc):
            if c.resolution is None:
                c.set_resolution(c.N_to_reso(12 ** 3))
        jcls, tcls = ((JaxTensorCP, TensorCP) if name == "TensorCP"
                      else (JaxTensorVMSplit, TensorVMSplit))
        shape = dict(SHAPE, density_n_comp=(6,), app_n_comp=(9,)) if name == "TensorCP" else SHAPE
    jm = jcls(aabb, jc.resolution, jc, JaxFieldConfig(**shape), near_far=(0.05, 4.0))
    jp = jm.init_params(jax.random.PRNGKey(2))
    for k in ("density_planes", "density_lines"):
        if k in jp:
            jp[k] = [20.0 * a for a in jp[k]]
    tm = tcls(aabb, tc.resolution, tc, FieldConfig(**shape), near_far=(0.05, 4.0), device="cpu")
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


MODELS = [("EgoNeRF", "yinyang"), ("TensorVMSplit", "xyz"), ("TensorVMSplit", "generic_sphere"),
          ("TensorVMSplit", "euler_sphere"), ("TensorCP", "xyz")]


@pytest.mark.parametrize("name, chart", MODELS, ids=[f"{m}-{c}" for m, c in MODELS])
def test_density_grid_matches_jax_export(tmp_path, monkeypatch, name, chart):
    """``density_grid`` (the chart, then the density-only lookup: K7 + K3
    for EgoNeRF, K7s or the plain chart + K3 at S = 1 or K17's density form
    for the family, here their plain versions) against the alpha volume
    JAX's ``export_density_mesh`` hands its marching tetrahedra, on a 10^3
    grid in chunks of 3 rows (a short last chunk): abs 2e-5 on alphas in
    (0, 1), the density lookup's float32 sums in another order (K3's rel
    1e-5, as the bake test holds it).  The port's export of that model
    writes the PLY of its own alpha."""
    jm, jp, tm = _models(name, chart)
    seen, marching = {}, jexport.marching_tetrahedra

    def capture(vol, level, **kw):
        seen["alpha"] = np.asarray(vol)
        return marching(vol, level, **kw)
    monkeypatch.setattr(jexport, "marching_tetrahedra", capture)
    jexport.export_density_mesh(jm, jp, str(tmp_path / "jax.ply"), grid_size=10, chunk_rows=3)
    want = seen["alpha"]
    calls = []

    def sphere(*args):
        calls.append(args[2].shape)
        return ops.PLAIN.chart_sphere(*args)
    tm.ops = ops.KERNELS._replace(chart_sphere=sphere)
    got = export.density_grid(tm, tm.params(), grid_size=10, chunk_rows=3).numpy()
    assert got.shape == want.shape == (10, 10, 10)
    assert ((want > 0.05) & (want < 0.95)).mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # a chunk is 3 x rows of 10 x 10 points: 30 rays of 10 depths
    assert calls == ([(30, 10)] * 3 + [(10, 10)] if chart == "generic_sphere" else [])
    verts, faces = export.export_density_mesh(tm, tm.params(), str(tmp_path / "port.ply"),
                                              grid_size=10, level=float(np.median(want)),
                                              chunk_rows=3)
    data = (tmp_path / "port.ply").read_bytes()
    assert f"element vertex {len(verts)}\n".encode() in data and len(faces) > 0
    assert np.all(verts >= tm.aabb[0] - 1e-6) and np.all(verts <= tm.aabb[1] + 1e-6)


def test_trainer_exports_the_mesh_at_the_end(tmp_path, monkeypatch):
    """``export_mesh`` is no longer refused: the trainer writes
    ``{expname}.ply`` after training, as JAX's does (after render_path,
    before render_test), by ``export_density_mesh(model, params, path)``
    with JAX's defaults; the spy here runs that call at a 24^3 grid."""
    calls = []

    def spy(model, params, path, **kw):
        calls.append((model, path, kw))
        return export.export_density_mesh(model, params, path, grid_size=24)
    monkeypatch.setattr(trainer_module, "export_density_mesh", spy)
    cfg = load_config(overrides=dict(
        dataset_name="synthetic", model_name="TensorVMSplit", coordinates_name="xyz",
        n_coarse=12, batch_size=256, n_iters=4, N_voxel_init=14 ** 3, N_voxel_final=14 ** 3,
        n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
        shadingMode="MLP_Fea", density_shift="-8", featureC=32, lr_init=0.02,
        near_far="[0.05, 8.5]", basedir=str(tmp_path), expname="mesh", N_vis=0,
        i_weights=10 ** 7, eval_chunk=256, progress_refresh_rate=1, render_test=False,
        export_mesh=1))
    trainer_module.check_supported(cfg)
    t = Trainer(cfg, device="cpu")
    t.train()
    assert len(calls) == 1 and calls[0][0] is t.model and calls[0][2] == {}
    path = os.path.join(t.logdir, "mesh.ply")
    assert calls[0][1] == path and open(path, "rb").read(4) == b"ply\n"
