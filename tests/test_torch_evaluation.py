"""The port's ``evaluation`` and ``evaluation_path`` against the JAX package's,
on the CPU: a tiny EgoNeRF (N_voxel 24^3, n_lamb 4/8, app_dim 12, featureC
32, 16 + 16 samples) given JAX's weights through ``params_from_jax``, the
procedural scene's test views at 16x32, each package writing into its own
folder.  Checked: the file names, ``mean.txt`` and ``mean.json``, and the
decoded PNGs."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.data.datasets import SyntheticEgoDataset as JaxSynthetic
from egonerf_tpu.models.egonerf import EgoNeRF as JaxEgoNeRF
from egonerf_tpu.models.egonerf import FieldConfig as JaxFieldConfig
from egonerf_tpu.render import renderer as jax_renderer
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.data.datasets import SyntheticEgoDataset
from egonerf_torch.data.png import decode
from egonerf_torch.models import EgoNeRF, FieldConfig, params_from_jax
from egonerf_torch.render import lpips
from egonerf_torch.render import renderer as torch_renderer

AABB = np.array([[-8.5] * 3, [8.5] * 3], np.float32)
NEAR_FAR = (0.05, 8.5)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2,
             fea_pe=2, feature_c=32)
RENDER = dict(n_coarse=16, n_fine=16)
SCENE = dict(n_train=2, n_test=3, height=16, width=32, near_far=NEAR_FAR)
CHUNK = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_no_lpips_weights(tmp_path_factory):
    """One intra-op thread (the suite runs in several worker processes), and
    an empty LPIPS weights folder, so both packages find no weights."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = os.environ.get("EGONERF_LPIPS_WEIGHTS_DIR")
    os.environ["EGONERF_LPIPS_WEIGHTS_DIR"] = str(tmp_path_factory.mktemp("no_lpips"))
    lpips._PARAM_CACHE.clear()
    yield
    torch.set_num_threads(n)
    if old is None:
        del os.environ["EGONERF_LPIPS_WEIGHTS_DIR"]
    else:
        os.environ["EGONERF_LPIPS_WEIGHTS_DIR"] = old


def _models(envmap: bool):
    shape = dict(SHAPE, use_envmap=True, envmap_res_h=5) if envmap else SHAPE
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    jm = JaxEgoNeRF(AABB, jc.resolution, jc, JaxFieldConfig(**shape), near_far=NEAR_FAR)
    tm = EgoNeRF(AABB, tc.resolution, tc, FieldConfig(**shape), near_far=NEAR_FAR,
                 device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm.load_state_dict(params_from_jax(jax_ckpt._flatten(jp), device="cpu"))
    return jm, jp, tm


def _datasets():
    return (JaxSynthetic(split="test", is_stack=True, **SCENE),
            SyntheticEgoDataset(split="test", is_stack=True, **SCENE))


def _run(tmp, envmap=False, **kw):
    """Both evaluations into tmp/jax and tmp/torch; (psnrs of each)."""
    jm, jp, tm = _models(envmap)
    jds, tds = _datasets()
    want = jax_renderer.evaluation(jds, jm, jp, jax_renderer.Renderer(jm, chunk=CHUNK, **RENDER),
                                   save_path=str(tmp / "jax"), **kw)
    got = torch_renderer.evaluation(tds, tm, tm.params(),
                                    torch_renderer.Renderer(tm, chunk=CHUNK, **RENDER),
                                    save_path=str(tmp / "torch"), **kw)
    return want, got


def _files(root):
    out = []
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out += [os.path.normpath(os.path.join(rel, f)) for f in files]
        out += [os.path.normpath(os.path.join(rel, x)) + "/" for x in dirs]
    return sorted(out)


def _png(path):
    with open(path, "rb") as f:
        return decode(f.read())


def _check_pngs(tmp):
    """Every PNG decodes to the same pixels within 1/255: the renders agree
    to ~1e-6, so a pixel may round to a neighbouring uint8 value."""
    for rel in _files(tmp / "jax"):
        if rel.endswith(".png"):
            a, b = _png(tmp / "jax" / rel).astype(int), _png(tmp / "torch" / rel).astype(int)
            assert a.shape == b.shape, rel
            assert np.abs(a - b).max() <= 1, rel


def _check_means(tmp, prefix=""):
    """mean.txt and mean.json: PSNR, WS-PSNR within rel 1e-5 and SSIM, WS-SSIM
    within abs 1e-6 (the same metrics of renders that differ by float32
    sums in another order, ~1e-7 on rgb); nan and null in the same places."""
    want = np.loadtxt(tmp / "jax" / f"{prefix}mean.txt")
    got = np.loadtxt(tmp / "torch" / f"{prefix}mean.txt")
    assert got.shape == want.shape == (5,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=0, atol=1e-6)
    with open(tmp / "jax" / f"{prefix}mean.json") as f:
        jw = json.load(f)
    with open(tmp / "torch" / f"{prefix}mean.json") as f:
        jg = json.load(f)
    assert list(jg) == list(jw)
    for k in jw:
        assert (jg[k] is None) == (jw[k] is None), k
        if jw[k] is None:
            continue
        if k in ("psnr", "ws_psnr"):
            assert jg[k] == pytest.approx(jw[k], rel=1e-5), k
        else:
            assert jg[k] == pytest.approx(jw[k], rel=0, abs=1e-6), k
    return jg


@pytest.fixture(scope="module")
def indoor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("indoor")
    return tmp, *_run(tmp, prefix="t_")


def test_indoor_writes_jax_files(indoor):
    tmp, want, got = indoor
    assert _files(tmp / "torch") == _files(tmp / "jax")
    assert "t_000.png" in _files(tmp / "torch") and "rgbd/t_002.png" in _files(tmp / "torch")
    assert "t_mean.json" in _files(tmp / "torch")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_indoor_means_and_pixels(indoor):
    tmp, _, _ = indoor
    summary = _check_means(tmp, "t_")
    # every metric but LPIPS, which has no weights file on either side
    assert summary["lpips_alex"] is None and summary["lpips_vgg"] is None
    assert all(summary[k] is not None for k in ("ssim", "ws_ssim", "ws_psnr"))
    assert summary["n_images"] == 3
    row = np.loadtxt(tmp / "torch" / "t_mean.txt")
    assert np.isnan(row[3:]).all() and np.isfinite(row[:3]).all()
    _check_pngs(tmp)
    rgbd = _png(tmp / "torch" / "rgbd" / "t_000.png")
    assert rgbd.shape == (16, 64, 3)


def test_pngs_are_to_uint8_of_the_render(indoor):
    """The written rgb is ``to_uint8`` of the view the Renderer gives, and
    the rgbd image that rgb beside ``visualize_depth`` over near/far."""
    from egonerf_torch.render.viz import to_uint8, visualize_depth

    tmp, _, _ = indoor
    _, _, tm = _models(False)
    _, tds = _datasets()
    r = torch_renderer.Renderer(tm, chunk=CHUNK, **RENDER)
    r.set_directions(tds.directions)
    out = r.render_view(tm.params(), tds.poses[1])
    rgb = to_uint8(out["rgb"].reshape(16, 32, 3).numpy())
    depth, _ = visualize_depth(out["depth"].reshape(16, 32).numpy(), tds.near_far)
    np.testing.assert_array_equal(_png(tmp / "torch" / "t_001.png"), rgb)
    np.testing.assert_array_equal(_png(tmp / "torch" / "rgbd" / "t_001.png"),
                                  np.concatenate([rgb, depth], axis=1))


@pytest.fixture(scope="module")
def outdoor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("outdoor")
    return tmp, *_run(tmp, envmap=True)


def test_envmap_writes_envmap_and_bg(outdoor):
    tmp, want, got = outdoor
    files = _files(tmp / "torch")
    assert files == _files(tmp / "jax")
    assert {"envmap.png", "000_bg.png", "001_bg.png", "002_bg.png"} <= set(files)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_means(tmp)
    _check_pngs(tmp)


def test_envmap_only_writes_pretrained_envmap(tmp_path):
    want, got = _run(tmp_path, envmap=True, envmap_only=True)
    assert want == got == []
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax") == [
        "pretrained_envmap.png", "rgbd/"]
    _check_pngs(tmp_path)


def test_without_extra_metrics_and_n_vis(tmp_path):
    """``compute_extra_metrics=False`` leaves SSIM, WS-SSIM and WS-PSNR out
    (nan, null); ``n_vis`` 1 of 3 views renders view 0 only."""
    want, got = _run(tmp_path, n_vis=1, prefix="v_", compute_extra_metrics=False)
    assert len(got) == len(want) == 1
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert "v_001.png" not in _files(tmp_path / "torch")
    summary = _check_means(tmp_path, "v_")
    assert summary["ssim"] is None and summary["ws_psnr"] is None
    assert np.isnan(np.loadtxt(tmp_path / "torch" / "v_mean.txt")[1:]).all()
    _check_pngs(tmp_path)


def test_n_vis_zero_writes_nothing(tmp_path):
    want, got = _run(tmp_path, n_vis=0)
    assert want == got == []
    assert not os.path.exists(tmp_path / "torch") and not os.path.exists(tmp_path / "jax")


def test_host_rays_and_no_overlap_give_the_same_outputs(indoor, tmp_path):
    """A dataset without a direction grid renders from its rays; the
    evaluation without the worker thread writes the same bytes."""
    src, _, _ = indoor
    _, _, tm = _models(False)
    _, tds = _datasets()
    tds.directions = None
    torch_renderer.evaluation(tds, tm, tm.params(),
                              torch_renderer.Renderer(tm, chunk=CHUNK, **RENDER),
                              save_path=str(tmp_path), prefix="t_", overlap=False)
    assert _files(tmp_path) == _files(src / "torch")
    for rel in _files(tmp_path):
        if rel.endswith(".png"):
            a, b = _png(tmp_path / rel).astype(int), _png(src / "torch" / rel).astype(int)
            # rays made on the host and on the device differ in last bits
            assert np.abs(a - b).max() <= 1, rel
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t_mean.txt")[:3],
                               np.loadtxt(src / "torch" / "t_mean.txt")[:3], rtol=1e-5)


def test_evaluation_path_frames(tmp_path, capsys):
    """The trajectory's frames and rgbd frames, as JAX writes them; no mp4
    without an ffmpeg-backed writer, and JAX's line says so."""
    jm, jp, tm = _models(False)
    jds, tds = _datasets()
    c2ws = np.concatenate([tds.poses, tds.poses[:1]])
    want = jax_renderer.evaluation_path(jds, jm, jp, c2ws,
                                        jax_renderer.Renderer(jm, chunk=CHUNK, **RENDER),
                                        save_path=str(tmp_path / "jax"), prefix="p_")
    jax_out = capsys.readouterr().out
    got = torch_renderer.evaluation_path(tds, tm, tm.params(), c2ws,
                                         torch_renderer.Renderer(tm, chunk=CHUNK, **RENDER),
                                         save_path=str(tmp_path / "torch"), prefix="p_")
    torch_out = capsys.readouterr().out
    files = _files(tmp_path / "torch")
    assert files == _files(tmp_path / "jax")
    assert "p_003.png" in files and "rgbd/p_003.png" in files
    assert not any(f.endswith(".mp4") for f in files)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.abs(g.astype(int) - w.astype(int)).max() <= 1
    assert "video export skipped" in jax_out and "video export skipped" in torch_out
    _check_pngs(tmp_path)


def test_evaluation_path_without_dataset_directions(tmp_path):
    """Without the dataset's grid the path renders the normalised
    equirectangular directions: the same frames as with the grid."""
    _, _, tm = _models(False)
    _, tds = _datasets()
    r = torch_renderer.Renderer(tm, chunk=CHUNK, **RENDER)
    with_grid = torch_renderer.evaluation_path(tds, tm, tm.params(), tds.poses[:1], r)
    tds.directions = None
    without = torch_renderer.evaluation_path(tds, tm, tm.params(), tds.poses[:1], r)
    np.testing.assert_array_equal(without[0], with_grid[0])


def test_trainer_writes_vis_path_and_test_outputs(tmp_path):
    """The trainer's events: the vis render without the extra metrics (as
    JAX's ``vis_list`` call), the trajectory into ``imgs_path_all`` when the
    test dataset has one, and the final test render with every metric."""
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer
    from test_torch_train import _tiny_cfg

    cfg = load_config(overrides=_tiny_cfg(tmp_path, n_iters=4, vis_list="[4]", render_path=1,
                                          render_test=1))
    trainer = Trainer(cfg, device="cpu")
    trainer.test_dataset.render_path = trainer.test_dataset.poses[:2]
    trainer.train()
    vis = json.load(open(os.path.join(trainer.logdir, "imgs_vis", "000003_mean.json")))
    assert vis["psnr"] is not None and vis["ssim"] is None and vis["ws_psnr"] is None
    assert _files(tmp_path / "e2e" / "imgs_path_all") == ["000.png", "001.png", "rgbd/",
                                                          "rgbd/000.png", "rgbd/001.png"]
    test = json.load(open(os.path.join(trainer.logdir, "imgs_test_all", "mean.json")))
    assert test["ssim"] is not None and test["ws_ssim"] is not None and test["n_images"] == 2
    assert test["lpips_alex"] is None
