"""The port's real-data pipeline (``egonerf_torch/tools/fetch_data.py``,
``real_data_run.py``) against the JAX package's, on the CPU.

JAX's five tests of the pair (``tests/test_realdata.py``) run against the
port.  The scene table, the scene folders, the shipped configs (with the
overrides the pipeline applies) and ``is_present`` are held equal to
JAX's; the one departure, ``imgs/`` (the egocentric loader's folder), is
pinned on a capture of the port's writer.  The pipeline runs once at a
tiny width on the CPU (the plain versions).  No test reaches the network:
``gdown`` cannot be imported and ``urllib.request.urlopen`` raises."""
import dataclasses
import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from egonerf_tpu.data.datasets import EgocentricVideoDataset as JaxEgocentricVideoDataset
from egonerf_tpu.tools import fetch_data as jax_fetch
from egonerf_tpu.tools import real_data_run as jax_run
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch import tools
from egonerf_torch.tools import fetch_data, real_data_run
from egonerf_torch.tools.make_egocentric_capture import make_capture
from egonerf_torch.train.trainer import check_supported

# the record's keys in JAX's real_data_run (egonerf_tpu/tools/real_data_run.py:77-83)
JAX_RECORD_KEYS = {"scene", "collection", "config", "n_iters", "final_test_psnr", "metrics",
                   "wall_s", "artifacts"}
# the barbershop config cut to a tiny width on the CPU, its loader reading
# 64x32 frames (OmniBlender's 2000x1000 downsampled)
TINY = dict(downsample_train=2000 / 64, downsample_test=2000 / 64, N_voxel_init=24 ** 3,
            N_voxel_final=24 ** 3, n_coarse=16, n_fine=16, featureC=32,
            n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
            batch_size=256, eval_chunk=1024, progress_refresh_rate=1)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """``gdown`` absent and every URL unreachable at once."""
    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setitem(sys.modules, "gdown", None)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- JAX's five tests (tests/test_realdata.py:13-44) against the port ------

def test_every_scene_has_a_config():
    assert len(fetch_data.DATASETS) == 22
    for scene in fetch_data.DATASETS:
        assert os.path.exists(real_data_run.config_for(scene)), scene


def test_absent_scene_detected(tmp_path):
    assert not fetch_data.is_present("barbershop", str(tmp_path))
    t0 = time.time()
    assert fetch_data.main(["barbershop", "--dest", str(tmp_path)]) == 3
    assert time.time() - t0 < 5  # the probe's 10 s timeout never runs


def test_present_scene_detected(tmp_path):
    (tmp_path / "OmniBlender" / "barbershop" / "images").mkdir(parents=True)
    assert fetch_data.is_present("barbershop", str(tmp_path))
    assert fetch_data.main(["barbershop", "--dest", str(tmp_path)]) == 0


def test_pipeline_skips_cleanly_without_data(tmp_path, capsys):
    """Exit 3 with the fetch hint; no card is asked for (this host has
    none, and the absent scene returns before the device is resolved)."""
    assert real_data_run.main(["barbershop", "--dest", str(tmp_path)]) == 3
    out = capsys.readouterr().out
    assert "egonerf_torch.tools.fetch_data barbershop" in out
    assert not (tmp_path / "OmniBlender").exists()


def test_unknown_scene_rejected(tmp_path):
    with pytest.raises(SystemExit) as got:
        fetch_data.main(["no_such_scene", "--dest", str(tmp_path)])
    with pytest.raises(SystemExit) as want:
        jax_fetch.main(["no_such_scene", "--dest", str(tmp_path)])
    assert str(got.value) == str(want.value)


# -- the tables, the configs and is_present against JAX's --------------------

def test_tables_match_jax():
    assert fetch_data.DATASETS == jax_fetch.DATASETS
    assert fetch_data.DRIVE_FOLDER == jax_fetch.DRIVE_FOLDER


@pytest.mark.parametrize("scene", sorted(jax_fetch.DATASETS))
def test_scene_config_matches_jax(scene):
    """Each shipped scene config resolves to the same ``Config`` in both
    packages under the pipeline's overrides (JAX's ``real_data_run.main``:
    ``datadir``, ``render_test``, and ``n_iters`` with ``--iters``), and
    the port's trainer accepts it."""
    assert fetch_data.scene_dir(scene) == jax_fetch.scene_dir(scene)
    assert fetch_data.scene_dir(scene, "d") == jax_fetch.scene_dir(scene, "d")
    assert real_data_run.config_for(scene) == jax_run.config_for(scene)
    for iters in (None, 20):
        ov = {"datadir": jax_fetch.scene_dir(scene), "render_test": True}
        if iters is not None:
            ov["n_iters"] = iters
        want = dataclasses.asdict(jax_load_config(jax_run.config_for(scene), overrides=ov))
        cfg = real_data_run.scene_config(scene, iters=iters)
        assert dataclasses.asdict(cfg) == want
        check_supported(cfg)


@pytest.mark.parametrize("entry", ["images", "image", "transforms.json", "cam_models", "poses",
                                   "(empty)", "(missing)"])
def test_is_present_matches_jax(tmp_path, entry):
    """JAX's five entries (each alone), an empty scene folder and a missing
    one: the same answer in both packages."""
    d = tmp_path / "Ricoh360" / "bricks"
    if entry != "(missing)":
        d.mkdir(parents=True)
    if entry == "transforms.json":
        (d / entry).write_text("{}")
    elif not entry.startswith("("):
        (d / entry).mkdir()
    got = fetch_data.is_present("bricks", str(tmp_path))
    assert got == jax_fetch.is_present("bricks", str(tmp_path))
    assert got == (not entry.startswith("("))


def test_is_present_takes_the_egocentric_capture(tmp_path, capsys):
    """The departure: a Ricoh-layout capture (``imgs/``, the pose files and
    the splits) that both packages' loaders read is absent to JAX's
    ``is_present`` (so its pipeline exits 3 on it) and present to the
    port's."""
    cap = tmp_path / "Ricoh360" / "garden"
    make_capture(str(cap), n_frames=4, height=16, n_test=2)
    assert sorted(os.listdir(cap)) == ["imgs", "openvslam", "output_dir", "test.txt",
                                       "train.txt"]
    ds = JaxEgocentricVideoDataset(data_dir=str(cap), split="train", downsample=1920 / 32,
                                   near_far=(0.05, 9.0))
    assert ds.all_rays.shape[0] == 2 * 16 * 32
    assert not jax_fetch.is_present("garden", str(tmp_path))
    assert jax_run.main(["garden", "--dest", str(tmp_path)]) == 3
    assert fetch_data.is_present("garden", str(tmp_path))
    assert fetch_data.main(["garden", "--dest", str(tmp_path)]) == 0
    assert "present" in capsys.readouterr().out


# -- the pipeline ----------------------------------------------------------

def test_pipeline_on_the_cpu(tmp_path):
    """The barbershop config at a tiny width on a 4-frame 64x32
    OmniBlender-layout scene, 3 iterations on the CPU through the keyword
    entry: rc 0, JAX's record keys plus ``device``, the test PSNR that of
    ``mean.json``, the record where it was sent and nowhere in
    ``docs/torch``.  PSNR is not compared with JAX's: the random streams
    differ."""
    chip_smoke.make_omniblender_scene(str(tmp_path / "OmniBlender" / "barbershop"), 4, 2,
                                      (32, 64))
    dest = tmp_path / "out" / "record.json"
    default = tools.results_path("real_barbershop")
    existed = os.path.exists(default)
    t0 = time.time()
    rc = real_data_run.run("barbershop", str(tmp_path), iters=3, device="cpu",
                           results=str(dest), basedir=str(tmp_path / "log"), **TINY)
    assert time.time() - t0 < 20
    assert rc == 0
    rec = json.loads(dest.read_text())
    assert set(rec) == JAX_RECORD_KEYS | {"device"}
    assert (rec["scene"], rec["collection"], rec["n_iters"], rec["device"]) == (
        "barbershop", "OmniBlender", 3, "cpu")
    assert rec["config"] == tools.rel(real_data_run.config_for("barbershop"))
    logdir = tmp_path / "log" / "EgoNeRF"
    assert rec["artifacts"] == str(logdir)
    mean = json.loads((logdir / "imgs_test_all" / "mean.json").read_text())
    assert rec["metrics"] == mean and mean["n_images"] == 2
    assert np.isfinite(rec["final_test_psnr"])
    assert abs(rec["final_test_psnr"] - mean["psnr"]) <= 1e-3
    assert os.path.exists(default) == existed


def test_main_defaults_to_the_card(monkeypatch, tmp_path):
    """A present scene through the command line asks for the card and
    raises without one."""
    (tmp_path / "OmniBlender" / "barbershop" / "images").mkdir(parents=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        real_data_run.main(["barbershop", "--dest", str(tmp_path)])


@pytest.mark.parametrize("argv, want", [
    ([], ("barbershop", "data", None)),
    (["garden"], ("garden", "data", None)),
    (["--iters", "20", "garden", "--dest", "d"], ("garden", "d", 20)),
    (["LOU", "--dest", "d", "--iters", "7"], ("LOU", "d", 7)),
])
def test_command_line_reads_jax_arguments(monkeypatch, argv, want):
    """``scene``, ``--iters N`` and ``--dest DIR`` in any order, JAX's
    defaults; nothing else reaches the keyword entry."""
    seen = []
    monkeypatch.setattr(real_data_run, "run", lambda *a, **kw: seen.append((a, kw)) or 0)
    assert real_data_run.main(argv) == 0
    assert seen == [(want, {})]
