"""The port's quality-record tools (``egonerf_torch/tools``: quality_run,
sampler_ab, f32_ab, seed_variance, seed_ab, cull_ab, envmap_probe, occ_probe,
eval_bench, refscale_drift, sweep, and ``results_path``) against the JAX
package's (``egonerf_tpu/tools``), on the CPU.

The configs and parsers are held equal.  The probes and the bench run in
both packages on one tiny checkpoint that the port's trainer writes in the
JAX format (EgoNeRF with the envmap on the procedural ``env`` scene: N_voxel
24^3, n_lamb 4/8, app_dim 12, featureC 32, 16 + 16 samples, views at
80x40, 60 steps, the mask at ``alpha_mask_thre`` 2e-3 so that it holds
part of the volume), each package rendering with its own code.  Each
tolerance is stated where it is used."""
import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from egonerf_tpu import tools as jax_tools
from egonerf_tpu.tools import envmap_probe as jax_envmap_probe
from egonerf_tpu.tools import eval_bench as jax_eval_bench
from egonerf_tpu.tools import occ_probe as jax_occ_probe
from egonerf_tpu.tools import quality_run as jax_quality_run
from egonerf_tpu.tools import refscale_drift as jax_drift
from egonerf_tpu.tools import sampler_ab as jax_sampler_ab
from egonerf_tpu.tools import seed_ab as jax_seed_ab
from egonerf_tpu.tools import sweep as jax_sweep
from egonerf_torch import tools
from egonerf_torch.data.datasets import SyntheticEgoDataset
from egonerf_torch.tools import (envmap_probe, eval_bench, occ_probe, quality_run,
                                 refscale_drift, sampler_ab, seed_ab, seed_variance, sweep)
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer

SCENE = dict(n_train=2, n_test=1, height=40, width=80)
TINY_RUN = dict(
    dataset_name="synthetic", model_name="EgoNeRF", coordinates_name="yinyang",
    exp_sampling=True, interval_th=True, r0="0.05", resampling=True, use_coarse_sample=True,
    n_coarse=16, n_fine=16, batch_size=256, n_iters=60, N_voxel_init=24 ** 3,
    N_voxel_final=24 ** 3, n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
    shadingMode="MLP_Fea", featureC=32, view_pe=2, fea_pe=2, lr_init=0.02, sparsity_lambda=0,
    near_far="[0.01, 15.0]", density_shift="-8", alpha_mask_thre=2e-3, use_envmap=True, envmap_res_H=16,
    iter_pretrain_envmap=10, progress_refresh_rate=20, expname="tiny", N_vis=-1,
    vis_list="[60]", i_weights=10 ** 7, eval_chunk=512, render_test=True)
# the A/B runner at JAX's test shape (tests/test_tools.py:192-218)
TINY_AB = dict(N_voxel_init=27_000, N_voxel_final=27_000, n_lamb_sigma=[4, 4, 4],
               n_lamb_sh=[8, 8, 8], n_coarse=16, n_fine=16, batch_size=256, steps_per_call=2,
               eval_chunk=2048)
AB_SHAPE = dict(N_ITERS=8, VIS_EVERY=4, N_TRAIN=2, N_TEST=1, IMG_H=40, IMG_W=80)


def _fields(cfg) -> dict:
    """A config's fields but ``basedir``: the port's tools train under the
    repository's ``build/``, JAX's under /tmp."""
    d = dataclasses.asdict(cfg)
    d.pop("basedir")
    return d


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- quality_run -----------------------------------------------------------

@pytest.mark.parametrize("preset", quality_run.PRESETS)
def test_preset_spec_matches_jax(preset):
    """Every config field (but basedir) and the dataset kwargs of each
    preset equal JAX's."""
    cfg, ds = quality_run.preset_spec(preset)
    jcfg, jds = jax_quality_run.preset_spec(preset)
    assert _fields(cfg) == _fields(jcfg)
    assert ds == jds
    assert cfg.basedir == os.path.join(tools.RUNS_DIR, "quality")


def test_preset_deltas_win_and_unknown_preset_raises_as_jax():
    """A config delta wins over the preset (phase 35 cuts a run so); an
    unknown preset raises JAX's SystemExit with its message."""
    cfg, _ = quality_run.preset_spec("refscale", n_iters=123, basedir="/x")
    assert cfg.n_iters == 123 and cfg.basedir == "/x"
    assert cfg.vis_list == jax_quality_run.preset_spec("refscale")[0].vis_list
    with pytest.raises(SystemExit) as got:
        quality_run.preset_spec("nope")
    with pytest.raises(SystemExit) as want:
        jax_quality_run.preset_spec("nope")
    assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit):
        quality_run._run("nope", device="cpu")


# -- sampler_ab, f32_ab, seed_ab, seed_variance -----------------------------

ARMS = ([(name, method, dev, {}) for name, method, dev in sampler_ab.VARIANTS]
        + [("device_uniform_f32", "simple", True, dict(compute_dtype="float32"))]
        + [(f"{arm}_s1", spec["method"], spec["device_sampling"],
            dict({k: v for k, v in spec.items() if k not in ("method", "device_sampling")},
                 seed=1, n_iters=1500, vis_list="[1500]")) for arm, spec in seed_ab.ARMS]
        + [("seed2_wall", "simple", True, dict(seed=2))])


@pytest.mark.parametrize("arm", ARMS, ids=lambda a: a[0])
def test_ab_configs_match_jax(arm):
    """sampler_ab's variants, f32_ab's arm, seed_ab's arms and a
    seed_variance seed build JAX's config (every field but basedir)."""
    name, method, dev, extra = arm
    assert _fields(sampler_ab.make_config(name, method, dev, **extra)) == _fields(
        jax_sampler_ab.make_config(name, method, dev, **extra))


def test_ab_tables_match_jax():
    assert sampler_ab.VARIANTS == jax_sampler_ab.VARIANTS
    assert [a for a, _ in seed_ab.ARMS] == [a for a, _ in jax_seed_ab.ARMS]
    assert [s for _, s in seed_ab.ARMS] == [s for _, s in jax_seed_ab.ARMS]
    for k in AB_SHAPE:
        assert getattr(sampler_ab, k) == getattr(jax_sampler_ab, k)


def test_run_variant_matches_jax(monkeypatch, tmp_path, capsys):
    """run_variant at JAX's test shape (8 steps, views at 80x40, an
    evaluation every 4): the record's keys and the steps of its PSNR curve
    are JAX's; a second call removes the first's folder and trains again
    (no resume), to the same curve (one seed, CPU arithmetic)."""
    for k, v in AB_SHAPE.items():
        monkeypatch.setattr(sampler_ab, k, v)
        monkeypatch.setattr(jax_sampler_ab, k, v)
    args = ("tk24_cluttered", "simple", True)
    kw = dict(scene="cluttered", train_keep=24, **TINY_AB)
    want = jax_sampler_ab.run_variant(*args, basedir=str(tmp_path / "jax"), **kw)
    got = sampler_ab.run_variant(*args, basedir=str(tmp_path / "port"), device="cpu", **kw)
    assert set(got) == set(want)
    assert sorted(got["psnr_by_iter"]) == sorted(want["psnr_by_iter"]) == [4, 8]
    assert all(v > 0 for v in got["psnr_by_iter"].values())
    capsys.readouterr()
    again = sampler_ab.run_variant(*args, basedir=str(tmp_path / "port"), device="cpu", **kw)
    assert "resuming" not in capsys.readouterr().out
    assert again["psnr_by_iter"] == got["psnr_by_iter"]


def _sampler_record(path, variant, psnr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"runs": [{"variant": "other", "psnr_by_iter": {"3000": 1.0}},
                            {"variant": variant, "psnr_by_iter": {"3000": psnr}}]}, f)


def test_seed_variance_takes_seed_0_from_the_ports_record(monkeypatch, tmp_path):
    """seed 0's PSNR is the port's sampler_ab device-uniform run, read from
    the record; without the record seed 0 runs (JAX writes in its TPU
    figure instead)."""
    monkeypatch.setattr(tools, "RESULTS_DIR", str(tmp_path))
    assert seed_variance.seed0_psnr() is None
    _sampler_record(tools.results_path("sampler_ab"), seed_variance.SEED0_VARIANT, 37.5)
    assert seed_variance.seed0_psnr() == 37.5

    ran = []

    def fake_run(name, method, device_sampling, scene="wall", device="cuda", **extra):
        ran.append(extra["seed"])
        return {"variant": name, "psnr_by_iter": {3000: 30.0 + extra["seed"]}}

    monkeypatch.setattr(sampler_ab, "run_variant", fake_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(seed_variance, "device_name", lambda d: "card")
    seed_variance.main(["1,2"])
    with open(tools.results_path("seed_variance")) as f:
        rec = json.load(f)
    assert ran == [1, 2]
    assert rec["psnr_3k_all_seeds"] == [31.0, 32.0, 37.5] and rec["spread_db"] == 6.5
    os.remove(tools.results_path("sampler_ab"))
    ran.clear()
    seed_variance.main(["1,2"])
    with open(tools.results_path("seed_variance")) as f:
        rec = json.load(f)
    assert ran == [0, 1, 2]
    assert rec["seed0_reference_psnr_3k"] == 30.0
    assert rec["psnr_3k_all_seeds"] == [31.0, 32.0, 30.0] and rec["spread_db"] == 2.0


def test_seed_ab_merges_and_stops_at_the_deadline(monkeypatch, tmp_path):
    """seed_ab's merge-on-write keeps an earlier invocation's runs and
    replaces a rerun arm; EGONERF_DEADLINE_TS stops before an arm that
    would end past it, writing what completed (JAX's ``_write``)."""
    monkeypatch.setattr(tools, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(seed_ab, "device_name", lambda d: "card")

    def fake_run(name, method, device_sampling, device="cuda", **extra):
        return {"variant": name, "psnr_by_iter": {extra["n_iters"]: float(extra["seed"])}}

    monkeypatch.setattr(sampler_ab, "run_variant", fake_run)
    seed_ab.main(["0", "10"])
    with open(tools.results_path("seed_ab")) as f:
        rec = json.load(f)
    assert [(r["arm"], r["seed"]) for r in rec["runs"]] == sorted(
        (a, 0) for a, _ in seed_ab.ARMS)
    assert rec["device"] == "card" and rec["n_iters"] == 10
    monkeypatch.setenv("EGONERF_DEADLINE_TS", "1")  # long past
    seed_ab.main(["1", "10"])
    with open(tools.results_path("seed_ab")) as f:
        assert json.load(f)["seeds"] == [0]
    monkeypatch.delenv("EGONERF_DEADLINE_TS")
    seed_ab.main(["1", "10"])
    with open(tools.results_path("seed_ab")) as f:
        assert json.load(f)["seeds"] == [0, 1]


# -- cull_ab -------------------------------------------------------------------

CULL_ARGV = ([], ["192,128", "--scene=cluttered"], ["128", "--full_every=4"],
             ["192,128", "--tau=1"], ["--scene=cluttered", "--no_baseline"],
             ["0,128", "--scene=cluttered"], ["64", "--full_every=2", "--tau=0.5", "--bogus"])


def _fake_run_variant(calls: list):
    def run_variant(name, method, device_sampling, scene="wall", **extra):
        calls.append((name, method, device_sampling, scene, extra))
        return {"variant": name, "sampling_method": method, "device_sampling": device_sampling,
                "scene": scene, "psnr_by_iter": {3000: 30.0 + extra["train_keep"] / 100},
                "wall_s": 1.0}
    return run_variant


@pytest.mark.parametrize("argv", CULL_ARGV, ids=lambda a: " ".join(a) or "none")
def test_cull_ab_main_matches_jax(monkeypatch, argv):
    """JAX's ``main`` (its ``sys.argv``) and the port's on one argument
    list, each with a faked ``run_variant`` and its ``write_results``
    captured: the same ``run_variant`` calls (tags and keyword arguments;
    the port's also names the card), the same record name, and the same
    record but for the port's ``device`` and its ``baseline``, which names
    the port's own sampler_ab record."""
    from egonerf_tpu.tools import cull_ab as jax_cull_ab
    from egonerf_torch.tools import cull_ab

    calls = {"jax": [], "port": []}
    written = {}
    monkeypatch.setattr(jax_tools, "require_tpu_relay", lambda: None)
    monkeypatch.setattr(jax_tools, "write_results",
                        lambda name, rec: written.setdefault("jax", (name, rec)))
    monkeypatch.setattr(jax_sampler_ab, "run_variant", _fake_run_variant(calls["jax"]))
    monkeypatch.setattr("sys.argv", ["cull_ab.py", *argv])
    jax_cull_ab.main()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cull_ab, "device_name", lambda d: "card")
    monkeypatch.setattr(cull_ab, "write_results",
                        lambda name, rec: written.setdefault("port", (name, rec)))
    monkeypatch.setattr(sampler_ab, "run_variant", _fake_run_variant(calls["port"]))
    cull_ab.main(list(argv))

    devices = [extra.pop("device") for *_, extra in calls["port"]]
    assert devices == [torch.device("cuda")] * len(calls["jax"])
    assert calls["port"] == calls["jax"] and calls["jax"]
    (jax_name, want), (name, got) = written["jax"], written["port"]
    assert name == jax_name
    assert tools.results_path(name) != jax_tools.results_path(jax_name)
    assert set(got) == set(want) | {"device"} and got["device"] == "card"
    assert got["baseline"] == cull_ab.BASELINE and "docs/torch/results_sampler_ab.json" in (
        got["baseline"])
    assert {k: v for k, v in got.items() if k not in ("device", "baseline")} == {
        k: v for k, v in want.items() if k != "baseline"}


def test_cull_ab_run_trains_the_culled_steps(monkeypatch, tmp_path):
    """``run`` on the CPU at JAX's test shape (8 steps, an evaluation every
    4): the cluttered scene takes a keep-0 run first; each run's PSNRs are
    above 0; the culled run's forward gets ``train_keep`` 24 on the odd
    steps and no cull on every second step (``full_every`` 2), the keep-0
    run none on any; nothing is written into the records' folder."""
    from egonerf_torch.models.egonerf import EgoNeRF
    from egonerf_torch.tools import cull_ab

    for k, v in AB_SHAPE.items():
        monkeypatch.setattr(sampler_ab, k, v)
    monkeypatch.setattr(tools, "RESULTS_DIR", str(tmp_path / "records"))
    keeps = []
    forward = EgoNeRF.forward

    def counting_forward(self, *args, **kw):
        if kw.get("is_train"):
            keeps.append(kw.get("train_keep", 0))
        return forward(self, *args, **kw)

    monkeypatch.setattr(EgoNeRF, "forward", counting_forward)
    rec = cull_ab.run([24], scene="cluttered", full_every=2, device="cpu",
                      basedir=str(tmp_path / "runs"), **TINY_AB)
    assert set(rec) == {"protocol", "scene", "train_keep_full_every", "train_cull_tau",
                        "baseline", "device", "runs"}
    assert rec["device"] == "cpu" and rec["scene"] == "cluttered"
    assert [(r["variant"], r["train_keep"], r["train_keep_full_every"], r["train_cull_tau"])
            for r in rec["runs"]] == [("tk0_cluttered", 0, 0, 0.0),
                                      ("tk24fe2_cluttered", 24, 2, 0.0)]
    for r in rec["runs"]:
        assert sorted(r["psnr_by_iter"]) == [4, 8]
        assert all(v > 0 for v in r["psnr_by_iter"].values())
    n = AB_SHAPE["N_ITERS"]
    assert keeps == [0] * n + [0 if it % 2 == 0 else 24 for it in range(n)]
    assert not os.path.exists(tools.RESULTS_DIR)


# -- the probes and the bench on one tiny checkpoint --------------------------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The port's trainer on the ``env`` scene: its logdir (args.txt, the
    JAX-format checkpoint, imgs_test_all/) and the test PSNRs."""
    base = tmp_path_factory.mktemp("tiny")
    cfg = load_config(overrides=dict(TINY_RUN, basedir=str(base)))
    trainer = Trainer(cfg, device="cpu")
    scene = dict(SCENE, background="env", near_far=cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", **scene),
                         SyntheticEgoDataset(split="test", is_stack=True, **scene))
    psnrs = trainer.train()
    return trainer.logdir, psnrs


def _same_keys(got: dict, want: dict):
    """The port's record has JAX's keys and ``device``."""
    assert set(got) == set(want) | {"device"}, (sorted(got), sorted(want))
    assert got["device"] == "cpu"


def test_envmap_probe_functions_match_jax():
    """envmap_vs_gt_psnr on seeded emissions (and JAX's own two cases) and
    bg_fg_split on seeded arrays: within 1e-4 dB of JAX's (the float32
    envmap lookup in another order; bg_fg_split rounds to 0.01 dB, so its
    dicts are equal)."""
    from egonerf_tpu.data.synthetic import _wall_color

    rng = np.random.default_rng(0)
    h = 64
    vi = np.linspace(0.0, 1.0, 2 * h)[:, None]
    ui = np.linspace(0.0, 1.0, h)[None, :]
    cos_t = 2.0 * ui - 1.0
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t ** 2))
    phi = 2.0 * np.pi * vi - np.pi
    dirs = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi),
                     np.broadcast_to(cos_t, (2 * h, h))], axis=-1)
    tex = np.clip(_wall_color(dirs), 1e-4, 1.0 - 1e-4)
    emissions = [np.log(tex / (1.0 - tex)).astype(np.float32),
                 np.zeros((2 * h, h, 3), np.float32)]
    emissions += [rng.normal(size=(2 * n, n, 3)).astype(np.float32) for n in (8, 33)]
    for em in emissions:
        for hw in ((32, 64), (25, 50)):
            got = envmap_probe.envmap_vs_gt_psnr(em, *hw)
            want = jax_envmap_probe.envmap_vs_gt_psnr(em, *hw)
            assert abs(got - want) <= 1e-4, (got, want)
    assert envmap_probe.envmap_vs_gt_psnr(emissions[0], 32, 64) > 20.0
    for shape in ((4, 4), (40, 80)):
        render = rng.uniform(size=shape + (3,))
        gt = rng.uniform(size=shape + (3,))
        bg = rng.uniform(size=shape) < 0.3
        bg.flat[0], bg.flat[1] = True, False
        assert envmap_probe.bg_fg_split(render, gt, bg) == jax_envmap_probe.bg_fg_split(
            render, gt, bg)


def test_envmap_probe_run_matches_jax(tiny_run):
    """The record of the tiny envmap run: the same PNGs decoded (the port's
    codec, JAX's imageio), so the split is equal; the envmap's PSNR within
    1e-4 dB (rounded to 0.01 by both, so equal here)."""
    logdir, _ = tiny_run
    got = envmap_probe._run(logdir, device="cpu", **SCENE)
    want = jax_envmap_probe._run(logdir, **SCENE)
    _same_keys(got, want)
    assert got["per_image"] == want["per_image"]
    assert got["envmap_res"] == want["envmap_res"] == [32, 16]
    assert abs(got["envmap_only_psnr_vs_gt_texture"]
               - want["envmap_only_psnr_vs_gt_texture"]) <= 1e-4
    assert got["checkpoint"] == want["checkpoint"]


def _valid_sizes(n_rays_image: int, n_images: int, chunk: int) -> list:
    return [min(chunk, n_rays_image - c0) for _ in range(n_images)
            for c0 in range(0, n_rays_image, chunk)]


@pytest.mark.parametrize("chunk", [512, 4096])
def test_occ_probe_matches_jax(tiny_run, monkeypatch, chunk):
    """occ_probe's record and per-ray counts on the tiny run, every ray
    included (3,200 rays: 7 chunks of at most 512, or one).  The port's
    chain (K7, K3, K4 with its fine chart, K9) matches eager JAX; JAX jits
    this chain, and XLA's fused arithmetic moves a merged point by a last
    bit, which flips a sample on a mask cell's edge: at most 1% of the
    rays may count otherwise, by at most 2 samples, and the record's
    fractions stay within 0.01."""
    logdir, _ = tiny_run
    port_k, jax_k = [], []
    real = occ_probe.occupied_per_ray

    def record(*a, **kw):
        k = real(*a, **kw)
        port_k.append(k.numpy())
        return k

    monkeypatch.setattr(occ_probe, "occupied_per_ray", record)
    real_jit = jax.jit

    def jit(f, *args, **kwargs):
        g = real_jit(f, *args, **kwargs)
        if getattr(f, "__name__", "") != "k_per_ray":
            return g

        def call(*a):
            out = g(*a)
            jax_k.append(np.asarray(out))
            return out
        return call

    got = occ_probe._run(logdir, [8, 16, 24], chunk=chunk, device="cpu", **SCENE)
    monkeypatch.setattr(jax, "jit", jit)
    want = jax_occ_probe._run(logdir, [8, 16, 24], chunk=chunk, **SCENE)
    monkeypatch.setattr(jax, "jit", real_jit)
    _same_keys(got, want)
    n = SCENE["height"] * SCENE["width"]
    assert got["n_rays"] == want["n_rays"] == n
    assert got["n_chunks"] == want["n_chunks"] == len(_valid_sizes(n, 1, chunk))
    jk = np.concatenate([k[:v] for k, v in zip(jax_k, _valid_sizes(n, 1, chunk))])
    pk = np.concatenate(port_k)
    assert pk.shape == jk.shape == (n,)
    assert 0.05 < got["occupied_sample_frac"] < 0.95, got  # the mask holds part of the volume
    diff = np.abs(pk - jk)
    assert np.mean(diff > 0) <= 0.01 and diff.max() <= 2, (np.mean(diff > 0), diff.max())
    for key in ("mask_reso", "alpha_mask_thre", "n_samples_merged", "chunk", "ckpt"):
        assert got[key] == want[key]
    assert abs(got["occupied_sample_frac"] - want["occupied_sample_frac"]) <= 0.01
    for key in ("chunk_eligible_frac", "ray_within_budget_frac"):
        assert got[key].keys() == want[key].keys()
        for b in got[key]:
            assert abs(got[key][b] - want[key][b]) <= 0.01
    for key in ("k_percentiles", "chunk_max_percentiles"):
        assert got[key].keys() == want[key].keys()
        for q in got[key]:
            assert abs(got[key][q] - want[key][q]) <= 2


def test_eval_bench_matches_jax(tiny_run):
    """eval_bench's rows on the tiny run (keeps 0, 16 and the oracle 16o of
    16 + 16 samples): the same rows in the same order; the PSNRs against the
    ground truth and the unculled render within 2e-3 dB of JAX's (the
    renders agree to ~1e-6, each PSNR rounded to 1e-3).  The bench scores
    against the wall scene whatever the run's background, as JAX's does,
    so on this ``env`` run its unculled PSNR is not the trainer's."""
    logdir, _ = tiny_run
    got = eval_bench._run(logdir, [16, 0, "16o"], n_repeats=1, device="cpu", **SCENE)
    want = jax_eval_bench._run(logdir, [16, 0, "16o"], n_repeats=1, **SCENE)
    _same_keys(got, want)
    assert [(r["eval_keep"], r["score"]) for r in got["rows"]] == [
        (r["eval_keep"], r["score"]) for r in want["rows"]] == [(0, "coarse"), (16, "coarse"),
                                                                (16, "oracle")]
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w)
        assert abs(g["psnr_vs_gt"] - w["psnr_vs_gt"]) <= 2e-3
        assert (g["psnr_vs_full"] is None) == (w["psnr_vs_full"] is None)
        if g["psnr_vs_full"] is not None:
            assert abs(g["psnr_vs_full"] - w["psnr_vs_full"]) <= 2e-3
        assert g["sec_per_image"] > 0
    assert got["image"] == want["image"] and got["n_samples"] == want["n_samples"]


# -- refscale_drift ----------------------------------------------------------

def _progress(it, raysps):
    return f"iter {it:06d} psnr 50.00 test 0.00 mse 0.0 rays/s {raysps:,.0f}\n"


def test_refscale_drift_matches_jax_on_a_synthetic_log():
    """JAX's synthetic log (a 100 ms/step window, a counter reset with its
    artifact line, a 120 ms/step window): the same segments and blocks as
    JAX's, and an event segment out of the mean."""
    batch = 4096
    text = "".join(_progress(it, it * batch / (10.0 + it * 0.1))
                   for it in range(500, 3001, 500))
    text += _progress(3500, 50)
    text += "".join(_progress(it, (it - 3500) * batch / ((it - 3500) * 0.12))
                    for it in range(4000, 6001, 500))
    segs = refscale_drift.parse_segments(text, batch)
    assert segs == jax_drift.parse_segments(text, batch)
    by_mid = dict(segs)
    assert abs(by_mid[1750] - 100.0) < 0.1 and abs(by_mid[5250] - 120.0) < 0.1
    for extra in ([], [(2600, 1000.0)]):
        assert (refscale_drift.drift_blocks(segs + extra, block=3000)
                == jax_drift.drift_blocks(segs + extra, block=3000))
    assert refscale_drift.drift_blocks(segs + [(2600, 1000.0)],
                                       block=3000)[0]["n_event_segments"] == 1


def test_refscale_drift_parses_the_ports_trainer_log(tmp_path, capsys, monkeypatch):
    """The port's own progress lines (a tiny run, a line every step, the
    counter restarting at each of three evaluations) parse to JAX's
    segments, every one a positive step time; the tool's main writes the
    record."""
    cfg = load_config(overrides=dict(TINY_RUN, basedir=str(tmp_path), use_envmap=False,
                                     n_iters=24, progress_refresh_rate=1,
                                     vis_list="[8, 16, 24]", render_test=False))
    trainer = Trainer(cfg, device="cpu")
    capsys.readouterr()
    trainer.train()
    log = capsys.readouterr().out
    assert len(re.findall(r"^iter \d+ .*rays/s [\d,]+$", log, flags=re.M)) == 24
    segs = refscale_drift.parse_segments(log, cfg.batch_size)
    assert segs and segs == jax_drift.parse_segments(log, cfg.batch_size)
    assert all(ms > 0 for _, ms in segs)
    assert refscale_drift.drift_blocks(segs, block=8) == jax_drift.drift_blocks(segs, block=8)
    path = tmp_path / "run.log"
    path.write_text(log)
    monkeypatch.setattr(tools, "RESULTS_DIR", str(tmp_path / "docs"))
    refscale_drift.main([str(path), str(cfg.batch_size)])
    with open(tmp_path / "docs" / "results_refscale100k_drift.json") as f:
        rec = json.load(f)
    assert rec["log"] == "run.log" and rec["batch"] == cfg.batch_size and rec["blocks"]


# -- sweep -------------------------------------------------------------------

def test_sweep_grid_names_and_lock_match_jax(tmp_path):
    grids = {"lr_init": [0.01, 0.02], "n_coarse": [64, 128]}
    grid = sweep.make_param_grid(grids)
    assert grid == jax_sweep.make_param_grid(grids) and len(grid) == 4
    names = [sweep.expname_for(c) for c in grid]
    assert names == [jax_sweep.expname_for(c) for c in grid]
    assert "lr_init-0.01_n_coarse-64" in names
    assert sweep.try_lock(str(tmp_path), "exp_a")
    assert not sweep.try_lock(str(tmp_path), "exp_a")
    assert not jax_sweep.try_lock(str(tmp_path), "exp_a")


def test_sweep_dry_run_takes_no_locks(tmp_path, capsys):
    """As JAX's: the preview claims no lock, and reports a claimed one."""
    grid = {"lr_init": ["0.01", "0.02"]}
    assert sweep.run_sweep("cfg.txt", grid, basedir=str(tmp_path), dry=True) == [
        "lr_init-0.01", "lr_init-0.02"]
    assert len(sweep.run_sweep("cfg.txt", grid, basedir=str(tmp_path), dry=True)) == 2
    os.makedirs(os.path.join(str(tmp_path), "lr_init-0.01"))
    assert sweep.run_sweep("cfg.txt", grid, basedir=str(tmp_path), dry=True) == [
        "lr_init-0.02"]
    out = capsys.readouterr().out
    assert "skip (locked): lr_init-0.01" in out


def test_sweep_launches_the_port(monkeypatch, tmp_path):
    """Each experiment launches ``python -m egonerf_torch`` with JAX's
    arguments; a failed one releases its (empty) lock."""
    cmds = {}

    class Done:
        def __init__(self, rc):
            self.returncode = rc

    def fake(pkg):
        def run(cmd):
            cmds.setdefault(pkg, []).append(cmd)
            return Done(1 if cmd[-1] == "0.02" else 0)
        return run

    grid = {"lr_init": ["0.01", "0.02"]}
    monkeypatch.setattr(sweep.subprocess, "run", fake("port"))
    got = sweep.run_sweep("cfg.txt", grid, basedir=str(tmp_path / "p"), python="py")
    monkeypatch.setattr(jax_sweep.subprocess, "run", fake("jax"))
    want = jax_sweep.run_sweep("cfg.txt", grid, basedir=str(tmp_path / "j"), python="py")
    assert got == want == ["lr_init-0.01", "lr_init-0.02"]
    for c, j in zip(cmds["port"], cmds["jax"]):
        assert c[:3] == ["py", "-m", "egonerf_torch"] and j[2] == "egonerf_tpu"
        assert c[3:] == [a.replace(str(tmp_path / "j"), str(tmp_path / "p")) for a in j[3:]]
    assert os.path.isdir(tmp_path / "p" / "lr_init-0.01")
    assert not os.path.exists(tmp_path / "p" / "lr_init-0.02")
    with pytest.raises(SystemExit):
        sweep.main(["--config", "cfg.txt"])  # no grid: the usage


# -- results_path --------------------------------------------------------------

def test_results_path_rejects_non_slug_names():
    """JAX's slug check: an op string, a path, a space, 81 characters and
    the empty name raise, in both packages."""
    for bad in ('%custom-call.50 = f32[2,258,75,16]{1,3}', 'a/b', 'a b', 'x' * 81, '',
                '../results_x'):
        with pytest.raises(ValueError):
            tools.results_path(bad)
        with pytest.raises(ValueError):
            jax_tools.results_path(bad)
    assert tools.results_path("refscale").endswith(os.path.join("docs", "torch",
                                                                "results_refscale.json"))


def test_results_path_never_names_a_jax_record():
    """Every name the JAX package has a record under (docs/results_*.json)
    maps to the port's docs/torch/, never onto JAX's file."""
    docs = os.path.join(tools.REPO, "docs")
    names = [f[len("results_"):-len(".json")] for f in os.listdir(docs)
             if f.startswith("results_") and f.endswith(".json")]
    assert "refscale" in names and "sampler_ab" in names
    for name in names + ["eval_bench", "occ_probe", "envmap_probe", "seed_variance"]:
        path = tools.results_path(name)
        assert os.path.dirname(path) == os.path.join(docs, "torch")
        assert path != jax_tools.results_path(name)
        assert os.path.abspath(path) != os.path.abspath(os.path.join(docs, f"results_{name}.json"))


def test_write_results_writes_under_its_folder(monkeypatch, tmp_path):
    monkeypatch.setattr(tools, "RESULTS_DIR", str(tmp_path / "records"))
    path = tools.write_results("x_1", {"a": 1})
    assert path == str(tmp_path / "records" / "results_x_1.json")
    with open(path) as f:
        assert json.load(f) == {"a": 1}


def test_rel_names_paths_inside_the_repo_relatively():
    assert tools.rel(os.path.join(tools.REPO, "build", "quality")) == os.path.join("build",
                                                                                  "quality")
    outside = os.path.abspath(os.sep + "elsewhere")
    assert tools.rel(outside) == outside
    assert tools.device_name("cpu") == "cpu"


def test_mains_parse_as_jax(monkeypatch):
    """The entry points read their arguments as JAX's do (positionals, with
    ``--resume`` for quality_run)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(quality_run, "_run", lambda p, resume=False: calls.append(
        (p, resume)) or {})
    written = []
    monkeypatch.setattr(quality_run, "write_results", lambda name, rec: written.append(name))
    quality_run.main([])
    quality_run.main(["tensorf", "--resume"])
    quality_run.main(["--resume", "refscale10k_env"])
    assert calls == [("refscale", False), ("tensorf", True), ("refscale10k_env", True)]
    assert written == ["refscale", "tensorf", "refscale10k_env"]
    seen = []
    monkeypatch.setattr(eval_bench, "_run", lambda logdir, keeps: seen.append((logdir, keeps))
                        or {})
    monkeypatch.setattr(eval_bench, "write_results", lambda name, rec: seen.append(name))
    eval_bench.main(["d", "0,192o"])
    monkeypatch.setenv("EGONERF_RESULTS_NAME", "eval_oracle")
    eval_bench.main([])
    assert seen == [("d", ["0", "192o"]), "eval_bench",
                    (os.path.join(tools.RUNS_DIR, "quality", "refscale"), [0, 192, 128, 96, 64]),
                    "eval_oracle"]
