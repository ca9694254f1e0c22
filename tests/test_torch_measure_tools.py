"""The port's measurement tools (``egonerf_torch/tools``: tensorf_bench,
envmap_e2e, eval_ship, eval_probe, profile_step, microbench_lookup)
against the JAX package's (``egonerf_tpu/tools``), on the CPU.

The recipes' configs are held to JAX's field by field (JAX's ``main`` runs
with a recording stand-in for its trainer), the sample stream of
``microbench_lookup`` and the gate occupancy to JAX's arithmetic, the
family accounting on a hand-written Chrome trace.  The tools that render
or train run at a tiny width on the CPU (the plain versions) and write
records with JAX's keys and ``device``; every timing path raises without
a card.  Each tolerance is stated where it is used."""
import dataclasses
import json
import os
from math import pi

import numpy as np
import pytest
import torch

import chip_smoke
from egonerf_tpu import tools as jax_tools
from egonerf_tpu.data import datasets as jax_datasets
from egonerf_tpu.tools import envmap_e2e as jax_envmap_e2e
from egonerf_tpu.tools import microbench_lookup as jax_microbench
from egonerf_tpu.tools import tensorf_bench as jax_tensorf_bench
from egonerf_tpu.train import trainer as jax_trainer
from egonerf_torch import tools
from egonerf_torch.tools import (envmap_e2e, eval_probe, eval_ship, microbench_lookup,
                                 profile_step, tensorf_bench)

# the production shape cut to a tiny width (the tools' configs take these
# as deltas)
TINY = dict(N_voxel_init=24 ** 3, N_voxel_final=24 ** 3, n_lamb_sigma="[4,4,4]",
            n_lamb_sh="[8,8,8]", data_dim_color=12, featureC=32, n_coarse=16, n_fine=16,
            batch_size=256, eval_chunk=512, r0="0.05")
# JAX's records' keys (egonerf_tpu/tools/eval_ship.py:54-61,
# eval_probe.py:116-127)
JAX_SHIP_KEYS = {"image", "n_images", "chunk", "includes", "sec_per_image_amortized",
                 "rays_per_sec", "platform"}
JAX_PROBE_KEYS = {"image", "n_samples", "platform", "reps", "rows"}
JAX_PROBE_ROW_KEYS = {"chunk", "mode", "sec_per_image", "rays_per_sec"}
JAX_ENV_E2E_KEYS = {"config", "metrics", "final_test_psnr", "wall_s", "artifacts"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


def _jax_recipe(monkeypatch, module):
    """JAX's tool's config and its datasets' arguments: its ``main`` run
    with a trainer that records the config and stops at ``set_datasets``,
    and a dataset stand-in that records its arguments."""
    seen = {}

    class Recorder:
        def __init__(self, cfg):
            seen["cfg"] = cfg

        def set_datasets(self, train, test):
            seen["train"], seen["test"] = train, test
            raise _Stop

    monkeypatch.setattr(jax_tools, "require_tpu_relay", lambda: None)
    monkeypatch.setattr(jax_trainer, "Trainer", Recorder)
    monkeypatch.setattr(jax_datasets, "SyntheticEgoDataset", lambda **kw: kw)
    with pytest.raises(_Stop):
        module.main()
    return seen


def _fields(cfg) -> dict:
    """A config's fields but ``basedir``: the port's tools train under the
    repository's ``build/``, JAX's under /tmp."""
    d = dataclasses.asdict(cfg)
    d.pop("basedir")
    return d


# -- the recipes' configs ----------------------------------------------------

def test_tensorf_bench_config_matches_jax(monkeypatch):
    seen = _jax_recipe(monkeypatch, jax_tensorf_bench)
    cfg, scene = tensorf_bench.spec()
    assert _fields(cfg) == _fields(seen["cfg"])
    assert dict(scene, split="train", is_stack=False, near_far=cfg.near_far) == seen["train"]
    assert dict(scene, split="test", is_stack=True, near_far=cfg.near_far) == seen["test"]
    assert (tensorf_bench.WARMUP_ITERS, tensorf_bench.STEPS_PER_CALL,
            tensorf_bench.CALLS_PER_SEG, tensorf_bench.N_SEGMENTS, tensorf_bench.BATCH,
            tensorf_bench.N_SAMPLES, tensorf_bench.N_VOXEL) == (
        jax_tensorf_bench.WARMUP_ITERS, jax_tensorf_bench.STEPS_PER_CALL,
        jax_tensorf_bench.CALLS_PER_SEG, jax_tensorf_bench.N_SEGMENTS, jax_tensorf_bench.BATCH,
        jax_tensorf_bench.N_SAMPLES, jax_tensorf_bench.N_VOXEL)
    assert cfg.basedir == os.path.join(tools.RUNS_DIR, "tensorf_bench")


def test_envmap_e2e_config_matches_jax(monkeypatch):
    seen = _jax_recipe(monkeypatch, jax_envmap_e2e)
    cfg, scene = envmap_e2e.spec()
    assert _fields(cfg) == _fields(seen["cfg"])
    assert dict(scene, split="train", is_stack=False, near_far=cfg.near_far) == seen["train"]
    assert dict(scene, split="test", is_stack=True, near_far=cfg.near_far) == seen["test"]
    assert (envmap_e2e.N_ITERS, envmap_e2e.PRETRAIN, envmap_e2e.IMG_H, envmap_e2e.IMG_W,
            envmap_e2e.N_TRAIN, envmap_e2e.N_TEST) == (
        jax_envmap_e2e.N_ITERS, jax_envmap_e2e.PRETRAIN, jax_envmap_e2e.IMG_H,
        jax_envmap_e2e.IMG_W, jax_envmap_e2e.N_TRAIN, jax_envmap_e2e.N_TEST)


def test_recipe_deltas_win():
    cfg, _ = tensorf_bench.spec(n_iters=7, basedir="/elsewhere")
    assert (cfg.n_iters, cfg.basedir, cfg.model_name) == (7, "/elsewhere", "TensorVMSplit")
    cfg, _ = envmap_e2e.spec(n_iters=9)
    assert (cfg.n_iters, cfg.use_envmap, cfg.iter_pretrain_envmap) == (9, True, 500)


def test_envmap_e2e_runs_on_the_cpu_with_jaxs_keys(tmp_path):
    """The recipe cut to a tiny width (20 steps after 5 of pretrain, 2 + 1
    views of 80x40) trains on the CPU and writes JAX's record keys, the
    device and the evaluation's files."""
    rec = envmap_e2e._run(device="cpu", scene=dict(n_train=2, n_test=1, height=40, width=80),
                          basedir=str(tmp_path), n_iters=20, iter_pretrain_envmap=5,
                          envmap_res_H=16, vis_list="[20]", **TINY)
    assert set(rec) == JAX_ENV_E2E_KEYS | {"device"}
    assert rec["device"] == "cpu"
    assert rec["config"]["views"] == "2+1 @ 80x40"
    assert np.isfinite(rec["final_test_psnr"])
    out = os.path.join(str(tmp_path), "envmap_e2e", "imgs_test_all")
    for name in ("mean.json", "000.png", "000_bg.png", "envmap.png"):
        assert os.path.exists(os.path.join(out, name)), name


# -- tensorf_bench's gate occupancy ------------------------------------------

def _jax_occupancy(alpha: np.ndarray, thres: float) -> float:
    """JAX's expression (egonerf_tpu/tools/tensorf_bench.py:104-109)."""
    trans = np.cumprod(np.concatenate(
        [np.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], axis=-1), axis=-1)[:, :-1]
    w = alpha * trans
    return float((w > thres).mean())


@pytest.mark.parametrize("envmap", [False, True])
def test_gate_occupancy_matches_jax(envmap):
    rng = np.random.default_rng(3)
    alpha = rng.uniform(0.0, 1.0, (512, 256)).astype(np.float32) ** 8
    alpha[:64] = 0.0
    alpha[64:96, 10] = 1.0
    if envmap:  # the background's alpha column, as the forward returns it
        alpha = np.concatenate([alpha, np.ones_like(alpha[:, :1])], axis=-1)
    for thres in (1e-4, 1e-2):
        # the same float32 products in the same order: equal
        assert tensorf_bench.gate_occupancy(torch.from_numpy(alpha), thres) == \
            _jax_occupancy(alpha, thres)


# -- microbench_lookup's sample stream ----------------------------------------

def test_ray_coherent_coords_match_jax():
    """The stream of 4096 x 256 points on the yin-yang chart: JAX's draws,
    the port's chart.  As in test_torch_coords: acos and atan2 differ by
    ulps between the libraries, so only points within 1e-6 rad of a chart
    boundary may take the other chart; elsewhere the normalized coords
    agree within 2e-5."""
    got = [t.numpy() for t in microbench_lookup.ray_coherent_coords(0)]
    want = jax_microbench.ray_coherent_coords(0)
    assert got[3].dtype == np.int64 and got[0].shape == (4096 * 256,)
    flip = got[3] != want[3]
    o, d, t = microbench_lookup.ray_coherent_rays(0)
    pts = (o[:, None, :] + d[:, None, :] * t[None, :, None]).reshape(-1, 3)[flip]
    r = np.linalg.norm(pts.astype(np.float64), axis=-1)
    th = np.arccos(np.clip(pts[:, 2] / np.maximum(r, 1e-12), -1, 1))
    ph = np.arctan2(pts[:, 1], pts[:, 0])
    edge = np.minimum(np.minimum(np.abs(th - pi / 4), np.abs(th - 3 * pi / 4)),
                      np.minimum(np.abs(ph + 3 * pi / 4), np.abs(ph - 3 * pi / 4)))
    assert np.all(edge < 1e-6)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[~flip], w[~flip], rtol=0, atol=2e-5)


def test_library_grid_sample_is_the_nograd_lookup():
    """``F.grid_sample`` on the tool's layout computes K15's and K16's
    plain versions (float32 sums of the same corners: rel 1e-5)."""
    from egonerf_torch.ops import grid_sample, vm_lookup

    gen = torch.Generator().manual_seed(4)
    n = 2048
    plane = torch.randn(2, 12, 20, 8, generator=gen).bfloat16()
    line = torch.randn(2, 20, 8, generator=gen)
    x, y, z = (torch.rand(n, generator=gen) * 2.1 - 1.05 for _ in range(3))
    sel = torch.randint(0, 2, (n,), generator=gen)
    cases = ((microbench_lookup.library_grid_sample(plane, x, y, sel),
              vm_lookup.sample_plane_nograd_plain(plane, x, y, sel)),
             (microbench_lookup.library_grid_sample(plane[:1], x, y, None),
              vm_lookup.sample_plane_nograd_plain(plane[:1], x, y)),
             (microbench_lookup.library_grid_sample(line, None, z, sel),
              grid_sample.sample_line_plain(line, z, sel)),
             (microbench_lookup.library_grid_sample(line[:1], None, z, None),
              grid_sample.sample_line_plain(line[:1], z)))
    for lib, ref in cases:
        np.testing.assert_allclose(lib().t().numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


# -- profile_step's family accounting -----------------------------------------

def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def _trace(tmp_path, events, steps=2):
    with open(os.path.join(str(tmp_path), "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)
    with open(os.path.join(str(tmp_path), "traced_steps.json"), "w") as f:
        json.dump({"steps": steps}, f)
    return str(tmp_path)


HAND_TRACE = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 400.0},
    _kernel("void vm_lookup_kernel<true, true, true, true, true>(float const*)", 10.0, 40.0),
    _kernel("void vm_lookup_kernel<false, true, false, false, true>(float const*)", 50.0, 5.0),
    _kernel("_Z19vm_field_bwd_kernelILb1ELb1EEvPKf", 60.0, 100.0),
    _kernel("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", 160.0, 30.0),
    _kernel("nvjet_tst_128x64_64x8_2x1_v_bz_TNN", 170.0, 20.0),  # overlaps the last
    _kernel("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>()", 200.0, 8.0),
    _kernel("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>()",
            210.0, 2.0),
    _kernel("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add>()",
            215.0, 3.0),
    _kernel("void at::native::reduce_kernel<512, 1>()", 220.0, 4.0),
    _kernel("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>>()", 230.0, 6.0),
    _kernel("void some_unknown_kernel_of_a_library<7>()", 240.0, 9.0),
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 250.0, "dur": 1.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 252.0,
     "dur": 2.0},
    # a device annotation spans kernels that have rows of their own
    {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step#Adam.step", "ts": 228.0,
     "dur": 10.0},
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 10.0},
]


def test_families_account_for_every_device_event(tmp_path):
    d = _trace(tmp_path, HAND_TRACE)
    rec = profile_step.families(d, write=False, device="a card")
    ops = [e for e in HAND_TRACE if e.get("cat") in profile_step.DEVICE_CATS]
    total_ms = sum(e["dur"] for e in ops) / 1e3
    fams = {r["family"]: r for r in rec["families"]}
    # each device event in exactly one family: the families' operations
    # partition the events, and their times sum to the whole
    names = [o["name"] for r in rec["families"] for o in r["top_ops"]]
    assert sorted(names) == sorted(e["name"] for e in ops)
    assert sum(r["ms_per_step"] for r in rec["families"]) * 2 == pytest.approx(total_ms, abs=1e-9)
    assert rec["ms_per_step_total"] * 2 == pytest.approx(total_ms, abs=1e-9)
    assert sum(r["share_pct"] for r in rec["families"]) == pytest.approx(100.0, abs=1e-6)
    assert fams["other"]["top_ops"][0]["name"] == "void some_unknown_kernel_of_a_library<7>()"
    assert fams["K1 field"]["ms_per_step"] == pytest.approx(0.02)
    assert fams["K3 density"]["ms_per_step"] == pytest.approx(0.0025)
    assert fams["K2 field backward"]["ms_per_step"] == pytest.approx(0.05)
    assert fams["shader GEMMs"]["ms_per_step"] == pytest.approx(0.025)
    for fam in ("cat copies", "zero fills", "memcpy", "elementwise and reductions",
                "Adam (multi_tensor_apply)"):
        assert fam in fams, fam
    assert len(fams["zero fills"]["top_ops"]) == 2  # FillFunctor and the memset
    # the busy share: the union of the device intervals (the two GEMMs
    # overlap by 20 us) over the span of every complete event, 0 to 400 us
    busy = total_ms * 1e3 - 20.0
    assert rec["busy_ms_per_step"] * 2 == pytest.approx(busy / 1e3)
    assert rec["window_ms_per_step"] * 2 == pytest.approx(0.4)
    assert rec["busy_share"] == pytest.approx(busy / 400.0)
    assert rec["device"] == "a card" and rec["n_device_ops"] == len(ops)


def test_summarize_sums_to_the_device_time(tmp_path):
    d = _trace(tmp_path, HAND_TRACE, steps=4)
    rows = profile_step.summarize(d)
    ops = [e for e in HAND_TRACE if e.get("cat") in profile_step.DEVICE_CATS]
    assert len(rows) == len(ops)
    assert sum(ms for _, ms, _ in rows) * 4 == pytest.approx(sum(e["dur"] for e in ops) / 1e3)
    assert rows[0][0] == "_Z19vm_field_bwd_kernelILb1ELb1EEvPKf"
    assert sum(share for *_, share in rows) == pytest.approx(1.0)


@pytest.mark.parametrize("form", ["demangled", "mangled"])
def test_every_port_kernel_has_a_family(form):
    """Each kernel of csrc/, named as the trace names it, lands in a K
    family, never in "other" or a library family."""
    for name in chip_smoke.PORT_KERNELS:
        full = (f"void {name}<true, 2>(float const*, long long)" if form == "demangled"
                else f"_Z{len(name)}{name}ILb1ELi2EEvPKfx")
        assert profile_step.family_of(full).startswith("K"), full


def test_a_trace_without_device_operations_fails(tmp_path):
    d = _trace(tmp_path, [e for e in HAND_TRACE if e.get("cat") == "cpu_op"])
    with pytest.raises(RuntimeError, match="no device operation"):
        profile_step.families(d, write=False)
    with pytest.raises(RuntimeError, match="no device operation"):
        profile_step.summarize(d)


def test_capture_eval_on_the_cpu_traces_no_device_time(tmp_path):
    """capture_eval writes JAX's traced_steps.json (with the device) and a
    Chrome trace; on the CPU the trace has no device operation, and the
    tables refuse it rather than report host time."""
    out = profile_step.capture_eval(height=8, width=16, n_images=1, device="cpu",
                                    profile_dir=str(tmp_path / "eval"),
                                    basedir=str(tmp_path), **TINY)
    meta = profile_step.traced_meta(out)
    assert meta["steps"] == 1 and meta["device"] == "cpu" and meta["sec_per_image"] > 0
    assert profile_step.load_trace(out)
    with pytest.raises(RuntimeError, match="no device operation"):
        profile_step.families(out, write=False)


def test_profile_step_main_reads_a_directory_without_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _trace(tmp_path, HAND_TRACE)
    written = []
    monkeypatch.setattr(profile_step, "write_results", lambda *a: written.append(a))
    profile_step.main([d])
    out = capsys.readouterr().out
    assert "family accounting" in out and "some_unknown_kernel_of_a_library" in out
    assert not written


# -- eval_ship and eval_probe on the CPU ---------------------------------------

def test_eval_ship_writes_jaxs_record_on_the_cpu(tmp_path):
    rec = eval_ship._run(n_images=2, height=8, width=16, device="cpu", basedir=str(tmp_path),
                         **TINY)
    assert set(rec) == JAX_SHIP_KEYS | {"device"}
    assert (rec["image"], rec["n_images"], rec["chunk"], rec["platform"], rec["device"]) == (
        "16x8", 2, TINY["eval_chunk"], "cpu", "cpu")
    assert rec["sec_per_image_amortized"] > 0 and rec["rays_per_sec"] > 0
    imgs = os.path.join(str(tmp_path), "imgs")
    for name in ("000.png", "001.png", "mean.json", os.path.join("rgbd", "001.png")):
        assert os.path.exists(os.path.join(imgs, name)), name


def test_eval_probe_writes_jaxs_record_on_the_cpu(tmp_path):
    rec = eval_probe._run(chunks=(64, 128), modes=("none", "rgb", "all"), reps=1, height=8,
                          width=16, device="cpu", basedir=str(tmp_path), **TINY)
    assert set(rec) == JAX_PROBE_KEYS | {"device"}
    assert (rec["image"], rec["n_samples"], rec["platform"], rec["device"], rec["reps"]) == (
        "16x8", "16+16", "cpu", "cpu", 1)
    assert [(r["chunk"], r["mode"]) for r in rec["rows"]] == [
        (c, m) for c in (64, 128) for m in ("none", "rgb", "all")]
    for row in rec["rows"]:
        assert set(row) == JAX_PROBE_ROW_KEYS | {"peak_mem_gb"}
        assert row["peak_mem_gb"] is None and row["sec_per_image"] > 0


def test_eval_probe_pipe2_needs_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="side stream"):
        eval_probe._run(chunks=(64,), modes=("pipe2",), reps=1, height=8, width=16,
                        device="cpu", basedir=str(tmp_path), **TINY)


def test_eval_probe_reads_jaxs_variables(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    monkeypatch.setattr(eval_probe, "_run", lambda *a: seen.append(a) or {"rows": []})
    monkeypatch.setattr(eval_probe, "write_results", lambda name, rec: name)
    eval_probe.main([])
    monkeypatch.setenv("EVAL_PROBE_CHUNKS", "8192")
    monkeypatch.setenv("EVAL_PROBE_MODES", "none,pipe2")
    monkeypatch.setenv("EVAL_PROBE_REPS", "1")
    out = str(tmp_path / "probe.json")
    eval_probe.main([out])
    assert seen == [([4096, 8192, 16384], ["none", "rgb", "all", "pipe2"], 2),
                    ([8192], ["none", "pipe2"], 1)]
    with open(out) as f:
        assert json.load(f) == {"rows": []}


# -- the card -----------------------------------------------------------------

@pytest.mark.parametrize("module", [tensorf_bench, envmap_e2e, eval_ship, eval_probe,
                                    profile_step, microbench_lookup],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_timing_entry_points_raise_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])


def test_timing_paths_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="times the card"):
        microbench_lookup._run(device="cpu")

    class CpuTrainer:
        cfg = None
        device = torch.device("cpu")

    with pytest.raises(RuntimeError, match="times the card"):
        tensorf_bench.measure(CpuTrainer())
