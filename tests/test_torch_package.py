"""Package rules of the PyTorch port: no JAX, no silent CPU, wrappers that
check their arguments, a kernel build that does not fall back."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import egonerf_torch
from egonerf_torch import _build, _device
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.ops import (alphamask, chart, envmap, grid_sample, merge, pdf, sampler,
                               vm_lookup, volrend)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "egonerf_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "egonerf_tpu")


def _modules():
    return ["egonerf_torch"] + [m.name for m in pkgutil.walk_packages(
        egonerf_torch.__path__, "egonerf_torch.")]


def test_imports_pull_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules() + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_statements(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve_device()
    from egonerf_torch import presets
    from egonerf_torch.models import params_from_jax

    with pytest.raises(RuntimeError, match="device='cpu'"):
        presets.production_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({})
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_dir_keyed_by_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert d == _build.build_dir()
    assert {p.stem for p in _build.sources()} == {"vm_lookup", "resample", "composite",
                                                  "sorted_uniform", "chart", "envmap",
                                                  "alphamask", "mixed_mm", "bias_grad",
                                                  "cull", "theta_sampler", "grid_sample",
                                                  "cp_lookup"}


def _tables(c=12, dtype=torch.bfloat16):
    planes = [torch.zeros(2, 5, 6, c, dtype=dtype) for _ in range(3)]
    lines = [torch.zeros(2, 7, c, dtype=dtype) for _ in range(3)]
    return planes, lines


def _field(**over):
    planes, lines = _tables()
    args = dict(coords=torch.zeros(16, 4), planes=planes, lines=lines,
                n_density=(4, 4, 4), line_hat=(True, True, True))
    args.update(over)
    return vm_lookup.field_fwd(**args)


def _field_bwd(**over):
    planes, lines = _tables()
    args = dict(coords=torch.zeros(16, 4), planes=planes, lines=lines, d_dens=torch.zeros(16),
                d_app=torch.zeros(16, 24), mask=torch.zeros(16, dtype=torch.uint8),
                n_density=(4, 4, 4), line_hat=(True, True, True))
    args.update(over)
    return vm_lookup.field_bwd(**args)


def _composite_bwd(**over):
    args = dict(feat=torch.zeros(8, 32), dists=torch.zeros(8, 32), rgb=torch.zeros(8, 32, 3),
                d_rgb_map=torch.zeros(8, 3))
    args.update(over)
    return volrend.composite_bwd(**args)


def _resample(**over):
    args = dict(c_feat=torch.zeros(8, 16), coarse_z=torch.zeros(8, 16),
                coarse_dists=torch.zeros(8, 16), n_fine=16)
    args.update(over)
    return pdf.resample(**args)


def _composite(**over):
    args = dict(feat=torch.zeros(8, 32), dists=torch.zeros(8, 32), z_vals=torch.zeros(8, 32),
                rgb=torch.zeros(8, 32, 3), ray_dz=torch.zeros(8))
    args.update(over)
    return volrend.composite(**args)


def _coords(**over):
    return YinYangSphericalCoords([[-2.0] * 3, [2.0] * 3], exp_r=True, N_voxel=12 ** 3, r0=0.05,
                                  **over)


def _chart(**over):
    args = dict(rays_o=torch.zeros(8, 3), viewdirs=torch.ones(8, 3), z=torch.ones(8, 5),
                coords=_coords(interval_th=True))
    args.update(over)
    return chart.chart_fwd(**args)


def _envmap(**over):
    args = dict(table=torch.zeros(8, 4, 3), dirs=torch.ones(6, 3))
    args.update(over)
    return envmap.envmap_fwd(**args)


def _envmap_bwd(**over):
    args = dict(dirs=torch.ones(6, 3), env=torch.zeros(6, 3), d_env=torch.zeros(6, 3), h=4)
    args.update(over)
    return envmap.envmap_bwd(**args)


def _alpha(**over):
    args = dict(coords=torch.zeros(16, 4), volume=torch.zeros(2, 3, 4, 5, dtype=torch.uint8))
    args.update(over)
    return alphamask.alpha_fwd(**args)


def _theta(**over):
    args = dict(img=torch.zeros(8, dtype=torch.int64), col=torch.zeros(8, dtype=torch.int64),
                u=torch.rand(8), cdf=torch.linspace(0.25, 1.0, 4), w=3, h=4)
    args.update(over)
    return sampler.theta_ids(**args)


def _plane_nograd(**over):
    args = dict(plane=torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16), x=torch.zeros(5),
                y=torch.zeros(5), sel=torch.zeros(5, dtype=torch.int64))
    args.update(over)
    return vm_lookup.sample_plane_nograd(**args)


def _line_nograd(**over):
    args = dict(line=torch.zeros(2, 3, 8, dtype=torch.bfloat16), coord=torch.zeros(5), sel=None)
    args.update(over)
    return vm_lookup.sample_line_nograd(**args)


def _grid_line(**over):
    args = dict(lines=torch.zeros(1, 3, 8), coord=torch.zeros(5), sel=None)
    args.update(over)
    return grid_sample.sample_line(**args)


BAD_CALLS = {
    "theta u float64": (lambda: _theta(u=torch.rand(8, dtype=torch.float64)), TypeError),
    "theta img int32": (lambda: _theta(img=torch.zeros(8, dtype=torch.int32)), TypeError),
    "theta col length": (lambda: _theta(col=torch.zeros(7, dtype=torch.int64)), ValueError),
    "theta cdf rows": (lambda: _theta(h=5), ValueError),
    "theta w": (lambda: _theta(w=0), ValueError),
    "theta cdf (h, 1)": (lambda: _theta(cdf=torch.ones(4, 1)), ValueError),
    "plane_nograd float32 plane": (lambda: _plane_nograd(plane=torch.zeros(2, 3, 4, 8)),
                                   TypeError),
    "plane_nograd y length": (lambda: _plane_nograd(y=torch.zeros(4)), ValueError),
    "plane_nograd sel int32": (lambda: _plane_nograd(sel=torch.zeros(5, dtype=torch.int32)),
                               TypeError),
    "plane_nograd empty plane": (lambda: _plane_nograd(
        plane=torch.zeros(2, 0, 4, 8, dtype=torch.bfloat16)), ValueError),
    "line_nograd (S, L) line": (lambda: _line_nograd(line=torch.zeros(2, 3,
                                                                      dtype=torch.bfloat16)),
                                ValueError),
    "line_nograd strided coord": (lambda: _line_nograd(coord=torch.zeros(10)[::2]), ValueError),
    "grid line bf16 lines": (lambda: _grid_line(lines=torch.zeros(1, 3, 8,
                                                                  dtype=torch.bfloat16)),
                             TypeError),
    "grid line coord (N, 1)": (lambda: _grid_line(coord=torch.zeros(5, 1)), ValueError),
    "grid line sel length": (lambda: _grid_line(sel=torch.zeros(4, dtype=torch.int64)),
                             ValueError),
    "plane_nograd sel past the stack": (lambda: _plane_nograd(sel=torch.tensor([0, 1, 0, 1, 2])),
                                        IndexError),
    "line_nograd negative sel": (lambda: _line_nograd(sel=torch.tensor([0, 1, -1, 0, 0])),
                                 IndexError),
    "grid line sel past the stack": (lambda: _grid_line(sel=torch.ones(5, dtype=torch.int64)),
                                     IndexError),
    "alpha volume float32": (lambda: _alpha(volume=torch.zeros(2, 3, 4, 5)), TypeError),
    "alpha three volumes": (lambda: _alpha(volume=torch.zeros(3, 3, 4, 5, dtype=torch.uint8)),
                            ValueError),
    "alpha two volumes without a flag": (lambda: _alpha(coords=torch.zeros(16, 3)), ValueError),
    "alpha coords (N, 5)": (lambda: _alpha(coords=torch.zeros(16, 5)), ValueError),
    "alpha coords float64": (lambda: _alpha(coords=torch.zeros(16, 4, dtype=torch.float64)),
                             TypeError),
    "field mixed stacks": (lambda: _field(lines=[torch.zeros(1, 7, 12, dtype=torch.bfloat16)] * 3),
                           ValueError),
    "composite valid shape": (lambda: _composite(valid=torch.ones(8, 31, dtype=torch.bool)),
                              ValueError),
    "composite valid dtype": (lambda: _composite(valid=torch.ones(8, 32)), TypeError),
    "composite_bwd valid dtype": (lambda: _composite_bwd(valid=torch.ones(8, 32,
                                                                           dtype=torch.uint8)),
                                  TypeError),
    "field coords float64": (lambda: _field(coords=torch.zeros(16, 4, dtype=torch.float64)),
                             TypeError),
    "field coords (N, 3)": (lambda: _field(coords=torch.zeros(16, 3)), ValueError),
    "field coords strided": (lambda: _field(coords=torch.zeros(16, 8)[:, :4]), ValueError),
    "field float32 tables": (lambda: _field(planes=_tables(dtype=torch.float32)[0]),
                             TypeError),
    "field line width": (lambda: _field(lines=_tables(c=10)[1]), ValueError),
    "field density width": (lambda: _field(n_density=(4, 13, 4)), ValueError),
    "field two planes": (lambda: _field(planes=_tables()[0][:2]), ValueError),
    "density float32 tables": (lambda: vm_lookup.density_fwd(
        torch.zeros(16, 4), *_tables(dtype=torch.float32)), TypeError),
    "resample z shape": (lambda: _resample(coarse_z=torch.zeros(8, 15)), ValueError),
    "resample u shape": (lambda: _resample(u=torch.zeros(8, 15)), ValueError),
    "resample two coarse": (lambda: _resample(c_feat=torch.zeros(8, 2), coarse_z=torch.zeros(8, 2),
                                              coarse_dists=torch.zeros(8, 2)), ValueError),
    "resample activation": (lambda: _resample(act="exp"), ValueError),
    "composite rgb shape": (lambda: _composite(rgb=torch.zeros(8, 32, 4)), ValueError),
    "composite dz dtype": (lambda: _composite(ray_dz=torch.zeros(8, dtype=torch.float16)),
                           TypeError),
    "composite not a tensor": (lambda: _composite(dists=[0.0] * 8), TypeError),
    "field_bwd d_app width": (lambda: _field_bwd(d_app=torch.zeros(16, 23)), ValueError),
    "field_bwd d_dens dtype": (lambda: _field_bwd(d_dens=torch.zeros(16, dtype=torch.float64)),
                               TypeError),
    "field_bwd float32 tables": (lambda: _field_bwd(planes=_tables(dtype=torch.float32)[0]),
                                 TypeError),
    "field_bwd mask dtype": (lambda: _field_bwd(mask=torch.zeros(16, dtype=torch.int32)),
                             TypeError),
    "composite_bwd grad shape": (lambda: _composite_bwd(d_rgb_map=torch.zeros(8, 4)),
                                 ValueError),
    "composite_bwd too many samples": (lambda: _composite_bwd(
        feat=torch.zeros(1, 1537), dists=torch.zeros(1, 1537), rgb=torch.zeros(1, 1537, 3),
        d_rgb_map=torch.zeros(1, 3)), ValueError),
    "sorted_uniform no draws": (lambda: merge.sorted_uniform(4, 0, 0, 0, "cpu"), ValueError),
    "composite env shape": (lambda: _composite(env=torch.zeros(8, 4)), ValueError),
    "composite_bwd env dtype": (lambda: _composite_bwd(env=torch.zeros(8, 3,
                                                                       dtype=torch.float64)),
                                TypeError),
    "chart rays (R, 4)": (lambda: _chart(rays_o=torch.zeros(8, 4)), ValueError),
    "chart column stride": (lambda: _chart(viewdirs=torch.zeros(3, 8).T), ValueError),
    "chart z rows": (lambda: _chart(z=torch.ones(7, 5)), ValueError),
    "chart z float64": (lambda: _chart(z=torch.ones(8, 5, dtype=torch.float64)), TypeError),
    "chart not yin-yang": (lambda: _chart(coords=object()), TypeError),
    "envmap table (h, h, 3)": (lambda: _envmap(table=torch.zeros(4, 4, 3)), ValueError),
    "envmap table strided": (lambda: _envmap(table=torch.zeros(8, 4, 6)[..., :3]), ValueError),
    "envmap dirs (R, 2)": (lambda: _envmap(dirs=torch.ones(6, 2)), ValueError),
    "envmap_bwd env shape": (lambda: _envmap_bwd(env=torch.zeros(5, 3)), ValueError),
    "envmap_bwd h": (lambda: _envmap_bwd(h=1), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrappers_reject_bad_arguments(case):
    call, error = BAD_CALLS[case]
    with pytest.raises(error):
        call()


def test_wrappers_on_cpu_take_the_plain_versions():
    """A CPU tensor takes the plain version and launches nothing."""
    counters = (vm_lookup.field_fwd, vm_lookup.field_bwd, vm_lookup.density_fwd, pdf.resample,
                merge.sorted_uniform, volrend.composite, volrend.composite_bwd)
    before = [f.launches for f in counters]
    dens, app = _field()
    assert dens.shape == (16,) and app.shape == (16, 24)
    assert vm_lookup.density_fwd(torch.zeros(16, 4), *_tables()).shape == (16,)
    z, d = _resample()
    assert z.shape == d.shape == (8, 32)
    assert [t.shape for t in _composite()] == [(8, 3), (8,), (8,), (8, 1)]
    g_planes, g_lines = _field_bwd()
    assert [g.shape for g in g_planes + g_lines] == [(2, 5, 6, 12)] * 3 + [(2, 7, 12)] * 3
    assert [t.shape for t in _composite_bwd()] == [(8, 32), (8, 32, 3)]
    assert merge.sorted_uniform(8, 5, 0, 0, "cpu").shape == (8, 5)
    assert [t.shape for t in _composite(env=torch.zeros(8, 3))] == [(8, 3), (8,), (8,), (8, 1),
                                                                   (8, 3)]
    assert [t.shape for t in _composite_bwd(env=torch.zeros(8, 3))] == [(8, 32), (8, 32, 3),
                                                                       (8, 3)]
    assert [f.launches for f in counters] == before


def test_single_grid_and_gates_take_the_plain_versions_on_cpu():
    """K1/K2/K3 on a stack of one grid, K6/K6b with the gates and K9 give
    CPU tensors their plain versions and launch nothing."""
    counters = (vm_lookup.field_fwd, vm_lookup.field_bwd, vm_lookup.density_fwd,
                volrend.composite, volrend.composite_bwd, alphamask.alpha_fwd)
    before = [f.launches for f in counters]
    one = [[t[:1].contiguous() for t in ts] for ts in _tables()]
    dens, app = _field(planes=one[0], lines=one[1])
    assert dens.shape == (16,) and app.shape == (16, 24)
    assert vm_lookup.density_fwd(torch.zeros(16, 4), *one).shape == (16,)
    g_planes, _ = _field_bwd(planes=one[0], lines=one[1])
    assert [g.shape for g in g_planes] == [(1, 5, 6, 12)] * 3
    gates = dict(valid=torch.ones(8, 32, dtype=torch.bool), rgb_thres=1e-4)
    assert [t.shape for t in _composite(**gates)] == [(8, 3), (8,), (8,), (8, 1)]
    assert [t.shape for t in _composite_bwd(**gates)] == [(8, 32), (8, 32, 3)]
    assert _alpha().shape == (16,)
    assert _alpha(coords=torch.zeros(16, 3), volume=torch.ones(1, 3, 4, 5,
                                                               dtype=torch.uint8)).shape == (16,)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("interval_th", [True, False])
def test_chart_and_envmap_entries_take_the_plain_versions_on_cpu(interval_th):
    """The ``Ops`` entries of K7, K8 and K8b give CPU tensors their plain
    versions (the same values) and launch nothing."""
    from egonerf_torch import ops

    counters = (chart.chart_fwd, envmap.envmap_fwd, envmap.envmap_bwd)
    before = [f.launches for f in counters]
    gen = torch.Generator().manual_seed(0)
    o, d = torch.rand(8, 3, generator=gen), torch.randn(8, 3, generator=gen)
    z, table = torch.rand(8, 5, generator=gen) * 3, torch.rand(8, 4, 3, generator=gen)
    coords = _coords(interval_th=interval_th)
    for ds in (None, 2):
        got = ops.KERNELS.chart(o, d, z, coords, ds)
        assert got.shape == (40, 4)
        assert torch.equal(got, ops.PLAIN.chart(o, d, z, coords, ds))
    env = ops.KERNELS.envmap(table, d)
    assert env.shape == (8, 3) and torch.equal(env, ops.PLAIN.envmap(table, d))
    g = torch.randn(8, 3, generator=gen)
    grad = ops.KERNELS.envmap_bwd(d, env, g, 4)
    assert grad.shape == (8, 4, 3) and torch.equal(grad, ops.PLAIN.envmap_bwd(d, env, g, 4))
    assert [f.launches for f in counters] == before


def test_sampler_and_lookup_entries_take_the_plain_versions_on_cpu():
    """K14, K15 and K16 give CPU tensors their plain versions and launch
    nothing."""
    from egonerf_torch import ops

    counters = (sampler.theta_ids, vm_lookup.sample_plane_nograd,
                vm_lookup.sample_line_nograd, grid_sample.sample_line)
    before = [f.launches for f in counters]
    u = torch.tensor([0.0, 0.25, 0.3, 0.5, 0.6, 0.75, 0.9, 1.0])
    col = torch.arange(8) % 3
    ids = _theta(u=u, col=col)
    assert ids.dtype == torch.int64
    assert ids.tolist() == (torch.tensor([0, 0, 1, 1, 2, 2, 3, 3]) * 3 + col).tolist()
    gen = torch.Generator().manual_seed(0)
    x, sel = torch.rand(6, generator=gen) * 2 - 1, torch.tensor([0, 1, 1, 0, 1, 0])
    plane = torch.randn(2, 3, 4, 8, generator=gen).bfloat16()
    line = torch.randn(2, 5, 8, generator=gen)
    assert ops.KERNELS.theta_ids is sampler.theta_ids
    assert ops.PLAIN.theta_ids is sampler.theta_ids_plain
    for kern, plain, args in ((vm_lookup.sample_plane_nograd, vm_lookup.sample_plane_nograd_plain,
                               (plane, x, x.flip(0), sel)),
                              (vm_lookup.sample_line_nograd, vm_lookup.sample_line_nograd_plain,
                               (line.bfloat16(), x, sel)),
                              (grid_sample.sample_line, grid_sample.sample_line_plain,
                               (line, x, sel)),
                              (grid_sample.sample_line, grid_sample.sample_line_plain,
                               (line[:1].clone(), x, None))):
        out = kern(*args)
        assert out.shape == (6, 8) and torch.equal(out, plain(*args))
    assert [f.launches for f in counters] == before


def test_trainer_sampling_methods(tmp_path):
    """The trainer accepts ``theta_importance`` beside ``simple``, refuses
    any other sampling method with JAX's ValueError, and still refuses NDC
    rays."""
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import check_supported

    base = dict(dataset_name="synthetic", basedir=str(tmp_path), sparsity_lambda=0,
                exp_sampling=True)
    for name in ("simple", "theta_importance"):
        check_supported(load_config(overrides=dict(base, sampling_method=name)))
    with pytest.raises(ValueError, match="sampling method importance not supported"):
        check_supported(load_config(overrides=dict(base, sampling_method="importance")))
    with pytest.raises(NotImplementedError, match="NDC rays"):
        check_supported(load_config(overrides=dict(base, sampling_method="theta_importance",
                                                   ndc_ray=True)))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card chip_smoke prints no result and exits non-zero; alone in
    a directory (without the package) it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for script in (REPO / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0, script
        assert '"ok"' not in out.stdout, script


def test_tool_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Each quality-record tool's entry point defaults to the card and
    raises before any work without one (``device="cpu"`` runs them on the
    host: tests/test_torch_tools.py)."""
    from egonerf_torch.tools import (cull_ab, envmap_probe, eval_bench, f32_ab, occ_probe,
                                     quality_run, sampler_ab, seed_ab, seed_variance)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "quality_run._run": lambda: quality_run._run("refscale"),
        "quality_run.main": lambda: quality_run.main(["refscale"]),
        "sampler_ab.run_variant": lambda: sampler_ab.run_variant("v", "simple", True),
        "sampler_ab.main": sampler_ab.main,
        "f32_ab.main": f32_ab.main,
        "seed_variance.main": lambda: seed_variance.main(["1"]),
        "seed_ab.main": lambda: seed_ab.main(["1"]),
        "cull_ab.run": lambda: cull_ab.run([128], full_every=4),
        "cull_ab.main": lambda: cull_ab.main(["192,128", "--scene=cluttered"]),
        "envmap_probe._run": lambda: envmap_probe._run(str(tmp_path)),
        "envmap_probe.main": lambda: envmap_probe.main([str(tmp_path)]),
        "occ_probe._run": lambda: occ_probe._run(str(tmp_path), [8]),
        "occ_probe.main": lambda: occ_probe.main([str(tmp_path)]),
        "eval_bench._run": lambda: eval_bench._run(str(tmp_path), [0]),
        "eval_bench.main": lambda: eval_bench.main([str(tmp_path)]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert not os.listdir(tmp_path), name
