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
from egonerf_torch.ops import chart, envmap, merge, pdf, vm_lookup, volrend

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
                                                  "sorted_uniform", "chart", "envmap"}


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
                d_app=torch.zeros(16, 24), n_density=(4, 4, 4), line_hat=(True, True, True))
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


BAD_CALLS = {
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
