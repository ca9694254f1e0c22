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
from egonerf_torch.ops import merge, pdf, vm_lookup, volrend

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
                                                  "sorted_uniform"}


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
