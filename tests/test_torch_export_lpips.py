"""The LPIPS weights export (``tools/export_lpips``) against the JAX
package's, on the CPU.

Both tools read the pip ``lpips`` package's model, which is not installed
here, so the tests put a stand-in ``lpips`` module into ``sys.modules``:
an ``LPIPS(net, version)`` whose ``net`` holds the backbone's layers in
lpips' five slices (torchvision's AlexNet and VGG16 ``features``, split
where lpips taps them), so ``net.modules()`` yields the convolutions in
execution order, and whose ``lins`` are lpips' heads, each
``model = Sequential(Dropout, Conv2d(C, 1, 1, bias=False))``.  Its
weights are ``render/lpips.py::random_arrays`` of a seed, put into torch's
layout, at the real shapes.  The stand-in holds lpips' layout, not its
pretrained weights; a mirror on the real package skips without it.
"""
import contextlib
import io
import os
import runpy
import sys
import types
import warnings

import numpy as np
import pytest
import torch
from torch import nn

import egonerf_tpu.render.lpips_jax as lpips_jax
from egonerf_tpu.tools import export_lpips as jax_mod
from egonerf_torch.render import lpips
from egonerf_torch.tools import export_lpips as port_mod

torch.set_num_threads(1)

NETS = ("alex", "vgg")
SEEDS = {"alex": 11, "vgg": 12}
# torchvision's features as (kind, in, out, kernel, stride, pad) and the
# index after each of lpips' five slices
FEATURES = {
    "alex": ([("conv", 3, 64, 11, 4, 2), ("relu",), ("pool", 3, 2),
              ("conv", 64, 192, 5, 1, 2), ("relu",), ("pool", 3, 2),
              ("conv", 192, 384, 3, 1, 1), ("relu",), ("conv", 384, 256, 3, 1, 1), ("relu",),
              ("conv", 256, 256, 3, 1, 1), ("relu",)],
             (2, 5, 8, 10, 12)),
    "vgg": ([layer for block in ([64, 64], [128, 128], [256] * 3, [512] * 3, [512] * 3)
             for layer in [("pool", 2, 2)] + [l for c in block for l in (("conv", c), ("relu",))]
             ][1:],
            (4, 9, 16, 23, 30)),
}
TAP_WIDTHS = {"alex": [64, 192, 384, 256, 256], "vgg": [64, 128, 256, 512, 512]}


def _layers(net):
    """torchvision's ``features`` of ``net`` as modules."""
    spec, _ = FEATURES[net]
    layers, c_in = [], 3
    for s in spec:
        if s[0] == "relu":
            layers.append(nn.ReLU(inplace=False))
        elif s[0] == "pool":
            layers.append(nn.MaxPool2d(s[1], s[2]))
        elif len(s) == 2:  # VGG: 3x3, stride 1, pad 1
            layers.append(nn.Conv2d(c_in, s[1], 3, 1, 1))
            c_in = s[1]
        else:
            layers.append(nn.Conv2d(s[1], s[2], s[3], s[4], s[5]))
            c_in = s[2]
    return layers


class _Backbone(nn.Module):
    """lpips' ``pretrained_networks.alexnet`` / ``vgg16``: slice1..slice5."""

    def __init__(self, net):
        super().__init__()
        layers, cuts = _layers(net), FEATURES[net][1]
        start = 0
        for k, stop in enumerate(cuts):
            block = nn.Sequential()
            for x in range(start, stop):
                block.add_module(str(x), layers[x])
            setattr(self, f"slice{k + 1}", block)
            start = stop


class _NetLinLayer(nn.Module):
    def __init__(self, chn_in):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(chn_in, 1, 1, 1, 0, bias=False))


class _LPIPS(nn.Module):
    def __init__(self, net="alex", version="0.1"):
        super().__init__()
        assert version == "0.1"
        self.net = _Backbone(net)
        self.lins = nn.ModuleList([_NetLinLayer(c) for c in TAP_WIDTHS[net]])
        arrays = lpips.random_arrays(net, SEEDS[net])
        convs = [m for m in self.net.modules() if isinstance(m, nn.Conv2d)]
        with torch.no_grad():
            for i, conv in enumerate(convs):
                conv.weight.copy_(torch.from_numpy(arrays[f"conv{i}_w"].transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.from_numpy(arrays[f"conv{i}_b"]))
            for j, lin in enumerate(self.lins):
                lin.model[-1].weight.copy_(
                    torch.from_numpy(arrays[f"lin{j}_w"]).view(1, -1, 1, 1))


@pytest.fixture
def standin(monkeypatch):
    """The stand-in ``lpips`` module in ``sys.modules`` for the test."""
    mod = types.ModuleType("lpips")
    mod.LPIPS = _LPIPS
    monkeypatch.setitem(sys.modules, "lpips", mod)
    return mod


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _export(fn, *args):
    """(path, printed) of one export; the file's arrays read back."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = fn(*args)
    return path, out.getvalue(), _npz(path)


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("net", NETS)
def test_export_into_out_dir_matches_jax(standin, tmp_path, net):
    """Into a given folder: the same path, printed line, keys, shapes and
    bytes as JAX's export; the arrays are the stand-in's seeded weights in
    the npz layout (HWIO convolutions, flattened heads)."""
    out_dir = str(tmp_path / "weights")
    want_path, want_out, want = _export(jax_mod.export, net, out_dir)
    os.remove(want_path)
    got_path, got_out, got = _export(port_mod.export, net, out_dir)
    assert got_path == want_path == os.path.join(out_dir, f"lpips_{net}.npz")
    assert got_out == want_out == f"wrote {got_path}: {sorted(got)}\n"
    _assert_same_arrays(got, want)
    _assert_same_arrays(got, lpips.random_arrays(net, SEEDS[net]))
    assert len([k for k in got if k.startswith("conv") and k.endswith("_w")]) == (
        5 if net == "alex" else 13)


@pytest.mark.parametrize("net", NETS)
def test_export_to_the_discovery_path_matches_jax(standin, tmp_path, monkeypatch, net):
    """Without a folder both write ``$EGONERF_LPIPS_WEIGHTS_DIR/lpips_{net}.npz``
    (the path both LPIPS graphs read) with the same bytes and line; the
    port's ``rgb_lpips`` on the port's file gives JAX's ``rgb_lpips_jax``
    on JAX's within rel 1e-5 (``test_torch_metrics.py``'s graph tolerance:
    float32 convolutions summed in other orders)."""
    monkeypatch.setenv("EGONERF_LPIPS_WEIGHTS_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(lpips, "_PARAM_CACHE", {})
    monkeypatch.setattr(lpips_jax, "_PARAM_CACHE", {})
    want_path, want_out, want = _export(jax_mod.export, net)
    rng = np.random.default_rng(5)
    im0, im1 = rng.random((2, 64, 64, 3)).astype(np.float32)
    want_d = lpips_jax.rgb_lpips_jax(im0, im1, net)
    os.remove(want_path)
    got_path, got_out, got = _export(port_mod.export, net)
    assert got_path == want_path == lpips.weights_path(net) == lpips_jax.weights_path(net)
    assert got_out == want_out
    _assert_same_arrays(got, want)
    got_d = lpips.rgb_lpips(im0, im1, net, device="cpu")
    assert got_d > 0.0 and got_d == pytest.approx(want_d, rel=1e-5)


def test_export_needs_the_lpips_package(tmp_path, monkeypatch):
    """Without ``lpips`` both raise ``ModuleNotFoundError`` and write
    nothing."""
    monkeypatch.setitem(sys.modules, "lpips", None)
    for mod in (jax_mod, port_mod):
        with pytest.raises(ModuleNotFoundError) as info:
            mod.export("alex", str(tmp_path))
        assert info.value.name == "lpips"
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("argv", [["vgg"], ["alex", "OUT"]], ids=["net", "net_out_dir"])
def test_command_line_matches_jax(standin, tmp_path, monkeypatch, argv):
    """``python -m ...export_lpips [net] [out_dir]``: both modules' command
    lines print the same line and write the same file."""
    monkeypatch.setenv("EGONERF_LPIPS_WEIGHTS_DIR", str(tmp_path / "cache"))
    argv = [str(tmp_path / "out") if a == "OUT" else a for a in argv]
    printed, files = [], []
    for name in ("egonerf_tpu.tools.export_lpips", "egonerf_torch.tools.export_lpips"):
        monkeypatch.setattr(sys, "argv", [name, *argv])
        out = io.StringIO()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            # the module is imported already: runpy says so and runs it anew
            warnings.simplefilter("ignore", RuntimeWarning)
            runpy.run_module(name, run_name="__main__")
        printed.append(out.getvalue())
        path = printed[-1].split()[1].rstrip(":")
        files.append(_npz(path))
        os.remove(path)
    assert printed[0] == printed[1] and f"lpips_{argv[0]}.npz" in printed[0]
    _assert_same_arrays(files[1], files[0])


@pytest.mark.skipif(__import__("importlib").util.find_spec("lpips") is None,
                    reason="the lpips package is not installed")
@pytest.mark.parametrize("net", NETS)
def test_real_lpips_export_matches_jax(tmp_path, net):
    """Where the pip ``lpips`` package and its weights are present: both
    exports of its pretrained weights are equal byte for byte."""
    _, want_out, want = _export(jax_mod.export, net, str(tmp_path / "jax"))
    _, got_out, got = _export(port_mod.export, net, str(tmp_path / "port"))
    _assert_same_arrays(got, want)
    assert got_out.split(":", 1)[1] == want_out.split(":", 1)[1]
