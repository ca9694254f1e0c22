"""The upstream PyTorch EgoNeRF's side of the checkpoint bridge, shared by
``import_reference_ckpt`` and ``export_reference_ckpt`` (the port's copy
of the two helpers the JAX package keeps in
``egonerf_tpu/tools/headtohead_reference.py:61-114``).

The upstream modules import vision and GUI packages that the checkpoint
paths never use; :func:`_stub_ref_deps` gives them empty stand-ins so that
``models.*`` imports.  :func:`_copy_params_to_ref` maps the port's stacked
yin/yang tables into the upstream EgoNeRF's per-chart ``ParameterList``s:
planes ``(2, H, W, C)`` -> two ``(1, C, H, W)``, lines ``(2, L, C)`` ->
two ``(1, C, L, 1)``, the basis ``(2, n_app, app_dim)`` -> two
``nn.Linear`` weights ``(app_dim, n_app)``, the shader's ``nn.Linear``
layers as they are, and the envmap ``(2h, h, 3)`` -> ``(3, 2h, h)``.
"""
from __future__ import annotations

import sys
import types
from contextlib import contextmanager
from typing import Mapping

import torch

#: where the upstream checkout is looked for by default, as the JAX
#: package's tools and ``tests/test_reference_parity.py`` look for it
REFERENCE = "/root/reference"


def _stub_ref_deps() -> None:
    """Empty modules for torchvision, kornia, cv2, plyfile and skimage
    wherever none is imported yet (``sys.modules.setdefault``, as JAX's)."""
    def stub(name, **attrs):
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        sys.modules.setdefault(name, mod)

    stub("torchvision")
    stub("torchvision.transforms", ToTensor=lambda: None)
    sys.modules["torchvision"].transforms = sys.modules["torchvision.transforms"]
    stub("kornia", create_meshgrid=lambda *a, **k: None)
    stub("cv2", COLORMAP_JET=2, applyColorMap=lambda *a, **k: None)
    stub("plyfile", PlyData=None, PlyElement=None)
    stub("skimage")
    stub("skimage.measure", marching_cubes=None)
    sys.modules["skimage"].measure = sys.modules["skimage.measure"]


@contextmanager
def on_path(reference: str):
    """``reference`` first on ``sys.path`` for the imports (and unpickling)
    inside the block, then taken off again."""
    sys.path.insert(0, reference)
    try:
        yield
    finally:
        sys.path.pop(0)


def _copy_params_to_ref(ref, params: Mapping[str, torch.Tensor]) -> None:
    """The port's EgoNeRF parameters (``state_dict`` names, any device)
    into the upstream EgoNeRF ``ref``, then its coarse sigma grid."""
    def host(name):
        return params[name].detach().cpu()

    with torch.no_grad():
        for i in range(3):
            for name in ("density", "app"):
                plane = host(f"{name}_planes.{i}")
                line = host(f"{name}_lines.{i}")
                for s, chart in enumerate(("yin", "yang")):
                    getattr(ref, f"{name}_plane_{chart}")[i].copy_(plane[s].permute(2, 0, 1)[None])
                    getattr(ref, f"{name}_line_{chart}")[i].copy_(line[s].T[None, :, :, None])
        basis = host("basis")
        ref.basis_mat_yin.weight.copy_(basis[0].T)
        ref.basis_mat_yang.weight.copy_(basis[1].T)
        layers = [ref.renderModule.mlp[0], ref.renderModule.mlp[2], ref.renderModule.mlp[4]]
        for layer, key in zip(layers, ("l1", "l2", "l3")):
            layer.weight.copy_(host(f"shader.{key}.weight"))
            layer.bias.copy_(host(f"shader.{key}.bias"))
        if "envmap" in params:
            ref.envmap.emission.copy_(host("envmap").permute(2, 0, 1))
        ref.update_coarse_sigma_grid()
