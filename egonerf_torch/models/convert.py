"""Weights carried across from the JAX package.

JAX checkpoints (``egonerf_tpu/train/checkpoint.py``) are an ``.npz`` of
the flattened parameter tree under ``/``-joined keys (``density_planes/0``,
``basis``, ``shader/l1/w``, ``envmap``, ...) plus a JSON ``__header__``
with the ``coords_spec`` and ``model_meta``, and the bit-packed alpha
masks.  Plane, line, basis and envmap arrays keep their layout (the
envmap channel-last (2h, h, 3)), for EgoNeRF's stacked grids, the
single ones of TensorVMSplit and TensorVM, and TensorCP's lines with no
plane alike.
MLP weights are the one trap: JAX stores them (n_in, n_out),
``nn.Linear.weight`` is (out, in), so the converter transposes them.  The
MLP shading modes (MLP_Fea, MLP_PE, MLP) store ``shader/l{1,2,3}/{w,b}``;
SH and RGB have no shader keys, in either package.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..coords import coords_from_spec
from ..ops.vm_lookup import VEC_MODE
from .alphamask import mask_from_volumes
from .egonerf import FieldConfig

_GRIDS = ("density_planes", "density_lines", "app_planes", "app_lines")
_LINEAR = {"w": "weight", "b": "bias"}


def _to_torch_key(key: str) -> Tuple[str, bool]:
    """JAX flat key -> (state_dict key, transpose?)."""
    parts = key.split("/")
    if parts[0] in _GRIDS and len(parts) == 2:
        return f"{parts[0]}.{parts[1]}", False
    if parts in (["basis"], ["envmap"]):
        return key, False
    if parts[0] == "shader" and len(parts) == 3 and parts[2] in _LINEAR:
        return f"shader.{parts[1]}.{_LINEAR[parts[2]]}", parts[2] == "w"
    raise NotImplementedError(f"parameter {key!r} has no counterpart in the port")


def params_from_jax(flat: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """JAX flat parameter dict -> ``state_dict``-named tensors on ``device``."""
    dev = resolve_device(device)
    out = {}
    for key, value in flat.items():
        name, transpose = _to_torch_key(key)
        t = torch.from_numpy(np.array(value))
        out[name] = (t.T.contiguous() if transpose else t).to(dev)
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_jax`: numpy arrays under JAX flat keys."""
    out = {}
    for name, t in params.items():
        parts = name.split(".")
        a = t.detach().cpu().numpy()
        if parts[0] == "shader":
            inv = {v: k for k, v in _LINEAR.items()}
            key = f"shader/{parts[1]}/{inv[parts[2]]}"
            a = np.ascontiguousarray(a.T) if parts[2] == "weight" else a
        elif parts[0] in _GRIDS:
            key = f"{parts[0]}/{parts[1]}"
        elif name in ("basis", "envmap"):
            key = name
        else:
            raise NotImplementedError(f"parameter {name!r} has no JAX counterpart")
        out[key] = a
    return out


def stored_grid_size(flat: Dict[str, np.ndarray]) -> list:
    """The grid size of a checkpoint's parameters, read off its density
    lines (each (S, L, C), line i along axis ``VEC_MODE[i]``)."""
    gs = [0, 0, 0]
    for i, axis in enumerate(VEC_MODE):
        gs[axis] = int(np.shape(flat[f"density_lines/{i}"])[1])
    return gs


def load_params(model, coords, flat: Dict[str, np.ndarray]) -> None:
    """Load a checkpoint's parameters into ``model``, built at
    :func:`stored_grid_size`.  Where the chart's resolution differs from
    that grid (the directional balanced chart, whose ``set_resolution``
    halves the radius) the march step follows the chart's, as JAX's resume
    builds its model at the chart's resolution
    (``egonerf_tpu/train/trainer.py:162-164``)."""
    model.load_state_dict(params_from_jax(flat, device=model.device))
    if list(coords.resolution) != list(model.grid_size):
        model.update_step_size(coords.resolution)


def load_jax_checkpoint(path: str, near_far=(0.01, 15.0), device="cuda"):
    """Read a JAX ``.npz`` checkpoint with numpy alone.  Builds the chart
    from ``coords_spec`` and the model (EgoNeRF or a TensoRF member) from
    ``model_meta`` (``near_far`` is not stored; it comes from the dataset),
    loads the weights and the alpha mask into it and returns (model,
    params, header)."""
    from . import model_class
    from ..train.checkpoint import load_alpha_masks, load_checkpoint

    flat, header = load_checkpoint(path)
    meta = dict(header["model_meta"])
    coords = coords_from_spec(header["coords_spec"])
    model = model_class(meta.get("model_name", "EgoNeRF"))(
        coords.aabb, stored_grid_size(flat), coords, FieldConfig.from_meta(meta),
        near_far=near_far, device=device)
    load_params(model, coords, flat)
    masks = load_alpha_masks(path)
    if masks:
        model.alpha_mask = mask_from_volumes([masks[k] for k in sorted(masks)], model.device)
    return model, model.params(), header
