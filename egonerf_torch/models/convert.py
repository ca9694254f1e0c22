"""Weights carried across from the JAX package.

JAX checkpoints (``egonerf_tpu/train/checkpoint.py``) are an ``.npz`` of
the flattened parameter tree under ``/``-joined keys (``density_planes/0``,
``basis``, ``shader/l1/w``, ...) plus a JSON ``__header__`` with the
``coords_spec`` and ``model_meta``.  Plane, line and basis arrays keep
their layout.  MLP weights are the one trap: JAX stores them (n_in, n_out),
``nn.Linear.weight`` is (out, in), so the converter transposes them.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..coords import coords_from_spec
from .egonerf import EgoNeRF, FieldConfig

_GRIDS = ("density_planes", "density_lines", "app_planes", "app_lines")
_LINEAR = {"w": "weight", "b": "bias"}


def _to_torch_key(key: str) -> Tuple[str, bool]:
    """JAX flat key -> (state_dict key, transpose?)."""
    parts = key.split("/")
    if parts[0] in _GRIDS and len(parts) == 2:
        return f"{parts[0]}.{parts[1]}", False
    if parts == ["basis"]:
        return "basis", False
    if parts[0] == "shader" and len(parts) == 3 and parts[2] in _LINEAR:
        return f"shader.{parts[1]}.{_LINEAR[parts[2]]}", parts[2] == "w"
    raise NotImplementedError(f"parameter {key!r} has no counterpart in the port yet "
                              f"(ROADMAP.md)")


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
        elif name == "basis":
            key = "basis"
        else:
            raise NotImplementedError(f"parameter {name!r} has no JAX counterpart")
        out[key] = a
    return out


def load_jax_checkpoint(path: str, near_far=(0.01, 15.0), device="cuda"):
    """Read a JAX ``.npz`` checkpoint with numpy alone.  Builds the chart
    from ``coords_spec`` and the model from ``model_meta`` (``near_far`` is
    not stored; it comes from the dataset), loads the weights into it and
    returns (model, params, header)."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        flat = {k: data[k] for k in header["param_keys"]}
    if header.get("alpha_masks"):
        raise NotImplementedError("checkpoints with an alpha mask are not "
                                  "ported yet (ROADMAP.md)")
    meta = dict(header["model_meta"])
    if meta.get("model_name", "EgoNeRF") != "EgoNeRF":
        raise NotImplementedError(f"model {meta['model_name']!r} is not ported yet "
                                  f"(ROADMAP.md)")
    coords = coords_from_spec(header["coords_spec"])
    model = EgoNeRF(coords.aabb, coords.resolution, coords, FieldConfig.from_meta(meta),
                    near_far=near_far, device=device)
    model.load_state_dict(params_from_jax(flat, device=device))
    return model, model.params(), header
