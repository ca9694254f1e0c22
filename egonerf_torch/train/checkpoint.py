"""Checkpoints in the JAX package's format (counterpart of
``egonerf_tpu/train/checkpoint.py``): an ``.npz`` of the parameters under
JAX's flat keys (``density_planes/0``, ``basis``, ``shader/l1/w``, ...)
plus a JSON ``__header__`` with ``global_step``, ``coords_spec``,
``model_meta`` and ``param_keys``.  Alpha masks are bit-packed under
``__alphamask__/<name>`` with their shapes in the header's ``alpha_masks``,
as JAX packs them.  JAX's ``load_checkpoint`` reads what
:func:`save_checkpoint` writes, and the port resumes from JAX's files.
Optimizer moments are not stored, as in JAX.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..models.convert import params_to_jax


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor], *, global_step: int,
                    coords_spec: dict, model_meta: dict,
                    alpha_masks: Optional[Mapping[str, np.ndarray]] = None) -> None:
    """``alpha_masks``: {name: boolean volume}, bit-packed into the file."""
    arrays = params_to_jax(dict(params))
    header = {
        "global_step": int(global_step),
        "coords_spec": coords_spec,
        "model_meta": model_meta,
        "param_keys": sorted(arrays.keys()),
    }
    if alpha_masks:
        header["alpha_masks"] = {}
        for name, vol in alpha_masks.items():
            vol = np.asarray(vol).astype(bool)
            arrays[f"__alphamask__/{name}"] = np.packbits(vol.reshape(-1))
            header["alpha_masks"][name] = list(vol.shape)
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path: str):
    """(flat parameters under JAX keys, header); :func:`load_alpha_masks`
    reads the masks."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        flat = {k: data[k] for k in header["param_keys"]}
    return flat, header


def load_alpha_masks(path: str) -> dict:
    """{name: boolean volume} of the alpha masks a checkpoint holds."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        masks = {}
        for name, shape in header.get("alpha_masks", {}).items():
            n = int(np.prod(shape))
            masks[name] = np.unpackbits(data[f"__alphamask__/{name}"])[:n].reshape(shape) > 0
    return masks


def mask_volumes(model) -> Optional[dict]:
    """The model's alpha mask as checkpoint volumes {alpha_i: (D, H, W)
    bool}, one per grid, as JAX's trainer saves them; None without one."""
    mask = getattr(model, "alpha_mask", None)
    if mask is None:
        return None
    vols = mask.vol.cpu().numpy() > 0
    return {f"alpha_{i}": vols[i] for i in range(vols.shape[0])}


def checkpoint_step(path: str) -> int:
    """The ``global_step`` stored in a checkpoint's header; -1 when the
    file is not a readable checkpoint."""
    try:
        with np.load(path, allow_pickle=False) as data:
            return int(json.loads(bytes(data["__header__"]).decode())["global_step"])
    except Exception:
        return -1


def latest_checkpoint(logdir: str) -> Optional[str]:
    """Newest ``.npz`` checkpoint in ``logdir`` by stored ``global_step``
    (mtime breaks ties), not by name: the final ``{expname}.npz`` sorts
    before ``{expname}_NNNNNN.npz``."""
    ckpts = glob.glob(os.path.join(logdir, "*.npz"))
    if not ckpts:
        return None
    return max(ckpts, key=lambda p: (checkpoint_step(p), os.path.getmtime(p)))
