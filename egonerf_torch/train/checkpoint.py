"""Checkpoints in the JAX package's format (counterpart of
``egonerf_tpu/train/checkpoint.py``): an ``.npz`` of the parameters under
JAX's flat keys (``density_planes/0``, ``basis``, ``shader/l1/w``, ...)
plus a JSON ``__header__`` with ``global_step``, ``coords_spec``,
``model_meta`` and ``param_keys``.  JAX's ``load_checkpoint`` reads what
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
                    coords_spec: dict, model_meta: dict) -> None:
    arrays = params_to_jax(dict(params))
    header = {
        "global_step": int(global_step),
        "coords_spec": coords_spec,
        "model_meta": model_meta,
        "param_keys": sorted(arrays.keys()),
    }
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path: str):
    """(flat parameters under JAX keys, header).  Checkpoints with alpha
    masks raise: the port has no alpha mask yet."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        if header.get("alpha_masks"):
            raise NotImplementedError("checkpoints with an alpha mask are not "
                                      "ported yet (ROADMAP.md §1)")
        flat = {k: data[k] for k in header["param_keys"]}
    return flat, header


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
