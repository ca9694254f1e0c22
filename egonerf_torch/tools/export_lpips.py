"""Export LPIPS backbone + head weights to the npz schema that
``render/lpips.py`` (and the JAX package's ``render/lpips_jax.py``) reads
(counterpart of ``egonerf_tpu/tools/export_lpips.py``).

Run on any machine with the ``lpips`` package (and its pretrained
weights) installed:

    python -m egonerf_torch.tools.export_lpips [alex|vgg] [out_dir]

Writes ``lpips_{net}.npz`` into out_dir (default: the discovery path,
``$EGONERF_LPIPS_WEIGHTS_DIR`` or ``~/.cache/egonerf_tpu``, see
``render/lpips.py``).  Host work: the ``lpips`` model stays on the host
and only its weights are read.  Without the package it raises
``ModuleNotFoundError`` (reference wrapper: utils.py:77-104).
"""
from __future__ import annotations

import os
import sys

import numpy as np


def export(net: str = "alex", out_dir: str | None = None) -> str:
    import lpips  # type: ignore

    model = lpips.LPIPS(net=net, version="0.1").eval()
    arrays = {}
    # backbone convs in execution order: torch (Cout, Cin, H, W) -> HWIO
    convs = [m for m in model.net.modules()
             if m.__class__.__name__ == "Conv2d"]
    for i, conv in enumerate(convs):
        arrays[f"conv{i}_w"] = (
            conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0).astype(np.float32))
        arrays[f"conv{i}_b"] = conv.bias.detach().cpu().numpy().astype(np.float32)
    # LPIPS heads: 1x1 conv (1, C, 1, 1) without bias -> (C,)
    for j, lin in enumerate(model.lins):
        w = lin.model[-1].weight.detach().cpu().numpy()
        arrays[f"lin{j}_w"] = w.reshape(-1).astype(np.float32)

    from ..render.lpips import weights_path

    path = (os.path.join(out_dir, f"lpips_{net}.npz") if out_dir
            else weights_path(net))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)
    print(f"wrote {path}: {sorted(arrays)}")
    return path


if __name__ == "__main__":
    net = sys.argv[1] if len(sys.argv) > 1 else "alex"
    out = sys.argv[2] if len(sys.argv) > 2 else None
    export(net, out)
