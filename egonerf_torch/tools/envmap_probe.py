"""Factorization probe of an envmap run on the procedural ``env`` scene
(counterpart of ``egonerf_tpu/tools/envmap_probe.py``).

Three numbers decide whether an envmap run factorized the scene (an
unconverged envmap lets the volume take the background as an opaque far
shell, which does not generalize across poses):

  1. the envmap's PSNR alone against the ground-truth texture at infinity
     (did the map learn?), its radiance through K8;
  2. the held-out PSNR split into background and foreground pixels (a
     ground-truth depth of 0 marks the background, ``data/synthetic.py``);
  3. the background's share of the pixels.

It reads the checkpoint's envmap and the saved test renders
(``imgs_test_all/*.png``, decoded by ``data/png.py``), and makes the
ground truth again from the procedural scene.

    python -m egonerf_torch.tools.envmap_probe [logdir]

runs on the card (logdir ``build/quality/refscale10k_env``, the
``quality_run`` preset, by default) and writes
``docs/torch/results_envmap_probe.json`` (with ``device``, the card's name
and power limit).  ``_run`` takes the scene's size.
"""
from __future__ import annotations

import os
import sys

from . import RUNS_DIR, device_name, rel, write_results


def _psnr(mse: float) -> float:
    import numpy as np

    return float(-10.0 * np.log10(max(mse, 1e-12)))


def envmap_vs_gt_psnr(emission, h: int = 250, w: int = 500) -> float:
    """PSNR of the envmap ``emission`` (2h', h', 3) alone against the
    ground-truth texture at infinity on an h x w equirectangular direction
    grid; the radiance is K8's on a CUDA tensor, the plain version's on the
    host."""
    import numpy as np
    import torch

    from ..data.ray_utils import get_ray_directions_360
    from ..data.synthetic import _wall_color
    from ..models.envmap import envmap_radiance

    emission = torch.as_tensor(emission, dtype=torch.float32)
    dirs = get_ray_directions_360(h, w).reshape(-1, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    with torch.no_grad():
        pred = envmap_radiance(emission.contiguous(),
                               torch.as_tensor(dirs, dtype=torch.float32,
                                               device=emission.device))
    return _psnr(float(((pred.cpu().numpy() - _wall_color(dirs)) ** 2).mean()))


def bg_fg_split(render, gt_rgb, bg_mask) -> dict:
    """Held-out error split by the ground truth's background mask (float
    arrays in [0, 1]; ``bg_mask`` a bool a pixel)."""
    import numpy as np

    err = (np.asarray(render) - np.asarray(gt_rgb)) ** 2
    bg = np.asarray(bg_mask)
    return {
        "psnr_bg": round(_psnr(float(err[bg].mean())), 2),
        "psnr_fg": round(_psnr(float(err[~bg].mean())), 2),
        "bg_pixel_fraction": round(float(bg.mean()), 3),
    }


def _run(logdir: str, n_train: int = 12, n_test: int = 2, height: int = 1000,
         width: int = 2000, device="cuda") -> dict:
    import numpy as np
    import torch

    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..data.png import read_image
    from ..train.checkpoint import latest_checkpoint
    from ..train.config import load_config

    dev = resolve_device(device)
    cfg = load_config(os.path.join(logdir, "args.txt"))
    ckpt_path = cfg.ckpt or latest_checkpoint(logdir)
    if not ckpt_path or not os.path.exists(ckpt_path):
        raise SystemExit(f"no checkpoint under {logdir}")
    # only the envmap entry is read, not the grid tables
    with np.load(ckpt_path) as ck:
        if "envmap" not in ck.files:
            raise SystemExit(f"{ckpt_path} has no envmap parameter "
                             f"(not a use_envmap run)")
        emission = ck["envmap"].astype(np.float32)

    ds = SyntheticEgoDataset(split="test", is_stack=True, n_train=n_train,
                             n_test=n_test, height=height, width=width,
                             background="env", near_far=cfg.near_far)
    gt = np.asarray(ds.all_rgbs).reshape(n_test, height, width, 3)
    dep = np.asarray(ds.all_depths).reshape(n_test, height, width)

    per_image = []
    for k in range(n_test):
        path = os.path.join(logdir, "imgs_test_all", f"{k:03d}.png")
        if not os.path.exists(path):
            raise SystemExit(f"missing render {path}: run the evaluation "
                             f"first (quality_run leaves imgs_test_all/)")
        im = read_image(path)[..., :3].astype(np.float32) / 255.0
        per_image.append(bg_fg_split(im, gt[k], dep[k] == 0))

    return {
        "logdir": rel(logdir),
        "checkpoint": os.path.basename(ckpt_path),
        "envmap_res": list(emission.shape[:2]),
        "envmap_only_psnr_vs_gt_texture":
            round(envmap_vs_gt_psnr(torch.as_tensor(emission, device=dev)), 2),
        "per_image": per_image,
        "device": device_name(dev),
    }


def main(argv=None):
    import json

    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device("cuda")
    logdir = argv[0] if argv else os.path.join(RUNS_DIR, "quality", "refscale10k_env")
    rec = _run(logdir)
    print(json.dumps(rec, indent=1), flush=True)
    write_results("envmap_probe", rec)


if __name__ == "__main__":
    main()
