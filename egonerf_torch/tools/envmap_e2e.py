"""The envmap recipe end to end on the card (counterpart of
``egonerf_tpu/tools/envmap_e2e.py``).

Trains the envmap model family (the envmap's pretrain, then the volume
and the envmap together, the reference's outdoor recipe: train.py:218-242,
models/EgoNeRF.py:586-591) on the procedural scene's ``env`` variant,
whose wall texture sits at infinity: the model must put the spheres into
the volume and the texture into the envmap.  ``N_ITERS`` steps after
``PRETRAIN`` pretrain steps, N_voxel 8e6, 12 + 2 views at 800x400.

    python -m egonerf_torch.tools.envmap_e2e

runs on the card, trains in ``build/envmap_e2e/envmap_e2e`` (the renders,
the bg maps, ``envmap.png`` and ``mean.json`` under its ``imgs_test_all``)
and writes ``docs/torch/results_envmap_e2e.json`` (JAX's keys and
``device``, the card's name and power limit).
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import RUNS_DIR, device_name, rel, write_results

N_ITERS = 3000
PRETRAIN = 500
IMG_H, IMG_W = 400, 800
N_TRAIN, N_TEST = 12, 2
N_VOXEL = 8_000_000


def spec(**deltas):
    """The recipe's ``(cfg, scene)`` without training: JAX's config fields
    (``basedir`` the repository's ``build/envmap_e2e``).  ``deltas`` win."""
    from ..presets import production_overrides
    from ..train.config import load_config

    cfg = load_config(overrides=production_overrides(**{**dict(
        n_iters=N_ITERS, N_voxel_init=N_VOXEL, N_voxel_final=N_VOXEL,
        progress_refresh_rate=500, basedir=os.path.join(RUNS_DIR, "envmap_e2e"),
        expname="envmap_e2e", N_vis=-1, vis_list=str([N_ITERS]),
        # the outdoor-scene envmap recipe (reference:
        # configs/EgoNeRF/omniblender/lone_monk/common.txt:8-11, scaled to
        # this run's shorter schedule)
        use_envmap=True, envmap_res_H=500, iter_pretrain_envmap=PRETRAIN,
        render_test=True), **deltas}))
    scene = dict(n_train=N_TRAIN, n_test=N_TEST, height=IMG_H, width=IMG_W, background="env")
    return cfg, scene


def _run(device="cuda", scene=None, **deltas) -> dict:
    """Train the recipe on ``device`` (``deltas`` as :func:`spec`;
    ``scene`` overrides its views) in a fresh folder and return its
    record."""
    import shutil

    import numpy as np

    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    cfg, ds = spec(**deltas)
    ds = dict(ds, **(scene or {}))
    # a fresh run, always: a finished checkpoint would resume past the
    # pretrain and the training and report the old result
    shutil.rmtree(os.path.join(cfg.basedir, cfg.expname), ignore_errors=True)
    trainer = Trainer(cfg, device=dev)
    common = dict(ds, near_far=cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", is_stack=False, **common),
                         SyntheticEgoDataset(split="test", is_stack=True, **common))
    t0 = time.time()
    psnrs = trainer.train()
    wall = time.time() - t0
    with open(os.path.join(trainer.logdir, "imgs_test_all", "mean.json")) as f:
        metrics = json.load(f)
    return {
        "config": {"n_iters": cfg.n_iters, "iter_pretrain_envmap": cfg.iter_pretrain_envmap,
                   "envmap_res_H": cfg.envmap_res_H, "n_voxel": cfg.N_voxel_final,
                   "views": f"{ds['n_train']}+{ds['n_test']} @ {ds['width']}x{ds['height']}",
                   "background": "env (texture at infinity)"},
        "metrics": metrics,
        "final_test_psnr": round(float(np.mean(psnrs)), 3),
        "wall_s": round(wall, 1),
        "artifacts": rel(trainer.logdir),
        "device": device_name(dev),
    }


def main(argv=None):
    from .._device import resolve_device

    del argv  # JAX's tool takes no arguments
    resolve_device("cuda")
    rec = _run()
    write_results("envmap_e2e", rec)
    print(json.dumps(rec, indent=1), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
