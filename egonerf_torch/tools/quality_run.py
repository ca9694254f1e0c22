"""Reproducible quality runs on the card (counterpart of
``egonerf_tpu/tools/quality_run.py``, the same seven presets).

Presets:

* ``refscale`` / ``refscale30k`` / ``refscale100k``: EgoNeRF at the
  reference's full production shape (2000x1000 equirectangular views,
  N_voxel 27e6 on the yin-yang grid, 128 + 128 samples, batch 4096) on the
  procedural wall scene at 10k / 30k / 100k steps (100k is the reference's
  schedule, ``configs/EgoNeRF/common.txt``).
* ``refscale30k_cluttered``: the 30k recipe on the cluttered scene (24
  more spheres through the volume).
* ``refscale10k_env`` / ``refscale30k_env``: the outdoor envmap recipe at
  the production shape on the ``env`` scene (background at infinity):
  near/far [0.01, 15], an envmap of ``envmap_res_H`` 500 pretrained for 1500
  steps.
* ``tensorf``: TensorVMSplit on the xyz chart (``presets.tensorf_overrides``,
  12 + 2 views at 1000x500).

    python -m egonerf_torch.tools.quality_run [preset] [--resume]

runs on the card (``refscale`` by default), trains in
``build/quality/<preset>`` (a fresh folder unless ``--resume``) and writes
``docs/torch/results_<preset>.json``: JAX's fields and ``device``, the
card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import RUNS_DIR, device_name, positional, rel, write_results

PRESETS = ("refscale", "refscale30k", "refscale100k", "refscale30k_cluttered",
           "refscale10k_env", "refscale30k_env", "tensorf")
# the steps of each production-shape preset
REFSCALE_ITERS = {"refscale": 10_000, "refscale30k": 30_000, "refscale100k": 100_000,
                  "refscale30k_cluttered": 30_000, "refscale10k_env": 10_000,
                  "refscale30k_env": 30_000}


def preset_spec(preset: str, **deltas):
    """A preset's ``(cfg, ds_kwargs)`` without training.  ``deltas`` are
    config overrides that win over the preset's (``chip_smoke.py`` cuts a
    run's steps so); without them every field is JAX's but ``basedir``,
    which is the repository's ``build/quality``.  An unknown preset raises
    JAX's ``SystemExit``."""
    from ..presets import TENSORF_QUALITY_SCENE, production_overrides, tensorf_overrides
    from ..train.config import load_config

    common = dict(progress_refresh_rate=500, basedir=os.path.join(RUNS_DIR, "quality"),
                  expname=preset, render_test=True,
                  # a checkpoint every 2000 steps, so a run that died resumes
                  # with --resume
                  i_weights=2000)
    if preset in REFSCALE_ITERS:
        n_iters = REFSCALE_ITERS[preset]
        if preset == "refscale100k":
            # the reference's full schedule: 10 checkpoints, not 50
            common["i_weights"] = 10_000
        ov = dict(n_iters=n_iters,
                  # near/far matched to the procedural wall at radius 8
                  near_far="[0.05, 8.5]", N_vis=-1,
                  vis_list=("[20000, 40000, 60000, 80000, 100000]" if n_iters > 30_000
                            else "[10000, 20000, 30000]" if n_iters > 10_000 else "[10000]"),
                  **common)
        if preset.endswith("_env"):
            # the outdoor recipe: the background at infinity, so the
            # production near/far; an envmap resolved to the background's
            # bandwidth and pretrained to ~12 samples a texel (JAX's
            # BASELINE.md "envmap at production shape")
            ov.update(near_far="[0.01, 15.0]", use_envmap=True, envmap_res_H=500,
                      iter_pretrain_envmap=1500)
        cfg = load_config(overrides=production_overrides(**{**ov, **deltas}))
        ds = dict(n_train=12, n_test=2, height=1000, width=2000)
        if preset.endswith("_cluttered"):
            ds["background"] = "cluttered"
        elif preset.endswith("_env"):
            ds["background"] = "env"
    elif preset == "tensorf":
        cfg = load_config(overrides=tensorf_overrides(**{**common, **deltas}))
        ds = dict(TENSORF_QUALITY_SCENE)
    else:
        raise SystemExit(f"unknown preset {preset!r} (refscale|refscale30k|"
                         f"refscale100k|refscale30k_cluttered|"
                         f"refscale10k_env|refscale30k_env|tensorf)")
    return cfg, ds


def _run(preset: str, resume: bool = False, device="cuda", **deltas) -> dict:
    """Train ``preset`` on ``device`` (``deltas`` as :func:`preset_spec`)
    and return its record.  A fresh run removes the preset's folder first:
    the trainer resumes from any checkpoint it finds, which would evaluate
    a stale run; ``resume`` keeps it to continue a run that died."""
    import numpy as np

    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    cfg, ds = preset_spec(preset, **deltas)
    if not resume:
        import shutil

        shutil.rmtree(os.path.join(cfg.basedir, cfg.expname), ignore_errors=True)
    trainer = Trainer(cfg, device=dev)
    dsc = dict(near_far=cfg.near_far, **ds)
    trainer.set_datasets(SyntheticEgoDataset(split="train", is_stack=False, **dsc),
                         SyntheticEgoDataset(split="test", is_stack=True, **dsc))
    t0 = time.time()
    psnrs = trainer.train()
    wall = time.time() - t0
    with open(os.path.join(trainer.logdir, "imgs_test_all", "mean.json")) as f:
        metrics = json.load(f)
    return {
        "preset": preset, "model": cfg.model_name,
        "n_iters": cfg.n_iters, "n_voxel_final": cfg.N_voxel_final,
        "views": f"{ds['n_train']}+{ds['n_test']} @ {ds['width']}x{ds['height']}",
        "metrics": metrics,
        "final_test_psnr": round(float(np.mean(psnrs)), 3),
        # on --resume, wall_s covers only the continued tail of the run
        "wall_s": round(wall, 1), "resumed_at": trainer.start_step or None,
        "artifacts": rel(trainer.logdir),
        "device": device_name(dev),
    }


def main(argv=None):
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device("cuda")
    args = positional(argv)
    preset = args[0] if args else "refscale"
    rec = _run(preset, resume="--resume" in argv)
    print(json.dumps(rec, indent=1), flush=True)
    write_results(preset, rec)


if __name__ == "__main__":
    main()
