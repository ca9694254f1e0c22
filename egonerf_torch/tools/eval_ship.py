"""The shipped evaluation end to end (counterpart of
``egonerf_tpu/tools/eval_ship.py``): ``evaluation()`` at the production
image shape, every metric and the PNGs included, each view's host work on
the worker thread while the next view renders (``evaluation``'s default
overlap).

This is what a user waits for under ``--evaluation 1``.  The weights are a
seeded random init: the time depends on the shapes, not on the values.
One warm pass renders a view first (the kernels' first launches), then
``n_images`` views are timed on the host clock; ``evaluation`` returns
once every view's outputs are on the host and its files written.  Without
an LPIPS weights file the LPIPS columns stay nan / null, as in JAX.

    python -m egonerf_torch.tools.eval_ship [n_images]

runs on the card (4 views of 2000x1000) and writes
``docs/torch/results_eval_ship.json`` (JAX's keys and ``device``, the
card's name and power limit).
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import RUNS_DIR, device_name, positional, write_results


def scene_trainer(name: str, n_test: int, height: int, width: int, device, **deltas):
    """A trainer of the production shape (``deltas`` win) on the procedural
    scene, 2 training views and ``n_test`` test views of ``width`` x
    ``height``, in ``build/<name>``; its parameters the seeded random init
    (shared by ``eval_ship``, ``eval_probe`` and
    ``profile_step.capture_eval``)."""
    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..presets import production_overrides
    from ..train.config import load_config
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    cfg = load_config(overrides=production_overrides(**{**dict(
        n_iters=1, basedir=os.path.join(RUNS_DIR, name), expname=name, N_vis=0), **deltas}))
    trainer = Trainer(cfg, device=dev)
    common = dict(n_train=2, n_test=n_test, height=height, width=width, near_far=cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", is_stack=False, **common),
                         SyntheticEgoDataset(split="test", is_stack=True, **common))
    return trainer


def _run(n_images: int = 4, height: int = 1000, width: int = 2000, device="cuda",
         **deltas) -> dict:
    from ..render.renderer import Renderer, evaluation

    trainer = scene_trainer("eval_ship", n_images, height, width, device, **deltas)
    cfg, test_ds = trainer.cfg, trainer.test_dataset
    renderer = Renderer.from_config(trainer.model, cfg, test_ds.white_bg)
    out_dir = os.path.join(cfg.basedir, "imgs")
    # the warm pass: every kernel of the loop launched once
    evaluation(test_ds, trainer.model, trainer.params, renderer, save_path=out_dir, n_vis=1,
               compute_extra_metrics=False, save_images=True)
    t0 = time.time()
    evaluation(test_ds, trainer.model, trainer.params, renderer, save_path=out_dir, n_vis=-1,
               compute_extra_metrics=True, save_images=True)
    wall = time.time() - t0
    return {"image": f"{width}x{height}", "n_images": n_images, "chunk": cfg.eval_chunk,
            "includes": "render + fetch + psnr/ssim/ws-ssim + png encoding",
            "sec_per_image_amortized": round(wall / n_images, 3),
            "rays_per_sec": round(height * width * n_images / wall, 1),
            "platform": trainer.device.type, "device": device_name(trainer.device)}


def main(argv=None) -> dict:
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device("cuda")
    args = positional(argv)
    rec = _run(int(args[0]) if args else 4)
    print(json.dumps(rec, indent=1), flush=True)
    write_results("eval_ship", rec)
    return rec


if __name__ == "__main__":
    main()
