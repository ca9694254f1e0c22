"""Eval-path throughput and ``eval_keep`` cull ablation from a checkpoint on
the card (counterpart of ``egonerf_tpu/tools/eval_bench.py``).

Times the full-image render (the reference prints the same "elapsed time
per image", reference: renderer.py:68-75) of test view 0 at each
``eval_keep`` in a sweep (0: the exact unculled path), and reports for
each the seconds an image, rays/s, the PSNR against the ground truth and
against the unculled render.  A trailing ``o`` on a keep (``192o``) scores
that row with the cull's full-resolution oracle instead of the coarse
pass (``EgoNeRF.forward``'s ``eval_keep_score``).  Each render is timed
between device synchronizations, its outputs left on the card.

    python -m egonerf_torch.tools.eval_bench [logdir] [keep,keep,...]

runs on the card (logdir ``build/quality/refscale``, keeps 0,192,128,96,64
by default) and writes ``docs/torch/results_eval_bench.json``, or
``results_$EGONERF_RESULTS_NAME.json`` (with ``device``, the card's name
and power limit).  The logdir holds ``args.txt`` and a checkpoint of a
procedural-scene run (``quality_run refscale``).
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import RUNS_DIR, device_name, positional, rel, write_results


def _parse(k):
    """A keep as (keep, score): ``192o`` takes the oracle scorer."""
    k = str(k)
    return (int(k[:-1]), "oracle") if k.endswith("o") else (int(k), "coarse")


def _run(logdir: str, keeps, n_repeats: int = 2, n_train: int = 12, n_test: int = 2,
         height: int = 1000, width: int = 2000, device="cuda") -> dict:
    import numpy as np
    import torch

    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..render.metrics import psnr as psnr_fn
    from ..render.renderer import Renderer
    from ..train.checkpoint import latest_checkpoint
    from ..train.config import load_config
    from ..train.trainer import _load_model

    dev = resolve_device(device)
    cfg = load_config(os.path.join(logdir, "args.txt"))
    ckpt_path = cfg.ckpt or latest_checkpoint(logdir)
    if not ckpt_path or not os.path.exists(ckpt_path):
        raise SystemExit(f"no checkpoint under {logdir}")

    test_ds = SyntheticEgoDataset(split="test", is_stack=True, n_train=n_train,
                                  n_test=n_test, height=height, width=width,
                                  near_far=cfg.near_far)
    model, _ = _load_model(cfg, ckpt_path, test_ds.scene_bbox, test_ds.near_far, dev)
    params = model.params()

    h, w = test_ds.img_wh[1], test_ds.img_wh[0]
    gt = np.asarray(test_ds.all_rgbs[0]).reshape(h, w, 3)
    n_rays = h * w

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the unculled render (keep 0) is the reference of every other row's
    # psnr_vs_full, so it always runs, and first
    keeps = sorted(dict.fromkeys(_parse(k) for k in keeps), key=lambda ks: ks != (0, "coarse"))
    if keeps[:1] != [(0, "coarse")]:
        keeps.insert(0, (0, "coarse"))

    rows = []
    rgb_full = None
    for keep, score in keeps:
        renderer = Renderer.from_config(model, cfg, test_ds.white_bg, eval_keep=int(keep),
                                        eval_keep_score=score)
        renderer.set_directions(test_ds.directions)
        pose = test_ds.poses[0]
        out = renderer.render_view(params, pose)  # warm
        times = []
        for _ in range(n_repeats):
            sync()
            t0 = time.perf_counter()
            out = renderer.render_view(params, pose)
            sync()
            times.append(time.perf_counter() - t0)
        rgb = out["rgb"].reshape(h, w, 3).cpu().numpy()
        if int(keep) == 0:
            rgb_full = rgb
        row = {
            "eval_keep": int(keep),
            "score": score,
            "sec_per_image": round(min(times), 3),
            "rays_per_sec": round(n_rays / min(times), 1),
            "psnr_vs_gt": round(float(psnr_fn(rgb, gt)), 3),
            "psnr_vs_full": (round(float(psnr_fn(rgb, rgb_full)), 3)
                             if rgb_full is not None and int(keep) != 0 else None),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    return {"logdir": rel(logdir), "ckpt": rel(ckpt_path), "image": f"{w}x{h}",
            "n_samples": f"{cfg.n_coarse}+{cfg.n_fine}",
            "platform": dev.type, "device": device_name(dev), "rows": rows}


def main(argv=None):
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device("cuda")
    args = positional(argv)
    logdir = args[0] if args else os.path.join(RUNS_DIR, "quality", "refscale")
    keeps = args[1].split(",") if len(args) > 1 else [0, 192, 128, 96, 64]
    rec = _run(logdir, keeps)
    print(json.dumps(rec, indent=1), flush=True)
    # EGONERF_RESULTS_NAME: a sweep of another purpose (the oracle rows)
    # lands beside the eval_bench record, not over it
    write_results(os.environ.get("EGONERF_RESULTS_NAME", "eval_bench"), rec)


if __name__ == "__main__":
    main()
