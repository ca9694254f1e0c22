"""Occupied samples per ray of the merged eval sample set on a converged
model (counterpart of ``egonerf_tpu/tools/occ_probe.py``).

Whether an exact eval-time empty-space skip would pay (the reference's own
eval economy, a conservative alpha-mask gate: reference
models/tensorBase.py:464-469) depends on the trained field: the
distribution of K_i, the count of mask-occupied merged samples on ray i,
and the largest K_i of each chunk.  This probe loads a checkpoint, bakes
the dilated occupancy volume as ``EgoNeRF.update_alpha_mask`` does (at the
trainer's resolution cap of 128, threshold ``alpha_mask_thre``), runs the
eval forward's sampling stages on every ray of the test images (the
coarse chart K7, the coarse density K3, the resampling K4 with the fine
chart in its epilogue), samples the mask at the merged points (K9) and
reports the K histogram, the chunk maxima and the share of chunks and rays
within candidate budgets.

    python -m egonerf_torch.tools.occ_probe [logdir] [budgets]

runs on the card (logdir ``build/quality/refscale100k``, budgets
32,64,96,128,192 by default) and writes
``docs/torch/results_occ_probe.json`` (with ``device``, the card's name and
power limit).
"""
from __future__ import annotations

import json
import os
import sys

from . import RUNS_DIR, device_name, positional, rel, write_results


def occupied_per_ray(model, params, rays, n_coarse: int, n_fine: int, coarse=None):
    """(R,) int64 count of the merged eval samples of ``rays`` (R, 6) that
    the model's alpha mask holds occupied (alpha > 0): exponential coarse
    depths, their chart at half resolution (K7), the coarse density (K3)
    on the bf16 coarse grid (``coarse``: ``model.coarse_tables(params)``),
    the resampling and merge with the fine chart (K4's eval instantiation,
    the linspace draws), then the mask at every merged point (K9)."""
    import torch

    from ..models.egonerf import _dists

    cfg = model.cfg
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    n_rays = rays.shape[0]
    with torch.no_grad():
        coarse_z = model.sample_depths_exp(n_rays, n_coarse, rays.device)
        coarse_norm = model.ops.chart(rays_o, viewdirs, coarse_z, model.coordinates,
                                      2).reshape(n_rays, n_coarse, 4)
        c_planes, c_lines = coarse if coarse is not None else model.coarse_tables(params)
        c_feat = model._density(c_planes, c_lines, coarse_norm)
        _, _, norm = model.ops.resample_chart(
            c_feat, coarse_z, _dists(coarse_z), n_fine, None, True, cfg.density_shift,
            cfg.distance_scale, cfg.fea2dense_act, rays_o, viewdirs, model.coordinates)
        occ = model.alpha_mask.sample_alpha(norm) > 0.0
        return occ.reshape(n_rays, -1).sum(dim=-1)


def _run(logdir: str, budgets, n_train: int = 12, n_test: int = 2, height: int = 1000,
         width: int = 2000, chunk: int = 4096, device="cuda") -> dict:
    import numpy as np
    import torch

    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
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

    # bake the occupancy volume as the trainer's alpha-mask event does (the
    # mask an exact skip would gate on), at its capped resolution
    reso_mask = [min(int(r), 128) for r in model.grid_size]
    model.update_alpha_mask(params, reso_mask)
    coarse = model.coarse_tables(params)
    n_coarse, n_fine = int(cfg.n_coarse), int(cfg.n_fine)

    all_k = []
    for img in range(min(n_test, 2)):
        pose = np.asarray(test_ds.poses[img])
        dirs = np.asarray(test_ds.directions).reshape(-1, 3)
        rd = dirs @ pose[:3, :3].T
        ro = np.broadcast_to(pose[:3, 3], rd.shape)
        rays = torch.as_tensor(np.concatenate([ro, rd], -1).astype(np.float32), device=dev)
        # every ray counts: the tail is a chunk of its own
        for c0 in range(0, rays.shape[0], chunk):
            k = occupied_per_ray(model, params, rays[c0:c0 + chunk], n_coarse, n_fine, coarse)
            all_k.append(k.cpu().numpy())
    ks = np.concatenate(all_k)
    chunk_max = np.asarray([k.max() for k in all_k])
    s = n_coarse + n_fine
    qs = [0, 25, 50, 75, 90, 99, 99.9, 100]
    return {
        "logdir": rel(logdir), "ckpt": os.path.basename(ckpt_path),
        "mask_reso": reso_mask, "alpha_mask_thre": float(cfg.alpha_mask_thre),
        "n_samples_merged": s, "n_rays": int(ks.size),
        "n_chunks": int(chunk_max.size), "chunk": chunk,
        "occupied_sample_frac": round(float(ks.sum()) / (ks.size * s), 4),
        "k_percentiles": {str(q): int(np.percentile(ks, q)) for q in qs},
        "chunk_max_percentiles": {str(q): int(np.percentile(chunk_max, q)) for q in qs},
        "chunk_eligible_frac": {
            str(b): round(float(np.mean(chunk_max <= b)), 4) for b in budgets},
        "ray_within_budget_frac": {
            str(b): round(float(np.mean(ks <= b)), 4) for b in budgets},
        "device": device_name(dev),
    }


def main(argv=None):
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device("cuda")
    args = positional(argv)
    logdir = args[0] if args else os.path.join(RUNS_DIR, "quality", "refscale100k")
    budgets = ([int(b) for b in args[1].split(",")] if len(args) > 1
               else [32, 64, 96, 128, 192])
    rec = _run(logdir, budgets)
    print(json.dumps(rec, indent=1), flush=True)
    write_results("occ_probe", rec)


if __name__ == "__main__":
    main()
