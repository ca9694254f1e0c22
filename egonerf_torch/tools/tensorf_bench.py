"""TensoRF-family training throughput on the card, and the converged gate
occupancy (counterpart of ``egonerf_tpu/tools/tensorf_bench.py``).

The reference culls TensoRF's work as the alpha mask converges
(``ray_valid`` / ``app_mask``, reference: models/tensorBase.py:464-487);
the port, as the JAX package, keeps static shapes and gates the values, so
its step cost is the same at any point of training.  This tool trains the
``tensorf_bench`` recipe (``presets.tensorf_mask_overrides``: TensorVMSplit
at 256^3, 256 samples a ray, the mask baked at 1000) for ``WARMUP_ITERS``
steps, then times ``N_SEGMENTS`` segments of ``CALLS_PER_SEG`` x
``STEPS_PER_CALL`` steps, each segment between two CUDA events with one
synchronisation at its end, and reports the median segment's rate.  The
gate occupancy is the share of a batch's samples whose weight is above
``rm_weight_mask_thre``: what the reference would still evaluate.

    python -m egonerf_torch.tools.tensorf_bench

runs on the card, trains in ``build/tensorf_bench/tb`` and writes
``docs/torch/results_tensorf_bench.json`` (JAX's keys and ``device``, the
card's name and power limit).
"""
from __future__ import annotations

import json
import os
import statistics
import sys

from . import RUNS_DIR, device_name, rel, write_results

# long enough for the density field to localise and the mask to bake (at
# 1000), so that the gate occupancy is a converged number
WARMUP_ITERS = 1200
STEPS_PER_CALL = 8
CALLS_PER_SEG = 3
N_SEGMENTS = 3
BATCH = 4096
N_SAMPLES = 256          # the tensorf quality preset's samples a ray
N_VOXEL = 16_777_216     # 256^3, the quality preset's final grid


def spec(**deltas):
    """The recipe's ``(cfg, scene)`` without training: JAX's config fields
    (``basedir`` the repository's ``build/tensorf_bench``).  ``deltas`` win."""
    from ..presets import TENSORF_BENCH_SCENE, tensorf_mask_overrides
    from ..train.config import load_config

    cfg = load_config(overrides=tensorf_mask_overrides(**{**dict(
        n_coarse=N_SAMPLES, batch_size=BATCH, N_voxel_init=N_VOXEL, N_voxel_final=N_VOXEL,
        n_iters=WARMUP_ITERS, steps_per_call=STEPS_PER_CALL,
        basedir=os.path.join(RUNS_DIR, "tensorf_bench"), expname="tb"), **deltas}))
    return cfg, dict(TENSORF_BENCH_SCENE)


def gate_occupancy(alpha, thres: float) -> float:
    """The share of the samples whose weight alpha x transmittance is above
    ``thres``, the transmittance the exclusive product of (1 - alpha +
    1e-10) along the ray (JAX's expression, ``tensorf_bench.py:100-112``).
    ``alpha`` (R, S) tensor."""
    import torch

    alpha = alpha.float()
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                                    dim=-1), dim=-1)[:, :-1]
    above = (alpha * trans) > thres
    return int(above.sum()) / above.numel()


def trained(device="cuda", **deltas):
    """A fresh trainer of the recipe, trained (its folder removed first:
    the trainer would resume a finished run and train nothing)."""
    import shutil

    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    cfg, scene = spec(**deltas)
    shutil.rmtree(os.path.join(cfg.basedir, cfg.expname), ignore_errors=True)
    trainer = Trainer(cfg, device=dev)
    scene = dict(scene, near_far=cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", is_stack=False, **scene),
                         SyntheticEgoDataset(split="test", is_stack=True, **scene))
    trainer.train()
    return trainer


def measure(trainer) -> dict:
    """The trained recipe's step rate on the card (segments timed with CUDA
    events, median of ``N_SEGMENTS``) and its gate occupancy on the first
    ``BATCH`` training rays; a trainer on another device raises."""
    import numpy as np
    import torch

    cfg = trainer.cfg
    dev = trainer.device
    if dev.type != "cuda":
        raise RuntimeError("tensorf_bench times the card; its trainer is on " + str(dev))
    it = cfg.n_iters
    steps = CALLS_PER_SEG * STEPS_PER_CALL

    def segment(n_steps: int) -> float:
        nonlocal it
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_steps):
            trainer.train_step(it)
            it += 1
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    segment(STEPS_PER_CALL)  # warm: the first call after training
    seg_rates = [cfg.batch_size * steps / segment(steps) for _ in range(N_SEGMENTS)]
    rays = torch.as_tensor(np.asarray(trainer.train_dataset.all_rays[:cfg.batch_size],
                                      np.float32), device=dev)
    with torch.no_grad():
        out = trainer.model.forward(trainer.params, rays, key=None, is_train=False,
                                    n_coarse=cfg.n_coarse, with_alpha=True,
                                    tables=trainer.model.lookup_tables(trainer.params))
    value = statistics.median(seg_rates)
    return {"metric": "tensorf_train_rays_per_sec", "unit": "rays/s", "platform": dev.type,
            "device": device_name(dev), "value": round(value, 1),
            "step_ms_p50": round(1000.0 * cfg.batch_size / value, 3),
            "segments_rays_per_sec": [round(r, 1) for r in seg_rates],
            "n_samples": cfg.n_coarse, "n_voxel": cfg.N_voxel_final, "batch": cfg.batch_size,
            "gate_occupancy": gate_occupancy(out["alpha"], cfg.rm_weight_mask_thre),
            "artifacts": rel(trainer.logdir),
            "note": ("static-shape step cost is constant over training; gate_occupancy is the "
                     "fraction the reference would evaluate after alpha-mask convergence")}


def main(argv=None):
    from .._device import resolve_device

    del argv  # JAX's tool takes no arguments
    resolve_device("cuda")
    rec = measure(trained())
    write_results("tensorf_bench", rec)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
