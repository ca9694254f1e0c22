"""Sampler-semantics A/B at the production shape on the card (counterpart
of ``egonerf_tpu/tools/sampler_ab.py``).

The port's default sampler draws ray ids on the card uniformly with
replacement; the reference's ``SimpleSampler`` walks an epoch permutation
(reference: sampler.py:11-16), and its ``ThetaImportanceSampler`` draws
with replacement from a cos-latitude categorical (reference:
sampler.py:28-38; on the card K14f).  This tool trains the production
model under the three on the same data and seed, and records the held-out
PSNR every 500 steps.

    python -m egonerf_torch.tools.sampler_ab

runs on the card, trains in ``build/sampler_ab/<variant>``, writes
``docs/torch/results_sampler_ab.json`` (with ``device``, the card's name
and power limit) and prints a markdown table.
"""
from __future__ import annotations

import json
import os
import time

from . import RUNS_DIR, device_name, write_results

VARIANTS = [
    # (name, sampling_method, device_sampling)
    ("device_uniform_with_replacement", "simple", True),
    ("host_epoch_permutation", "simple", False),
    ("device_theta_importance", "theta_importance", True),
]

N_ITERS = 3000
VIS_EVERY = 500
IMG_H, IMG_W = 500, 1000
N_TRAIN, N_TEST = 12, 2


def make_config(name: str, method: str, device_sampling: bool, **extra):
    """The production config of one variant; ``extra`` overrides any field,
    this tool's defaults included (``f32_ab``, ``seed_ab`` and
    ``seed_variance`` run their arms so)."""
    from ..presets import production_overrides
    from ..train.config import load_config

    base = dict(
        n_iters=N_ITERS, progress_refresh_rate=500,
        basedir=os.path.join(RUNS_DIR, "sampler_ab"), expname=name, N_vis=-1,
        vis_list=str(list(range(VIS_EVERY, N_ITERS + 1, VIS_EVERY))),
        sampling_method=method, device_sampling=device_sampling,
    )
    base.update(extra)
    return load_config(overrides=production_overrides(**base))


def run_variant(name: str, method: str, device_sampling: bool,
                scene: str = "wall", device="cuda", **extra) -> dict:
    """Train one variant on ``device`` from a fresh folder and return its
    record: the held-out PSNR by step (``metrics.jsonl``'s ``test/psnr``)
    and the wall seconds.  A leftover folder of the same name is removed
    first: the trainer would resume from its checkpoint and report the old
    run."""
    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    cfg = make_config(name, method, device_sampling, **extra)
    logdir = os.path.join(cfg.basedir, cfg.expname)
    if os.path.isdir(logdir):
        import shutil

        shutil.rmtree(logdir)
    trainer = Trainer(cfg, device=dev)
    common = dict(n_train=N_TRAIN, n_test=N_TEST, height=IMG_H, width=IMG_W,
                  near_far=cfg.near_far, background=scene)
    trainer.set_datasets(SyntheticEgoDataset(split="train", is_stack=False, **common),
                         SyntheticEgoDataset(split="test", is_stack=True, **common))

    t0 = time.time()
    trainer.train()
    wall = time.time() - t0

    curve = {}
    with open(os.path.join(trainer.logdir, "metrics.jsonl")) as f:
        for ln in f:
            rec = json.loads(ln)
            if rec["tag"] == "test/psnr":
                curve[int(rec["step"]) + 1] = round(rec["value"], 3)
    return {"variant": name, "sampling_method": method,
            "device_sampling": device_sampling, "scene": scene,
            "psnr_by_iter": curve, "wall_s": round(wall, 1)}


def main():
    from .._device import resolve_device

    dev = resolve_device("cuda")
    results = {"device": device_name(dev),
               "config": {"n_iters": N_ITERS, "batch": 4096,
                          "n_voxel": 27_000_000, "samples": "128+128",
                          "views": f"{N_TRAIN}+{N_TEST} @ {IMG_W}x{IMG_H}"},
               "runs": []}
    for name, method, dev_samp in VARIANTS:
        print(f"=== {name} ===", flush=True)
        results["runs"].append(run_variant(name, method, dev_samp, device=dev))
        print(json.dumps(results["runs"][-1]), flush=True)

    write_results("sampler_ab", results)

    iters = sorted({it for r in results["runs"] for it in r["psnr_by_iter"]})
    print("\n| iteration | " + " | ".join(r["variant"] for r in results["runs"]) + " |")
    print("|---" * (len(results["runs"]) + 1) + "|")
    for it in iters:
        row = " | ".join(f"{r['psnr_by_iter'].get(it, float('nan')):.2f}"
                         for r in results["runs"])
        print(f"| {it} | {row} |")


if __name__ == "__main__":
    main()
