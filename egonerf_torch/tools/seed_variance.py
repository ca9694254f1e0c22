"""Run-to-run noise band of the production-shape quality A/B on the card
(counterpart of ``egonerf_tpu/tools/seed_variance.py``).

The wall-scene baseline (:mod:`sampler_ab`'s device-uniform variant) runs
again under other seeds (other ray ids, jitter, draws and initial
weights); the spread of the 3000-step PSNRs is the band that a quality
comparison is held to.

    python -m egonerf_torch.tools.seed_variance [seed,seed,...]

runs on the card (seeds 1,2 by default) and writes
``docs/torch/results_seed_variance.json`` (with ``device``, the card's
name and power limit).  Seed 0 is sampler_ab's device-uniform run: its
3000-step PSNR is read from the port's own ``docs/torch/
results_sampler_ab.json``, and where that record is absent (or seed 0 is
asked for) seed 0 runs here.  JAX's tool writes in its TPU seed 0 (38.71
dB) instead.
"""
from __future__ import annotations

import json
import os
import sys

from . import device_name, positional, results_path, sampler_ab, write_results

SEED0_VARIANT = sampler_ab.VARIANTS[0][0]


def seed0_psnr():
    """Seed 0's PSNR at ``sampler_ab.N_ITERS`` steps from the port's
    sampler_ab record (its device-uniform run), or None without one."""
    path = results_path("sampler_ab")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        runs = json.load(f).get("runs", [])
    for r in runs:
        if r.get("variant") == SEED0_VARIANT:
            return r["psnr_by_iter"].get(str(sampler_ab.N_ITERS))
    return None


def _final(rec):
    by_iter = rec["psnr_by_iter"]
    return by_iter.get(str(sampler_ab.N_ITERS)) or by_iter.get(sampler_ab.N_ITERS)


def main(argv=None):
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    dev = resolve_device("cuda")
    args = positional(argv)
    seeds = [int(s) for s in args[0].split(",")] if args else [1, 2]
    seed0 = None if 0 in seeds else seed0_psnr()
    if seed0 is None and 0 not in seeds:
        seeds = [0] + seeds

    results = {"protocol": "sampler_ab device-uniform baseline, seed sweep",
               "scene": "wall",
               "seed0_reference_psnr_3k": seed0,
               "seed0_source": "docs/torch/results_sampler_ab.json" if seed0 is not None
               else "run here",
               "device": device_name(dev),
               "runs": []}
    for s in seeds:
        print(f"=== seed={s} ===", flush=True)
        rec = sampler_ab.run_variant(f"seed{s}_wall", "simple", True,
                                     scene="wall", device=dev, seed=s)
        rec["seed"] = s
        results["runs"].append(rec)
        print(json.dumps(rec), flush=True)
        if s == 0:
            results["seed0_reference_psnr_3k"] = _final(rec)

    finals = [_final(r) for r in results["runs"] if r["seed"] != 0]
    finals = [f for f in finals + [results["seed0_reference_psnr_3k"]] if f is not None]
    results["psnr_3k_all_seeds"] = finals
    results["spread_db"] = round(max(finals) - min(finals), 3)

    write_results("seed_variance", results)
    print(json.dumps({"psnr_3k_all_seeds": finals,
                      "spread_db": results["spread_db"]}), flush=True)


if __name__ == "__main__":
    main()
