"""Multi-seed A/B of the sampler and dtype defaults on the card
(counterpart of ``egonerf_tpu/tools/seed_ab.py``).

Three arms run under N seeds with everything else pinned:

  * ``device_uniform``: the default (ids drawn on the card, bf16 hat
    lines); also the bf16 arm of the dtype question
  * ``host_epoch``: the reference's epoch permutation (reference:
    sampler.py:11-16)
  * ``f32_scatter``: the default sampler with ``compute_dtype = float32``

and the paired per-seed deltas (same-seed arms share data order and
initial weights) are reported.

    python -m egonerf_torch.tools.seed_ab [seeds] [n_iters]

runs on the card (seeds "0,1,2" at 3000 steps by default) and merges its
runs into ``docs/torch/results_seed_ab.json`` (keyed by arm and seed, so a
later invocation adds to it), with ``device``, the card's name and power
limit.  With ``EGONERF_DEADLINE_TS`` (a unix time) no arm starts that
would end after it.
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import device_name, positional, results_path, sampler_ab, write_results

ARMS = [
    ("device_uniform", dict(method="simple", device_sampling=True)),
    ("host_epoch", dict(method="simple", device_sampling=False)),
    ("f32_scatter", dict(method="simple", device_sampling=True,
                         compute_dtype="float32")),
]


def main(argv=None):
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    dev = resolve_device("cuda")
    args = positional(argv)
    seeds = [int(s) for s in (args[0] if args else "0,1,2").split(",")]
    n_iters = int(args[1]) if len(args) > 1 else sampler_ab.N_ITERS
    # no new arm starts past the deadline (the current one finishes); the
    # merge-on-write below keeps what completed
    deadline = float(os.environ.get("EGONERF_DEADLINE_TS", "0") or 0)
    est_per_run = 1400.0  # refined from measured runs below

    runs = []
    for seed in seeds:
        for arm, spec in ARMS:
            if deadline and time.time() + est_per_run > deadline:
                print(f"deadline: stopping before {arm}_s{seed} "
                      f"({len(runs)} runs completed this invocation)", flush=True)
                _write(runs, n_iters, dev)
                return
            name = f"{arm}_s{seed}"
            print(f"=== {name} ===", flush=True)
            t_arm = time.time()
            rec = sampler_ab.run_variant(
                name, spec["method"], spec["device_sampling"], device=dev,
                **{k: v for k, v in spec.items() if k not in ("method", "device_sampling")},
                seed=seed, n_iters=n_iters, vis_list=str([n_iters]))
            rec.update(arm=arm, seed=seed)
            runs.append(rec)
            est_per_run = max(300.0, time.time() - t_arm)
            print(json.dumps(rec), flush=True)
            _write(runs, n_iters, dev)  # incremental: resumable evidence

    all_runs = _write(runs, n_iters, dev)
    final = {r["seed"]: {} for r in all_runs}
    for r in all_runs:
        by_iter = r["psnr_by_iter"]
        final[r["seed"]][r["arm"]] = by_iter.get(n_iters, by_iter.get(str(n_iters)))
    print("\n| seed | " + " | ".join(a for a, _ in ARMS)
          + " | d(host-uniform) | d(f32-bf16) |")
    print("|---" * (len(ARMS) + 3) + "|")
    for seed in seeds:
        row = final.get(seed, {})
        vals = [row.get(a) for a, _ in ARMS]
        if all(v is not None for v in vals):
            du, dh, df = vals
            print(f"| {seed} | {du:.2f} | {dh:.2f} | {df:.2f} "
                  f"| {dh - du:+.2f} | {df - du:+.2f} |")


def _write(runs, n_iters, device):
    """Merge this invocation's runs into the record, keyed by (arm, seed):
    a run again replaces, earlier invocations' runs stay."""
    path = results_path("seed_ab")
    merged = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                for r in json.load(f).get("runs", []):
                    merged[(r["arm"], r["seed"])] = r
        except (json.JSONDecodeError, KeyError):
            pass
    for r in runs:
        merged[(r["arm"], r["seed"])] = r
    all_runs = sorted(merged.values(), key=lambda r: (r["seed"], r["arm"]))
    write_results("seed_ab", {
        "seeds": sorted({r["seed"] for r in all_runs}), "n_iters": n_iters,
        "paired": "same-seed arms share data order and init",
        "device": device_name(device),
        "runs": all_runs,
    })
    return all_runs


if __name__ == "__main__":
    main()
