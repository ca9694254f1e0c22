"""Train-time cull quality A/B at the production shape on the card
(counterpart of ``egonerf_tpu/tools/cull_ab.py``).

``train_keep`` drops the coarse-scored-emptiest merged samples from the
fine field during training (K4c scores them, K13 keeps the top K; every
``train_keep_full_every``-th step unculled, Gumbel scores at
``train_cull_tau``), a departure from the reference's fixed 256 samples a
ray (reference: models/EgoNeRF.py:536-539), so it is held to a
production-shape A/B: :mod:`sampler_ab`'s protocol (27e6 voxels, batch
4096, 128 + 128 samples, 3000 steps, the same data and seed) at each keep.

    python -m egonerf_torch.tools.cull_ab [keep,keep,...] [--scene=S]
        [--full_every=N] [--tau=T] [--no_baseline]

reads its arguments as JAX's tool does (keeps 192,128 on the wall scene
by default; other flags are ignored), runs on the card, trains in
``build/sampler_ab/<tag>`` and writes
``docs/torch/results_cull_ab[_<scene>][_fe<N>][_g<tau>].json`` (with
``device``, the card's name and power limit).  A scene other than the
wall gets an unculled keep-0 run first, unless 0 is among the keeps or
``--no_baseline`` is given.  The record's ``baseline`` names the port's
own device-uniform run (``docs/torch/results_sampler_ab.json``); JAX's
names its TPU record.
"""
from __future__ import annotations

import json
import sys

from . import device_name, positional, sampler_ab, write_results

PROTOCOL = "sampler_ab device-uniform + train_keep"
BASELINE = "device_uniform_with_replacement (docs/torch/results_sampler_ab.json)"


def parse(argv) -> dict:
    """JAX's reading of ``argv``: the first positional is the comma list
    of keeps, then ``--scene=``, ``--full_every=``, ``--tau=`` and
    ``--no_baseline``; any other flag is ignored."""
    args = positional(argv)
    opts = dict(keeps=[int(k) for k in args[0].split(",")] if args else [192, 128],
                scene="wall", full_every=0, tau=0.0, no_baseline="--no_baseline" in argv)
    for a in argv:
        if a.startswith("--scene="):
            opts["scene"] = a.split("=", 1)[1]
        elif a.startswith("--full_every="):
            opts["full_every"] = int(a.split("=", 1)[1])
        elif a.startswith("--tau="):
            opts["tau"] = float(a.split("=", 1)[1])
    return opts


def record_name(scene: str = "wall", full_every: int = 0, tau: float = 0.0) -> str:
    """The record's name, JAX's: ``cull_ab[_<scene>][_fe<N>][_g<tau>]``."""
    name = f"cull_ab_{scene}" if scene != "wall" else "cull_ab"
    if full_every:
        name += f"_fe{full_every}"
    if tau:
        name += f"_g{tau:g}"
    return name


def run(keeps, scene: str = "wall", full_every: int = 0, tau: float = 0.0,
        no_baseline: bool = False, device="cuda", **overrides) -> dict:
    """Train each keep on ``device`` through :func:`sampler_ab.run_variant`
    (``overrides`` go to its config, ``basedir`` or ``n_iters`` for
    example) and return the record; writes nothing.  Raises before any
    work when the card is asked for and absent."""
    from .._device import resolve_device

    dev = resolve_device(device)
    results = {"protocol": PROTOCOL, "scene": scene, "train_keep_full_every": full_every,
               "train_cull_tau": tau, "baseline": BASELINE, "device": device_name(dev),
               "runs": []}
    keeps = list(keeps)
    if scene != "wall" and 0 not in keeps and not no_baseline:
        # the port's sampler_ab record is of the wall scene: any other
        # scene takes its unculled run in the same record
        keeps = [0] + keeps
    for k in keeps:
        fe = full_every if k else 0
        kt = tau if k else 0.0
        tag = f"tk{k}" + (f"fe{fe}" if fe else "") + (f"g{kt:g}" if kt else "") + f"_{scene}"
        print(f"=== train_keep={k} full_every={fe} tau={kt:g} (scene={scene}) ===", flush=True)
        rec = sampler_ab.run_variant(tag, "simple", True, scene=scene, device=dev,
                                     train_keep=k, train_keep_full_every=fe,
                                     train_cull_tau=kt, **overrides)
        rec["train_keep"] = k
        rec["train_keep_full_every"] = fe
        rec["train_cull_tau"] = kt
        results["runs"].append(rec)
        print(json.dumps(rec), flush=True)
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = parse(argv)
    results = run(**opts)
    write_results(record_name(opts["scene"], opts["full_every"], opts["tau"]), results)


if __name__ == "__main__":
    main()
