"""One-command real-dataset pipeline on the card: config -> train ->
render the test split -> JSON record (the port's copy of
``egonerf_tpu/tools/real_data_run.py``).

    python -m egonerf_torch.tools.real_data_run barbershop [--iters N] [--dest DIR]

resolves the scene's shipped config (``configs/egonerf/{omniblender,
ricoh}/<scene>.txt``), trains it with JAX's overrides (``datadir`` the
scene's folder under DIR, default ``data``; ``render_test``; ``n_iters``
with ``--iters``), renders the test split and writes
``docs/torch/results_real_<scene>.json``: JAX's fields (the test split's
``imgs_test_all/mean.json`` as ``metrics``) and ``device``, the card's
name and power limit.  When the scene's folder is absent
(``fetch_data.is_present``) it prints the ``fetch_data`` hint and exits 3
without touching the card; otherwise it runs on the card and raises
without one.

:func:`run` is the Python entry: keyword config overrides on top of
JAX's (a run's ``basedir``, narrower widths), ``device`` and ``results``,
the path the record goes to.
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import REPO, device_name, rel, write_results
from .fetch_data import DATASETS, is_present, scene_dir


def config_for(scene: str) -> str:
    coll = "omniblender" if DATASETS[scene] == "OmniBlender" else "ricoh"
    path = os.path.join(REPO, "configs", "egonerf", coll, f"{scene}.txt")
    if not os.path.exists(path):
        raise SystemExit(f"no config for scene {scene!r} at {path}")
    return path


def scene_config(scene: str, dest: str = "data", iters=None, **overrides):
    """The scene's config with JAX's overrides, then ``overrides``."""
    from ..train.config import load_config

    ov = {"datadir": scene_dir(scene, dest), "render_test": True}
    if iters is not None:
        ov["n_iters"] = iters
    return load_config(config_for(scene), overrides={**ov, **overrides})


def run(scene: str, dest: str = "data", iters=None, device="cuda", results=None,
        **overrides) -> int:
    """Train ``scene`` from ``dest`` on ``device`` and write its record to
    ``results`` (default :func:`write_results`' ``real_<scene>``); returns
    the exit code: 3 with the ``fetch_data`` hint when the scene is absent
    (nothing built, the device untouched), else 0."""
    if not is_present(scene, dest):
        print(f"{scene_dir(scene, dest)} absent — run "
              f"`python -m egonerf_torch.tools.fetch_data {scene}` first.")
        return 3

    from .._device import resolve_device
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    cfg = scene_config(scene, dest, iters, **overrides)
    t0 = time.time()
    trainer = Trainer(cfg, device=dev)
    psnrs = trainer.train()
    wall = time.time() - t0
    # the test split's means (with render_train on, imgs_train_all/ holds
    # another mean.json)
    with open(os.path.join(trainer.logdir, "imgs_test_all", "mean.json")) as f:
        metrics = json.load(f)
    out = {
        "scene": scene, "collection": DATASETS[scene],
        "config": rel(cfg.config), "n_iters": cfg.n_iters,
        "final_test_psnr": (round(float(sum(psnrs) / len(psnrs)), 3)
                            if psnrs else None),
        "metrics": metrics, "wall_s": round(wall, 1),
        "artifacts": rel(trainer.logdir),
        "device": device_name(dev),
    }
    if results is None:
        results = write_results(f"real_{scene}", out)
    else:
        os.makedirs(os.path.dirname(os.path.abspath(results)), exist_ok=True)
        with open(results, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(f"record written to {rel(results)}", flush=True)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    iters = None
    dest = "data"
    if "--iters" in argv:
        i = argv.index("--iters")
        iters = int(argv[i + 1])
        del argv[i:i + 2]
    if "--dest" in argv:
        i = argv.index("--dest")
        dest = argv[i + 1]
        del argv[i:i + 2]
    scene = argv[0] if argv else "barbershop"
    return run(scene, dest, iters)


if __name__ == "__main__":
    raise SystemExit(main())
