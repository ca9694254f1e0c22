"""Tools of the port: measurement scripts run on a CUDA card, the quality
records (``quality_run``, the A/Bs, the probes, ``eval_bench``), the
real-data pipeline (``fetch_data``, which finds or fetches a benchmark
scene, and ``real_data_run``, which trains a shipped scene config on it
and records its test metrics), the upstream PyTorch EgoNeRF's checkpoint
bridge (``import_reference_ckpt``, ``export_reference_ckpt``) and its
head-to-head run (``headtohead_reference``, on the card, with the
upstream checkout), the LPIPS weights export (``export_lpips``, on a host
with the ``lpips`` package), the record parsers and the sweep runner,
and the capture writer, run on the host (see each module).

The records go to ``docs/torch/results_<name>.json`` (:func:`results_path`),
beside and never over the JAX package's ``docs/results_<name>.json``.
"""
from __future__ import annotations

import os
import re

# the repository root, where the records and the runs' folders live
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
# the port's records, beside the JAX package's docs/results_*.json
RESULTS_DIR = os.path.join(REPO, "docs", "torch")
# the folder the tools' training runs write into (listed in .gitignore)
RUNS_DIR = os.path.join(REPO, "build")


def results_path(name: str) -> str:
    """The port's ``docs/torch/results_<name>.json``: one definition,
    shared by writers (:func:`write_results`) and readers (``seed_ab``'s
    merge-on-write resume, ``seed_variance``'s seed 0).

    ``name`` must be a short slug (JAX's check): anything else, a path or
    an op string, raises ``ValueError``."""
    if not re.fullmatch(r"[A-Za-z0-9_.-]{1,80}", name):
        raise ValueError(f"results name must be a short slug, got {name!r}")
    return os.path.join(RESULTS_DIR, f"results_{name}.json")


def write_results(name: str, obj) -> str:
    """Write ``obj`` to :func:`results_path` as indented JSON; returns the
    path."""
    import json

    path = results_path(name)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


def device_name(device) -> str:
    """The device a record was measured on: on a card its name and power
    limit as ``nvidia-smi`` gives them (torch's name where ``nvidia-smi``
    fails), else ``cpu``."""
    import subprocess

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(dev.index or 0)],
                             capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(dev)


def rel(path: str) -> str:
    """``path`` relative to the repository root when it lies inside it (a
    record names its run's folder so), else as given."""
    path = os.path.abspath(path)
    inside = os.path.commonpath([path, REPO]) == REPO
    return os.path.relpath(path, REPO) if inside else path


def positional(argv) -> list:
    """The arguments of ``argv`` that are not flags (JAX's tools read
    theirs so)."""
    return [a for a in argv if not a.startswith("-")]
