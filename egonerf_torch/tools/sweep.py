"""Grid-search runner (counterpart of ``egonerf_tpu/tools/sweep.py``).

The reference ships a thread-per-GPU launcher with mkdir-based folder
locks (reference: extra/auto_run_paramsets.py).  This runner launches one
``python -m egonerf_torch`` process per experiment of a cartesian
parameter grid, in turn, with the same skip-if-the-folder-exists lock (so
several hosts can share a sweep folder), and names each experiment by its
parameter values.

    python -m egonerf_torch.tools.sweep --config base.txt \
        --grid lr_init=0.01,0.02 --grid n_coarse=64,128 [--basedir DIR] [--dry]

Each launched trainer runs on the card (the command line's default).
``--dry`` prints what would launch and takes no lock.
"""
from __future__ import annotations

import itertools
import os
import subprocess
import sys


def make_param_grid(grids: dict) -> list:
    """{name: [v1, v2], ...} -> list of {name: value} combos."""
    names = sorted(grids)
    combos = itertools.product(*(grids[n] for n in names))
    return [dict(zip(names, c)) for c in combos]


def expname_for(combo: dict) -> str:
    return "_".join(f"{k}-{v}" for k, v in sorted(combo.items()))


def try_lock(basedir: str, expname: str) -> bool:
    """mkdir-based lock: first claimant wins (reference:
    extra/auto_run_paramsets.py:7-19)."""
    try:
        os.makedirs(os.path.join(basedir, expname))
        return True
    except FileExistsError:
        return False


def run_sweep(config: str, grids: dict, basedir: str = "./log/sweep",
              dry: bool = False, python=sys.executable) -> list:
    launched, failed = [], []
    for combo in make_param_grid(grids):
        expname = expname_for(combo)
        if dry:
            # preview must not take locks — a dry run that mkdir'd every
            # logdir would make the later real sweep skip everything
            locked = os.path.isdir(os.path.join(basedir, expname))
            print(f"{'skip (locked)' if locked else 'would launch'}: {expname}")
            if not locked:
                launched.append(expname)
            continue
        if not try_lock(basedir, expname):
            print(f"skip (locked): {expname}")
            continue
        cmd = [python, "-m", "egonerf_torch", "--config", config,
               "--basedir", basedir, "--expname", expname]
        for k, v in combo.items():
            cmd += [f"--{k}", str(v)]
        print("launch:", " ".join(cmd))
        launched.append(expname)
        # one crashed combo must not kill the rest of the sweep; release
        # its lock so a re-run can retry it
        if subprocess.run(cmd).returncode != 0:
            failed.append(expname)
            print(f"FAILED: {expname} (lock released for retry)")
            try:
                os.rmdir(os.path.join(basedir, expname))
            except OSError:
                pass  # logdir non-empty: keep partial output + the lock
    if failed:
        print(f"{len(failed)}/{len(launched)} experiments failed: {failed}")
    return launched


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config, basedir, dry = None, "./log/sweep", False
    grids: dict = {}
    i = 0
    while i < len(argv):
        if argv[i] == "--config":
            config = argv[i + 1]; i += 2
        elif argv[i] == "--basedir":
            basedir = argv[i + 1]; i += 2
        elif argv[i] == "--grid":
            name, vals = argv[i + 1].split("=", 1)
            grids[name] = vals.split(","); i += 2
        elif argv[i] == "--dry":
            dry = True; i += 1
        else:
            raise SystemExit(f"unknown arg {argv[i]}")
    if not config or not grids:
        raise SystemExit(__doc__)
    run_sweep(config, grids, basedir=basedir, dry=dry)


if __name__ == "__main__":
    main()
