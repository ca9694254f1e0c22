"""The output check's control and faults, read with the numbers and limits
of a cell's check.  The control is the plain reference put in the
program's place and computed one precision below the configs' (TF32
products in place of float32 with TF32 off); a fault (``benchlib/faults.py``)
is planted in the program or in the reference put in its place.  The check
is sound only if the control fails it, and each fault.

    python3 benchmark/control.py --workload indoor-train --seeds 11 12 13
    python3 benchmark/control.py --workload garden-train --seeds 11 12 13 --fault half-batch

prints one JSON line a seed with the numbers beside the cell's limits.
The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))


def control_numbers(cell, seed: int, dev, tmp: str, fault: str = "") -> dict:
    """The cell's check numbers with the TF32 reference, or with ``fault``
    planted, as the program."""
    import torch

    from benchlib import cells, faults, scene

    if fault in faults.PROGRAM:
        run = cells.run_train if cell.mode == "train" else cells.run_render
        with faults.PROGRAM[fault]():
            return run(cell, seed, 0.2, False, dev, time.perf_counter(),
                       os.path.join(tmp, f"run-{seed}")).numbers
    rc = cells.ref_config(cell)
    w = cells.draw_weights(cell, seed, dev)
    sc = cell.config["scene"]
    if cell.mode == "train":
        scn = scene.write_scene(os.path.join(tmp, f"scene-{seed}"), sc["layout"],
                                int(sc["n_train"]), int(sc["n_test"]), int(sc["height"]),
                                int(sc["width"]), seed)
        low = cells.reference_train(cell, scn, w, seed, rc, dev, tf32=True)
        prog = {"weights": w, "losses": low.losses, "grads": low.grads, "after": low.params}
        return cells.train_numbers(cell, prog, cells.reference_train(cell, scn, w, seed, rc, dev))
    h, wd = int(sc["height"]), int(sc["width"])
    poses = scene.view_poses(sc["layout"], int(cell.traffic["max_views"]), seed)
    dirs = scene.ray_directions_360(h, wd)
    n_views = int(cell.traffic.get("control_views", 12))
    empty = [{"rgb": torch.zeros(h * wd, 3)}] * n_views
    _, rays = cells.sample_rays(empty, poses, dirs, int(cell.traffic["check_rays"]), seed, dev)
    aabb = scene.scene_aabb(cells._train_poses(cell, seed), rc.far)
    if fault:
        with faults.REFERENCE[fault]():
            low = cells.reference_render(cell, aabb, w, rays, dev)
    else:
        low = cells.reference_render(cell, aabb, w, rays, dev, tf32=True)
    return cells.render_numbers(cell, low, cells.reference_render(cell, aabb, w, rays, dev))


def main(argv=None) -> None:
    from benchlib import faults

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="", choices=[""] + sorted(faults.PROGRAM)
                    + sorted(faults.REFERENCE))
    args = ap.parse_args(argv)
    import torch

    from benchlib.check import judge
    from benchlib.spec import load_cell

    if not torch.cuda.is_available():
        sys.exit("control: no CUDA device (TF32 and the kernels exist on the card only)")
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="egonerf-control-") as tmp:
        for seed in args.seeds:
            nums = control_numbers(cell, seed, dev, tmp, args.fault)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": args.fault or "tf32", "numbers": nums,
                              "limits": cell.limits,
                              "fails": not judge(nums, cell.limits)}), flush=True)


if __name__ == "__main__":
    main()
