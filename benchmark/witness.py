"""A second witness for the output check: the plain reference in float64
arithmetic (the same bfloat16 tables, draws and constants).  For each seed
it runs the cell's timed path through the harness with a short window and
prints how far the program's outputs, the float32 reference's and the
TF32 control's each lie from the float64 reference, beside the check's own
numbers (program against the float32 reference); for a render cell also
the quantiles of the per-ray gaps.

    python3 benchmark/witness.py --workload garden-render --seeds 11 12

Where the program sides with the float64 reference as closely as the
float32 reference does, a gap of the check is float32's own and not the
program's.  The benchmark's runs never run it.
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

QUANTILES = (0.1, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


def _ray_quantiles(a, b) -> dict:
    """Quantiles of the per-ray mean |a - b| over mean |b|."""
    import torch

    a, b = a.double(), b.double()
    per = (a - b).abs().reshape(a.shape[0], -1).mean(-1) / b.abs().mean()
    q = torch.quantile(per.cpu(), torch.tensor(QUANTILES, dtype=torch.float64))
    return {f"q{x:g}": float(v) for x, v in zip(QUANTILES, q)}


def witness(cell, seed: int, dev, tmp: str) -> dict:
    import torch

    from benchlib import cells, check

    run = cells.run_train if cell.mode == "train" else cells.run_render
    res = run(cell, seed, 0.2, False, dev, time.perf_counter(), os.path.join(tmp, str(seed)))
    c = res.compared
    f64 = torch.float64
    if cell.mode == "train":
        rc = cells.ref_config(cell)
        r32 = cells.reference_train(cell, c["scene"], c["weights"], seed, rc, dev)
        r64 = cells.reference_train(cell, c["scene"], c["weights"], seed, rc, dev, dtype=f64)
        low = cells.reference_train(cell, c["scene"], c["weights"], seed, rc, dev, tf32=True)

        def as_prog(r):
            return {"weights": c["weights"], "losses": r.losses, "grads": r.grads,
                    "after": r.params}

        nums = lambda prog, r: check.train_numbers(  # noqa: E731
            prog["losses"], r.losses, prog["grads"], r.grads,
            {k: prog["after"][k].double() - w.double() for k, w in c["weights"].items()},
            {k: r.params[k].double() - w.double() for k, w in c["weights"].items()})
        return {"check": res.numbers, "program_vs_f64": nums(c, r64),
                "f32_vs_f64": nums(as_prog(r32), r64),
                "tf32_vs_f64": nums(as_prog(low), r64),
                "program_vs_f32": nums(c, r32), "tf32_vs_f32": nums(as_prog(low), r32)}
    out, rays, w, aabb = c["out"], c["rays"], c["weights"], c["aabb"]
    r32 = cells.reference_render(cell, aabb, w, rays, dev)
    r64 = cells.reference_render(cell, aabb, w, rays, dev, dtype=f64)
    low = cells.reference_render(cell, aabb, w, rays, dev, tf32=True)
    pairs = {"program_vs_f64": (out, r64), "f32_vs_f64": (r32, r64), "tf32_vs_f64": (low, r64),
             "program_vs_f32": (out, r32), "tf32_vs_f32": (low, r32)}
    rep = {"check": res.numbers}
    for name, (a, b) in pairs.items():
        rep[name] = check.render_numbers(a, b)
        rep[name + ".rgb_rays"] = _ray_quantiles(a["rgb"], b["rgb"])
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from benchlib.spec import load_cell

    if not torch.cuda.is_available():
        sys.exit("witness: no CUDA device")
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="egonerf-witness-") as tmp:
        for seed in args.seeds:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              **witness(cell, seed, dev, tmp)}), flush=True)


if __name__ == "__main__":
    main()
