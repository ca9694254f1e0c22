"""The benchmark of ``egonerf_torch`` on an NVIDIA GPU: one run of one cell.

    python3 benchmark/run.py --workload indoor-train --seed 7 --seconds 51 --trace 0

from the root of a checkout.  The cell's configuration, traffic mix and
limits are found by name from ``BENCHMARK.json`` (``benchmark/README.md``).
Standard output's last line is the run's JSON result: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(a profiled segment after the window).  Standard error ends with each
number of the output check beside its limit.  Without a CUDA device, with
fewer devices than the cell asks for, without the program beside the
benchmark, or with JAX loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "egonerf_tpu")


def loaded_forbidden() -> list:
    """The top-level names of ``sys.modules`` that are JAX's or the JAX
    package's, each compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(code: int, msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "egonerf_torch" / "__init__.py").exists():
        fail(3, f"the program egonerf_torch is not beside the benchmark under {ROOT}")
    from benchlib import cells, readings
    from benchlib.spec import families, load_cell, metric_readers

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        fail(2, "no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(2, f"{cell.name} needs {cell.chips} devices, torch sees "
                f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = cells.run_train if cell.mode == "train" else cells.run_render
    with tempfile.TemporaryDirectory(prefix="egonerf-bench-") as tmp:
        res = run(cell, args.seed, args.seconds, bool(args.trace), dev, T_PROCESS, tmp)

    found = loaded_forbidden()
    if found:
        fail(4, f"modules loaded in the benchmark's process: {', '.join(found)}")
    print(f"scene_s {res.scene_s:.6f} (the benchmark's scene, outside setup_s)",
          file=sys.stderr)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        ctx = readings.Context(cell.mode, res, cells.shapes(cell, cell.mode == "train"),
                               int(cell.config["scene"]["height"])
                               * int(cell.config["scene"]["width"]), families())
        values = {}
        for name, reader in metric_readers([m["name"] for m in cell.per_layer]).items():
            v = reader.read(ctx)
            if v is not None and math.isfinite(v):
                values[name] = v
        t = res.trace
        print(f"traced {t.units} units: busy {t.busy_s:.6f} s of {t.window_s:.6f} s; "
              f"other {t.other_ops}", file=sys.stderr)
    else:
        values = {m["name"]: res.metrics[m["name"]] for m in cell.end_to_end}
    limits = cell.limits
    correct = cells.check.judge(res.numbers, limits)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in res.numbers.items()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
              "memory_peak_bytes": res.memory_peak}
    out = {"correct": correct, "attempted": res.attempted, "failed": res.failed,
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
           "device": device}
    if args.trace:
        device.update(busy_s=res.trace.busy_s, window_s=res.trace.window_s)
        out["breakdown"] = {"device_ops": [[n, s] for n, s in res.trace.device_ops],
                            "idle_gaps": [[n, s] for n, s in res.trace.idle_gaps]}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
