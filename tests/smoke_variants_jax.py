"""The JAX package's test PSNR for the smoke recipe's variants that
``chip_smoke.py``'s phase 8v holds the port to (a script, not a test: it
trains the recipe once per variant on the CPU).

    JAX_PLATFORMS=cpu python tests/smoke_variants_jax.py [--iters N] [--seed S] [--basedir DIR] [variant ...]

Each variant (default: every key of ``chip_smoke.SMOKE_VARIANTS``) is
``configs/smoke/synthetic.txt`` through ``python -m egonerf_tpu`` for
``chip_smoke.SMOKE_ITERS`` iterations (or ``--iters``) with the variant's
arguments (and ``--seed``; by default the config's seed), the test views
rendered once at the end; it prints the test PSNR of each.
"""
import argparse
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def main() -> None:
    import chip_smoke
    from egonerf_tpu.__main__ import main as jax_main

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=chip_smoke.SMOKE_ITERS)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--basedir", default=None)
    ap.add_argument("variants", nargs="*", default=sorted(chip_smoke.SMOKE_VARIANTS))
    args = ap.parse_args()
    base = args.basedir or tempfile.mkdtemp(prefix="smoke_variants_")
    for name in args.variants:
        logbase = os.path.join(base, name)
        argv = ["--config", os.path.join(REPO, chip_smoke.SMOKE_CONFIG), "--n_iters",
                str(args.iters), "--vis_list", f"[{args.iters}]", "--N_vis", "-1",
                "--basedir", logbase, *chip_smoke.SMOKE_VARIANTS[name]]
        if args.seed is not None:
            argv += ["--seed", str(args.seed)]
        t0 = time.time()
        jax_main(argv)
        mean = os.path.join(logbase, "smoke", "imgs_vis", f"{args.iters - 1:06d}_mean.txt")
        psnr = float(np.loadtxt(mean)[0])
        print(f"smoke variant {name} ({' '.join(argv[10:])}), "
              f"{args.iters} iterations, the JAX package on the CPU: test PSNR {psnr:.2f} dB "
              f"({time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
