"""The seed spread of JAX's egocentric end-to-end recipe in both packages,
and the port's controls (a script, not a test: it trains the recipe once per
seed and package).

    JAX_PLATFORMS=cpu python tests/egocentric_seed_spread.py [--iters N] [--port-only] [seed ...]

For each seed (default: JAX's config default 20221028 and 1-6) it trains
the recipe of ``tests/test_egocentric_e2e.py:67-104`` (an 8-frame 240x120
capture, roi [0.05, 0.95, 0, 1], theta_importance; 60 steps, or ``--iters``)
with the JAX package (unless ``--port-only``) and with the port
(``device="cpu"``, K14's plain version) and prints each test PSNR, then the
spreads.  The two packages draw from different random streams, so only their
spreads compare.  Then the port's controls at the default seed: the
untrained field (step 0), one constant colour (the train frames' mean), and
the recipe trained on pixels shuffled across the rays, which can learn no
more than that colour.  ``chip_smoke.py``'s phase 19 reads its floors
against these.
"""
import argparse
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

H, W = 120, 240
DOWNSAMPLE = 1920 / W
ROI = [0.05, 0.95, 0.0, 1.0]
SEEDS = [20221028, 1, 2, 3, 4, 5, 6]


def recipe(datadir, basedir, seed, iters):
    """The recipe's overrides, as JAX's test writes them (load_config types
    them in either package)."""
    import chip_smoke

    return dict(chip_smoke.EGO_E2E["config"], datadir=datadir, downsample_train=DOWNSAMPLE,
                downsample_test=DOWNSAMPLE, roi=str(ROI), basedir=basedir, N_vis=0, seed=seed,
                n_iters=iters)


def jax_psnr(datadir, basedir, seed, iters) -> float:
    from egonerf_tpu.render.renderer import evaluation
    from egonerf_tpu.train.config import load_config
    from egonerf_tpu.train.trainer import Trainer

    t = Trainer(load_config(overrides=recipe(datadir, basedir, seed, iters)))
    t.train()
    return float(np.mean(evaluation(t.test_dataset, t.model, t.params, t.renderer,
                                    save_path=None, compute_extra_metrics=False)))


def port_trainer(datadir, basedir, seed, iters):
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    return Trainer(load_config(overrides=recipe(datadir, basedir, seed, iters)), device="cpu")


def port_psnr(datadir, basedir, seed, iters, shuffle=False) -> float:
    """The port's test PSNR after ``iters`` steps; with ``shuffle``, the
    resident (N, 9) buffer's colours are permuted across its rays first."""
    import torch

    t = port_trainer(datadir, basedir, seed, iters)
    if shuffle:
        buf = t.sampler.buffer
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(buf.shape[0]))
        buf[:, 6:] = buf[perm, 6:]
    t.train()
    return float(np.mean(t._evaluate(None)))


def controls(cap, out, iters) -> None:
    """The port's controls at the default seed (see the module docstring)."""
    t = port_trainer(cap, os.path.join(out, "untrained"), SEEDS[0], iters)
    untrained = float(np.mean(t._evaluate(None)))
    mean_rgb = t.train_dataset.all_rgbs.reshape(-1, 3).mean(0)
    const = np.mean([-10 * np.log10(np.mean((f.reshape(-1, 3) - mean_rgb) ** 2))
                     for f in t.test_dataset.all_rgbs])
    shuffled = port_psnr(cap, os.path.join(out, "shuffled"), SEEDS[0], iters, shuffle=True)
    print(f"port controls: untrained field {untrained:.4f} dB, the train frames' mean colour "
          f"{const:.4f} dB, trained {iters} steps on shuffled pixels {shuffled:.4f} dB",
          flush=True)


def spread(name, psnrs) -> str:
    p = np.asarray(psnrs)
    return (f"{name}: mean {p.mean():.4f} dB, min {p.min():.4f}, max {p.max():.4f}, above 10 dB "
            f"{int((p > 10).sum())} of {len(p)}")


def main(argv):
    import torch

    from egonerf_torch.tools.make_egocentric_capture import make_capture

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("seeds", type=int, nargs="*")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    out = tempfile.mkdtemp(prefix="ego_seed_spread_")
    cap = os.path.join(out, "capture")
    make_capture(cap, n_frames=8, height=H, n_test=2, seed=3)
    jax, port = [], []
    for seed in args.seeds or SEEDS:
        if not args.port_only:
            jax.append(jax_psnr(cap, os.path.join(out, f"jax{seed}"), seed, args.iters))
        port.append(port_psnr(cap, os.path.join(out, f"port{seed}"), seed, args.iters))
        print(f"seed {seed}, {args.iters} steps: "
              + (f"JAX {jax[-1]:.4f} dB, " if jax else "") + f"port {port[-1]:.4f} dB",
              flush=True)
    print("; ".join(([spread("JAX", jax)] if jax else []) + [spread("port", port)]), flush=True)
    controls(cap, out, args.iters)


if __name__ == "__main__":
    main(sys.argv[1:])
