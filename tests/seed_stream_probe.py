"""Where the device-uniform sampler's seed 2 loses its 3000-step quality on
the card (a script, not a test).

    python tests/seed_stream_probe.py [--seeds 0,1,2,3,4,5] [--runs] [--out FILE]

sampler_ab's device-uniform run (the production model on the 1000x500 wall
scene, 3000 steps) draws two things from the trainer's step generator
(``torch.Generator`` seeded ``seed + 2``), each step in this order: the
batch's ray ids (``torch.randint``) and the coarse jitter (``torch.rand``,
batch x n_coarse).  The script replays that sequence for each seed and
summarises the ids over the first 1000 steps and over all 3000: the share
of distinct ids, the repeats inside a batch, and the chi-square of the
counts per training view (12 bins) and per band of 50 image rows (10 bins)
against uniform (11 and 9 degrees of freedom).

With ``--runs`` (on the card) it then trains the runs named by ``--arms``
(the first four by default) with the train PSNR logged every 25 steps and
the test PSNR every 500:

* ``seed0``, ``seed2``: the device-uniform run at seeds 0 and 2; seed 2's
  sampler compares every batch's ids with the replay (``replay_mismatch``,
  the steps whose ids differ: 0 when the replay is the trainer's draw);
* ``ids2``: seed 2 with seed 2's replayed ids, its sampler drawing nothing
  from the step generator, so the jitter comes from other offsets of it;
* ``jitter2``: seed 2 with the step generator's draws as they were (the
  sampler still draws its ids there) but its ids taken from another
  generator (seed 1000);
* ``plain2``, ``plain0``: the device-uniform run at seed 2 and 0 with the
  model's plain PyTorch versions in place of the kernels
  (``model.ops = ops.PLAIN``; ``kernel_launches`` counts the kernels'
  launches in the run: 0).

It prints one JSON object and writes it, after each run, to ``--out``
(``chiprun_out/seed_stream_probe.json`` by default).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from egonerf_torch.tools import sampler_ab  # noqa: E402

BATCH, N_COARSE = 4096, 128
ROW_BAND = 50
OTHER_IDS_SEED = 1000


def replay(seed, n_steps, n_rays, device):
    """(n_steps, BATCH) ray ids that a device-uniform run at ``seed`` draws:
    the step generator's randint then its jitter draw, step by step."""
    g = torch.Generator(device=device).manual_seed(seed + 2)
    ids = torch.empty(n_steps, BATCH, dtype=torch.int64, device=device)
    for t in range(n_steps):
        ids[t] = torch.randint(0, n_rays, (BATCH,), generator=g, device=device)
        torch.rand(BATCH, N_COARSE, generator=g, device=device)
    return ids


def chi2(counts) -> float:
    counts = np.asarray(counts, dtype=np.float64)
    expect = counts.sum() / counts.size
    return float(((counts - expect) ** 2 / expect).sum())


def id_stats(ids, n_views, h, w) -> dict:
    """The summary of an (n_steps, batch) id block."""
    flat = ids.reshape(-1)
    per_batch_repeats = np.array([ids.shape[1] - torch.unique(b).numel() for b in ids])
    views = torch.bincount(flat // (h * w), minlength=n_views).cpu().numpy()
    bands = torch.bincount((flat % (h * w)) // w // ROW_BAND,
                           minlength=h // ROW_BAND).cpu().numpy()
    return {"distinct_share": round(torch.unique(flat).numel() / flat.numel(), 6),
            "batch_repeats_mean": round(float(per_batch_repeats.mean()), 4),
            "batch_repeats_max": int(per_batch_repeats.max()),
            "chi2_views": round(chi2(views), 3), "chi2_row_bands": round(chi2(bands), 3),
            "view_share_min_max": [round(float(views.min() / views.sum()), 6),
                                   round(float(views.max() / views.sum()), 6)]}


def curves(logdir) -> dict:
    """train/PSNR and test/psnr of a run's metrics.jsonl by step."""
    out = {"train": {}, "test": {}}
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for ln in f:
            rec = json.loads(ln)
            if rec["tag"] == "train/PSNR":
                out["train"][int(rec["step"])] = round(rec["value"], 3)
            elif rec["tag"] == "test/psnr":
                out["test"][int(rec["step"]) + 1] = round(rec["value"], 3)
    return out


def run_arm(name, seed, device, next_batch=None) -> dict:
    """sampler_ab's device-uniform run at ``seed``, its sampler's
    ``next_batch`` replaced by ``next_batch`` (given the sampler) if set."""
    from egonerf_torch.data import samplers

    orig = samplers.DeviceRaySampler.next_batch
    if next_batch is not None:
        samplers.DeviceRaySampler.next_batch = next_batch
    try:
        t0 = time.time()
        rec = sampler_ab.run_variant(f"probe_{name}", "simple", True, device=device,
                                     seed=seed, progress_refresh_rate=25)
    finally:
        samplers.DeviceRaySampler.next_batch = orig
    cfg = sampler_ab.make_config(f"probe_{name}", "simple", True)
    rec.update(arm=name, seed=seed, wall_all_s=round(time.time() - t0, 1),
               curves=curves(os.path.join(cfg.basedir, f"probe_{name}")))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--runs", action="store_true")
    ap.add_argument("--arms", default="seed0,seed2,ids2,jitter2")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "seed_stream_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("seed_stream_probe: no CUDA device")
    device = torch.device("cuda")
    n_steps = sampler_ab.N_ITERS
    h, w, n_views = sampler_ab.IMG_H, sampler_ab.IMG_W, sampler_ab.N_TRAIN
    n_rays = n_views * h * w
    seeds = [int(s) for s in args.seeds.split(",")]

    from egonerf_torch.tools import device_name

    result = {"device": device_name(device), "n_rays": n_rays, "batch": BATCH,
              "steps": n_steps, "ids": {}}
    replays = {}
    for s in seeds:
        ids = replay(s, n_steps, n_rays, device)
        replays[s] = ids
        result["ids"][s] = {"first_1000": id_stats(ids[:1000], n_views, h, w),
                            "all": id_stats(ids, n_views, h, w)}
        print(json.dumps({"seed": s, **result["ids"][s]}), flush=True)

    if args.runs:
        seed2 = replays.get(2)
        if seed2 is None:
            seed2 = replay(2, n_steps, n_rays, device)
        state = {"t": 0, "mismatch": 0}

        def checked(sampler):
            ids = torch.randint(0, sampler.buffer.shape[0], (sampler.batch,),
                                generator=sampler.generator, device=sampler.buffer.device)
            state["mismatch"] += int(not torch.equal(ids, seed2[state["t"]]))
            state["t"] += 1
            return sampler.buffer[ids]

        def replayed(sampler):
            ids = seed2[state["t"]]
            state["t"] += 1
            return sampler.buffer[ids]

        other = torch.Generator(device=device).manual_seed(OTHER_IDS_SEED)

        def other_ids(sampler):
            n = sampler.buffer.shape[0]
            torch.randint(0, n, (sampler.batch,), generator=sampler.generator,
                          device=sampler.buffer.device)
            ids = torch.randint(0, n, (sampler.batch,), generator=other,
                                device=sampler.buffer.device)
            return sampler.buffer[ids]

        def plain(seed):
            def arm():
                from egonerf_torch import ops
                from egonerf_torch.train.trainer import Trainer

                counters = (ops.vm_lookup.field_fwd, ops.vm_lookup.field_bwd,
                            ops.vm_lookup.density_fwd, ops.pdf.resample,
                            ops.volrend.composite, ops.volrend.composite_bwd,
                            ops.chart.chart_fwd)
                before = sum(c.launches for c in counters)
                orig = Trainer.set_datasets

                def set_plain(self, *a):
                    self.model.ops = ops.PLAIN
                    return orig(self, *a)
                Trainer.set_datasets = set_plain
                try:
                    rec = run_arm(f"plain{seed}", seed, device)
                finally:
                    Trainer.set_datasets = orig
                rec["kernel_launches"] = sum(c.launches for c in counters) - before
                return rec
            return arm

        def checked_arm():
            state.update(t=0, mismatch=0)
            rec = run_arm("seed2", 2, device, checked)
            rec.update(replay_mismatch=state["mismatch"], replay_steps=state["t"])
            return rec

        def replayed_arm():
            state["t"] = 0
            return run_arm("ids2", 2, device, replayed)

        arms = {"seed0": lambda: run_arm("seed0", 0, device), "seed2": checked_arm,
                "ids2": replayed_arm, "jitter2": lambda: run_arm("jitter2", 2, device, other_ids),
                "plain2": plain(2), "plain0": plain(0)}
        result["runs"] = []
        for name in args.arms.split(","):
            rec = arms[name]()
            print(json.dumps({k: rec[k] for k in rec if k != "curves"}), flush=True)
            result["runs"].append(rec)
            write(args.out, result)

    write(args.out, result)
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}), flush=True)


def write(path, result):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)

if __name__ == "__main__":
    main()
