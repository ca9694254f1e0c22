"""Per-segment step-time drift of a long quality run, from its log
(counterpart of ``egonerf_tpu/tools/refscale_drift.py``).

The trainer's progress line (``train/trainer.py``: ``iter N psnr .. test
.. mse .. rays/s R``) prints the throughput averaged since the last
evaluation event, whose counter restarts after every ``vis_list``
evaluation (``t_start, rays_done = time.time(), 0``).  The step time is
recovered by differencing within each window: with B rays a step and the
window opened at step ``r``,

    wall_since_reset(iter) = (iter - r) * B / raysps(iter)

and the mean step time over [i0, i1] inside one window is ``(wall(i1) -
wall(i0)) / (i1 - i0)``.  A restart shows as a drop of the implied wall;
the segment across it is dropped.  A segment holding a checkpoint or an
upsample takes its one-off cost, so each block of 10k steps reports the
MEDIAN segment time, which such spikes do not move.

    python -m egonerf_torch.tools.refscale_drift [log] [batch]

parses on the host (log ``build/refscale100k.log`` by default, batch 4096)
and writes ``docs/torch/results_refscale100k_drift.json``.
"""
from __future__ import annotations

import json
import os
import re
import sys

from . import RUNS_DIR, write_results

_LINE = re.compile(r"iter (\d+) .*rays/s ([\d,]+)")


def parse_segments(text: str, batch: int = 4096):
    """-> list of (iter_mid, ms_per_step) segments between progress lines.

    Handles the per-vis counter reset: a drop in the implied window wall
    marks a reset, the spanning segment is dropped, and the window origin
    re-anchors at the previous progress iter (error <= one progress
    interval, and the first post-reset segment is self-consistent because
    both endpoints share the new origin).
    """
    raw = []
    for m in _LINE.finditer(text):
        it = int(m.group(1))
        raysps = float(m.group(2).replace(",", ""))
        if raysps > 0:
            raw.append((it, raysps))
    segs = []
    reset_it, prev, top = 0, None, 0.0  # prev = (iter, wall_since_reset)
    for it, raysps in raw:
        if raysps < 0.05 * top:
            # artifact line printed with a freshly-reset counter (real
            # amortized throughput never collapses 20x between adjacent
            # progress lines): the reset happened at ~this iter
            reset_it, prev = it, None
            continue
        top = max(top, raysps)
        if it <= reset_it:
            prev = None
            continue
        w = (it - reset_it) * batch / raysps
        if prev is not None and it > prev[0]:
            dw = w - prev[1]
            if dw < 0:  # counter reset between prev and here: re-anchor
                reset_it, prev = prev[0], None
                w2 = (it - reset_it) * batch / raysps
                prev = (it, w2)
                continue
            segs.append(((prev[0] + it) // 2,
                         1000.0 * dw / (it - prev[0])))
        prev = (it, w)
    return segs


def drift_blocks(segs, block: int = 10_000):
    """Per-`block` median/mean step time from (iter_mid, ms) segments.

    Segments >2x the block median carry a one-off event (checkpoint
    write, vis/eval pause, or the artifact progress line printed with a
    freshly-reset counter) — they are counted as ``n_event_segments`` and
    excluded from the mean, so mean vs median agreement certifies the
    steady-state step time.
    """
    blocks = []
    n_blocks = (max(m for m, _ in segs) + block) // block if segs else 0
    for b in range(n_blocks):
        lo, hi = b * block, (b + 1) * block
        ms = sorted(s for mid, s in segs if lo <= mid < hi)
        if not ms:
            continue
        med = ms[len(ms) // 2]
        steady = [s for s in ms if s <= 2 * med]
        blocks.append({
            "block": f"{lo // 1000}k-{hi // 1000}k",
            "median_ms_per_step": round(med, 2),
            "mean_ms_per_step": round(sum(steady) / len(steady), 2),
            "n_segments": len(ms),
            "n_event_segments": len(ms) - len(steady),
        })
    return blocks


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    log = argv[0] if argv else os.path.join(RUNS_DIR, "refscale100k.log")
    batch = int(argv[1]) if len(argv) > 1 else 4096
    with open(log) as f:
        segs = parse_segments(f.read(), batch)
    blocks = drift_blocks(segs)
    med = sorted(b["median_ms_per_step"] for b in blocks)
    rec = {
        "log": os.path.basename(log), "batch": batch,
        "last_iter_mid": max(m for m, _ in segs) if segs else 0,
        "blocks": blocks,
        "spread_pct": (round(100.0 * (med[-1] - med[0]) / med[0], 2)
                       if len(med) > 1 else None),
    }
    print(json.dumps(rec, indent=1))
    write_results("refscale100k_drift", rec)


if __name__ == "__main__":
    main()
