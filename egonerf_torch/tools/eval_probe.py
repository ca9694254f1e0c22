"""Where an eval view's time goes: device compute, the copy to the host,
and the chunk size (counterpart of ``egonerf_tpu/tools/eval_probe.py``).

Modes, each a 2000x1000 view of the production model (seeded random
weights: the time depends on the shapes, not on the values):

* ``none``: render, reduce every output to one scalar on the card, copy 4
  bytes: the device's compute and the host's launches.
* ``rgb``: copy the rgb map alone to the host (24 MB float32): what the
  metrics need.
* ``all``: copy every output (rgb, depth, and with the envmap bg): what
  ``evaluation()`` copies.
* ``pipe2``: ``all`` with the copy of view k on a side stream, after an
  event recorded at the end of view k's render, into pinned host buffers,
  while view k + 1 renders on the main stream; per view, amortised (what
  a loop over views can hide).

Axes: mode x eval chunk (``EVAL_PROBE_CHUNKS``, default 4096,8192,16384;
``EVAL_PROBE_MODES``; ``EVAL_PROBE_REPS``, default 2, the best of them).
Each row also gives the peak device memory of its chunk's renders.

    python -m egonerf_torch.tools.eval_probe [out.json]

runs on the card and writes ``docs/torch/results_eval_probe.json`` (JAX's
keys and ``device``, the card's name and power limit), and a copy to
``out.json`` where one is named.
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import device_name, positional, write_results

MODES = ("none", "rgb", "all", "pipe2")


class _SideCopy:
    """Copies a view's outputs to pinned host buffers on a side stream of
    the card, each copy queued behind an event recorded on the main stream
    when the view's render has been queued."""

    def __init__(self, dev):
        import torch

        self.dev = dev
        self.stream = torch.cuda.Stream(dev)
        self.host = {}

    def start(self, out: dict) -> None:
        import torch

        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.dev))
        self.stream.wait_event(done)
        with torch.cuda.stream(self.stream):
            for k, v in out.items():
                buf = self.host.get(k)
                if buf is None or buf.shape != v.shape:
                    buf = self.host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                # the main stream may reuse v's memory once the copy is done
                v.record_stream(self.stream)

    def wait(self) -> dict:
        self.stream.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


def _time_mode(mode: str, render, reps: int, dev, sync) -> float:
    """Seconds a view in ``mode``: the best of ``reps`` (``pipe2``: the
    mean over max(reps, 2) views)."""
    import torch

    if mode == "pipe2":
        if dev.type != "cuda":
            raise RuntimeError("pipe2 overlaps a side stream of the card")
        side = _SideCopy(dev)
        n_imgs = max(reps, 2)
        sync()
        pending = render()
        t0 = time.perf_counter()
        for _ in range(n_imgs):
            side.start(pending)
            pending = render()
            side.wait()
        seconds = (time.perf_counter() - t0) / n_imgs
        sync()
        return seconds
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = render()
        if mode == "none":
            float(torch.stack([v.sum() for v in out.values()]).sum())
        elif mode == "rgb":
            out["rgb"].cpu().numpy()
        elif mode == "all":
            for v in out.values():
                v.cpu().numpy()
        else:
            raise SystemExit(f"unknown mode {mode!r}")
        times.append(time.perf_counter() - t0)
    return min(times)


def _run(chunks=(4096, 8192, 16384), modes=MODES, reps: int = 2, height: int = 1000,
         width: int = 2000, device="cuda", **deltas) -> dict:
    import numpy as np
    import torch

    from ..render.renderer import Renderer
    from .eval_ship import scene_trainer

    trainer = scene_trainer("eval_probe", 1, height, width, device, **deltas)
    cfg, test_ds, dev = trainer.cfg, trainer.test_dataset, trainer.device
    pose = np.asarray(test_ds.poses[0], np.float32)
    n_rays = height * width
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    rows = []
    for chunk in chunks:
        renderer = Renderer.from_config(trainer.model, cfg, test_ds.white_bg, chunk=chunk)
        renderer.set_directions(test_ds.directions)

        def render():
            return renderer.render_view(trainer.params, pose)

        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        render()  # warm
        for mode in modes:
            best = _time_mode(mode, render, reps, dev, sync)
            row = {"chunk": chunk, "mode": mode, "sec_per_image": round(best, 3),
                   "rays_per_sec": round(n_rays / best, 1),
                   "peak_mem_gb": (round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
                                   if cuda else None)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del renderer
    return {"image": f"{width}x{height}", "n_samples": f"{cfg.n_coarse}+{cfg.n_fine}",
            "platform": dev.type, "device": device_name(dev), "reps": reps, "rows": rows}


def main(argv=None) -> dict:
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device("cuda")
    chunks = [int(c) for c in os.environ.get("EVAL_PROBE_CHUNKS", "4096,8192,16384").split(",")]
    modes = os.environ.get("EVAL_PROBE_MODES", ",".join(MODES)).split(",")
    reps = int(os.environ.get("EVAL_PROBE_REPS", "2"))
    result = _run(chunks, modes, reps)
    path = write_results("eval_probe", result)
    args = positional(argv)
    if args:
        with open(args[0], "w") as f:
            json.dump(result, f, indent=1)
        path = args[0]
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
