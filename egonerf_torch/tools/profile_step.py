"""A device-time breakdown of the production training step and of an eval
view on the card (counterpart of ``egonerf_tpu/tools/profile_step.py``).

:func:`capture` runs the production trainer with ``profile_dir`` (the
trainer's window traces ``PROFILE_TRACE_ITERS`` steps from 16 steps after
the start and writes torch's Chrome trace ``trace.json`` and
``traced_steps.json``); :func:`capture_eval` traces ``render_view`` of
2000x1000 views under ``torch.profiler`` into ``<dir>_eval``.  From such a
trace :func:`summarize` gives the device time of each operation a traced
step, and :func:`families` buckets every device operation (kernels,
copies, sets) into a named family by its kernel's name, so that the
table sums to the window's whole device time; "other" is printed with its
top names.  Beside the table it gives the device-busy share: the union of
the device intervals over the traced window.  A trace without a device
operation fails.

    python -m egonerf_torch.tools.profile_step                 # capture, then both tables
    python -m egonerf_torch.tools.profile_step --summarize-only
    python -m egonerf_torch.tools.profile_step --eval
    python -m egonerf_torch.tools.profile_step DIR             # a trace's tables, no record

capture on the card (``PROFILE_TRAIN_KEEP`` traces the culled step) and
write ``docs/torch/results_profile_families.json`` or, with ``--eval``,
``results_profile_eval_families.json`` (with ``device``, the card's name
and power limit).
"""
from __future__ import annotations

import json
import os
import re
import sys
from collections import Counter, defaultdict

from . import RUNS_DIR, device_name, positional, write_results

PROFILE_DIR = os.path.join(RUNS_DIR, "profile")
# the window (16 steps from the start, PROFILE_TRACE_ITERS long) inside the
# run, as JAX's
N_ITERS = 160
# the trace's device operations: kernels, copies and sets
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sym(pattern: str) -> str:
    """A kernel symbol, demangled or mangled (``_Z16vm_lookup_kernel...``):
    no letter or underscore before it."""
    return r"(?<![A-Za-z_])" + pattern


# (family, pattern over the operation's name): the first match wins.  The
# port's kernels by their symbols (csrc/), then the library's operations
# by the names torch and cuBLAS give them.
_FAMILY_RULES = (
    ("K1 field", _sym(r"vm_lookup_kernel(?:<true|ILb1E)")),
    ("K3 density", _sym(r"vm_lookup_kernel(?:<false|ILb0E)")),
    ("K2 field backward", _sym("vm_field_bwd_kernel")),
    ("K4 resample", _sym("resample_kernel")),
    ("K4c cull coarse pass", _sym("resample_score_kernel")),
    ("K5 sorted uniforms", _sym("sorted_uniform_kernel")),
    ("K6 composite", _sym("composite_kernel")),
    ("K6b composite backward", _sym("composite_bwd_kernel")),
    ("K7 chart", _sym("chart_kernel")),
    ("K7s sphere chart", _sym("chart_sphere_kernel")),
    ("K8 envmap", _sym("envmap_kernel")),
    ("K8b envmap backward", _sym("envmap_bwd_kernel")),
    ("K9 alpha mask", _sym("alphamask_kernel")),
    ("K10 mixed matmul", _sym("mm_(?:fwd|fwd_narrow|rows|db|db_sum)_kernel")),
    ("K11 bias gradient", _sym("bias_grad_(?:part|sum)_kernel")),
    ("K12 cull score", _sym("cull_score_kernel")),
    ("K13 top-K", _sym("top_k_kernel")),
    ("K14 theta ids", _sym("theta_ids_kernel")),
    ("K14f theta batch", _sym("theta_batch_kernel")),
    ("K15 no-grad lookup", _sym("vm_sample_kernel")),
    ("K16 line sample", _sym("line_sample_kernel")),
    ("K17 CP line product", _sym("cp_(?:fwd|dens_sum|fwd_unstaged)_kernel")),
    ("K17b CP backward", _sym("cp_(?:bwd|bwd_sum|bwd_unstaged)_kernel")),
    ("shader GEMMs", r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitK"),
    ("cat copies", r"CatArray"),
    ("Adam (multi_tensor_apply)", r"multi_tensor_apply"),
    # torch.zeros of the gradients and the scatter targets (a fill with any
    # value lands here too), and memsets
    ("zero fills", r"FillFunctor|^Memset"),
    ("memcpy", r"^Memcpy"),
    ("elementwise and reductions", r"elementwise|reduce_kernel|Reduce"),
)
OTHER = "other"


def family_of(name: str) -> str:
    """The family of a device operation's name: the first rule that
    matches, else ``OTHER``."""
    for fam, pat in _FAMILY_RULES:
        if re.search(pat, name):
            return fam
    return OTHER


def load_trace(profile_dir: str) -> list:
    """The events of ``profile_dir/trace.json`` (torch's Chrome trace)."""
    with open(os.path.join(profile_dir, "trace.json")) as f:
        return json.load(f)["traceEvents"]


def device_events(events: list) -> list:
    """The device operations of a trace (``DEVICE_CATS``), each
    (name, start us, duration us); none raises: the tool never falls back
    to host time."""
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    if not ops:
        raise RuntimeError("the trace holds no device operation (kernel, memcpy or memset): "
                           "the profiler saw no device time")
    return ops


def busy_share(events: list, ops: list) -> tuple:
    """(the union of the device intervals, the traced window) in us: the
    window spans every complete event of the trace, host and device."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
             if e.get("ph") == "X" and "ts" in e]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy, end = 0.0, float("-inf")
    for start, dur in sorted((s, d) for _, s, d in ops):
        lo, hi = max(start, end), start + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy, window


def traced_meta(profile_dir: str) -> dict:
    """``traced_steps.json``: the steps the window holds (``steps``) and,
    where this tool captured it, the card (``device``)."""
    try:
        with open(os.path.join(profile_dir, "traced_steps.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        from ..train.trainer import PROFILE_TRACE_ITERS

        return {"steps": PROFILE_TRACE_ITERS}


def summarize(profile_dir: str = PROFILE_DIR, top: int = 40, events=None) -> list:
    """Device ms of each operation a traced step, by name, largest first
    (the ``top`` printed); rows (name, ms a step, share)."""
    events = load_trace(profile_dir) if events is None else events
    ops = device_events(events)
    n_steps = traced_meta(profile_dir)["steps"]
    per_op = defaultdict(float)
    for name, _, dur in ops:
        per_op[name] += dur / 1e3
    total = sum(per_op.values())
    rows = [(name, ms / n_steps, ms / total) for name, ms in
            sorted(per_op.items(), key=lambda kv: -kv[1])]
    print(f"\n=== device operations: {len(ops)} in {n_steps} steps, {total / n_steps:.3f} "
          f"ms/step ===")
    print(f"{'operation':72s} {'ms/step':>8s} {'share':>7s}")
    for name, ms, share in rows[:top]:
        print(f"{name[:72]:72s} {ms:8.3f} {100 * share:6.1f}%")
    return rows


def families(profile_dir: str = PROFILE_DIR, write: bool = True,
             name: str = "profile_families", device=None, events=None) -> dict:
    """Bucket every device operation of the trace into a family
    (:func:`family_of`); the families sum to the window's device time.
    Prints the table, "other" with its top names, and the busy share;
    with ``write`` writes the record ``name`` (``device``: the card's name
    and power limit, by default ``traced_steps.json``'s)."""
    events = load_trace(profile_dir) if events is None else events
    ops = device_events(events)
    meta = traced_meta(profile_dir)
    n_steps = meta["steps"]
    per_fam, examples = Counter(), {}
    for op, _, dur in ops:
        fam = family_of(op)
        per_fam[fam] += dur / 1e3
        examples.setdefault(fam, Counter())[op] += dur / 1e3
    total = sum(per_fam.values())
    busy, window = busy_share(events, ops)
    print(f"\n=== family accounting: {total / n_steps:.3f} ms/step of device time over "
          f"{n_steps} steps; device busy {busy / 1e3 / n_steps:.3f} of "
          f"{window / 1e3 / n_steps:.3f} "
          f"ms/step in the window ({busy / window:.1%}) ===")
    print(f"{'family':28s} {'ms/step':>8s} {'share':>7s}  top operation")
    rows = []
    for fam, ms in per_fam.most_common():
        top_op = examples[fam].most_common(1)[0][0]
        print(f"{fam:28s} {ms / n_steps:8.3f} {100 * ms / total:6.1f}%  {top_op[:60]}")
        rows.append({"family": fam, "ms_per_step": ms / n_steps,
                     "share_pct": 100 * ms / total,
                     "top_ops": [{"name": op, "ms_per_step": d / n_steps}
                                 for op, d in examples[fam].most_common(5)]})
    if OTHER in examples:
        print(f"{OTHER}, its top operations:")
        for op, d in examples[OTHER].most_common(8):
            print(f"  {d / n_steps:8.4f} ms/step  {op[:90]}")
    rec = {"ms_per_step_total": total / n_steps, "n_steps": n_steps,
           "n_device_ops": len(ops), "busy_ms_per_step": busy / 1e3 / n_steps,
           "window_ms_per_step": window / 1e3 / n_steps, "busy_share": busy / window,
           "device": device or meta.get("device"), "families": rows}
    if write:
        write_results(name, rec)
    return rec


def _note_device(profile_dir: str, dev, **extra) -> None:
    """Add the card (and ``extra``) to ``traced_steps.json``."""
    meta = traced_meta(profile_dir)
    meta.update(device=device_name(dev), **extra)
    with open(os.path.join(profile_dir, "traced_steps.json"), "w") as f:
        json.dump(meta, f)


def capture(device="cuda", profile_dir: str = PROFILE_DIR, **deltas) -> str:
    """Train the production shape ``N_ITERS`` steps with ``profile_dir``
    (``deltas`` win; ``PROFILE_TRAIN_KEEP`` traces the culled step) in a
    fresh folder; returns ``profile_dir``."""
    import shutil

    from .._device import resolve_device
    from ..data.datasets import SyntheticEgoDataset
    from ..presets import production_overrides
    from ..train.config import load_config
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    train_keep = int(os.environ.get("PROFILE_TRAIN_KEEP", 0))
    cfg = load_config(overrides=production_overrides(**{**dict(
        n_iters=N_ITERS, progress_refresh_rate=16,
        basedir=os.path.join(RUNS_DIR, "profile_run"), expname="profile", N_vis=0,
        profile_dir=profile_dir, train_keep=train_keep), **deltas}))
    if train_keep:
        print(f"profiling the train_keep={train_keep} culled step")
    # a fresh run, always: a finished checkpoint would resume at n_iters
    # and trace nothing
    shutil.rmtree(os.path.join(cfg.basedir, cfg.expname), ignore_errors=True)
    shutil.rmtree(profile_dir, ignore_errors=True)
    trainer = Trainer(cfg, device=dev)
    common = dict(n_train=4, n_test=1, height=500, width=1000, near_far=cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", is_stack=False, **common),
                         SyntheticEgoDataset(split="test", is_stack=True, **common))
    trainer.train()
    _note_device(profile_dir, dev)
    return profile_dir


def capture_eval(height: int = 1000, width: int = 2000, n_images: int = 2, device="cuda",
                 profile_dir: str = PROFILE_DIR + "_eval", **deltas) -> str:
    """Trace ``render_view`` of ``n_images`` views of the production model
    (seeded random weights; ``PROFILE_EVAL_CHUNK`` sets the chunk) after a
    warm view; writes ``trace.json`` and ``traced_steps.json`` (the views as
    steps, the best s/image on the host clock, each view synchronised) into
    ``profile_dir``, which it returns."""
    import shutil
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..render.renderer import Renderer
    from .eval_ship import scene_trainer

    trainer = scene_trainer("profile_eval_run", 1, height, width, device, **deltas)
    dev, test_ds = trainer.device, trainer.test_dataset
    renderer = Renderer.from_config(
        trainer.model, trainer.cfg, test_ds.white_bg,
        chunk=int(os.environ.get("PROFILE_EVAL_CHUNK", trainer.cfg.eval_chunk)))
    renderer.set_directions(test_ds.directions)
    pose = test_ds.poses[0]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    renderer.render_view(trainer.params, pose)  # warm
    sync()
    times = []
    with profile(activities=acts) as prof:
        for _ in range(n_images):
            t0 = time.perf_counter()
            renderer.render_view(trainer.params, pose)
            sync()
            times.append(time.perf_counter() - t0)
    shutil.rmtree(profile_dir, ignore_errors=True)
    os.makedirs(profile_dir)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    n_rays = height * width
    print(f"eval trace: {n_images} x {width}x{height} views, best {min(times):.3f} s/image = "
          f"{n_rays / min(times):,.0f} rays/s")
    with open(os.path.join(profile_dir, "traced_steps.json"), "w") as f:
        json.dump({"steps": n_images, "sec_per_image": min(times),
                   "rays_per_sec": n_rays / min(times)}, f)
    _note_device(profile_dir, dev)
    return profile_dir


def main(argv=None):
    from .._device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    # a directory argument reads that trace; only a capture needs the card
    dirs = positional(argv)
    if dirs:
        summarize(dirs[0])
        families(dirs[0], write=False)
        return
    if "--eval" in argv:
        resolve_device("cuda")
        eval_dir = capture_eval()
        summarize(eval_dir)
        families(eval_dir, name="profile_eval_families")
        return
    if "--summarize-only" not in argv:
        resolve_device("cuda")
        capture()
    summarize()
    families()


if __name__ == "__main__":
    main()
