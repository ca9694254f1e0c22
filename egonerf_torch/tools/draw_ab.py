"""The training path's draws of this checkout against another revision's, on
one CUDA card, on recorded production inputs: the K4 arguments of a
production training step (4096 rays, 128 + 128 samples, its (seed, step)
key) and 4,096-draw theta batches on the roi-cropped 1920x960 Ricoh raster
of ``chip_smoke.py``'s phase 20 (roi [0.05, 0.95, 0, 1], 6 images).

    python -m egonerf_torch.tools.draw_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's
``sorted_uniform.cu``, ``resample.cu``, ``theta_sampler.cu`` and the
headers they include (its ``egonerf_torch/csrc`` from ``git archive``),
whose ``resample_chart_fwd``, ``resample_score_fwd`` and ``theta_ids``
take this checkout's arguments and whose ``sorted_uniform_fwd`` takes no
ray offset (``OTHER_K5_ARGS``).

``--ablate`` first times the other revision's K5 as it is and ablated by
text edits of a copy of its source (``K5_EDITS``; the outputs are wrong,
and the tool stops where an edit does not apply): an empty launch of its
grid, constant bits in place of Philox, ``logf`` in place of the float64
``log``, no scan, and as it is on 1/8 to all of the step's rays; then its
K4 and K4c training instantiations on K5's uniforms, and
the theta sampler's five launches (the image, column and uniform draws,
its K14, the gather) against this checkout's one: alone, and inside
production theta steps by the profiler (the device time of the torch ops
in the sampler's range, the theta kernels' own, and the step's device
operations).

Then, bit for bit: this K5 against the other's at 128 draws a ray and at
1, 33, 48, 97 and 255; this K4's and K4c's training instantiations (the
draw in their prologue) against the other K5 followed by the other K4 or
K4c on its uniforms (z_vals, dists, and the coords or the scores), each
timed in turns (other pair, this pair, this fused, ..., other pair) beside
its byte bound.  A miss is printed and makes the exit code 1 after the
timings.  Prints one line a measurement and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
from pathlib import Path

import torch

from .. import _build, ops, presets
from ..ops import chart as chart_ops
from ..ops import merge, pdf, sampler
from .composite_ab import _edited
from .resample_ab import _build_all, _fn, _turns

OUT = _build.BUILD_ROOT.parent / "draw_ab"
# the other revision's K5 entry: (R, n, seed, step, out, stream), no ray offset
OTHER_K5_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                 ctypes.c_void_p]
SWEEP = (1, 33, 48, 97, 255)
THETA_ROI = (0.05, 0.95, 0.0, 1.0)
PROFILE_STEPS = 5
# text edits of the other sorted_uniform.cu: an empty launch (EMPTY),
# constant words in place of the Philox block (CONST_BITS), logf in place
# of the float64 log (LOGF), the chunk sums and their scan skipped (NO_SCAN)
K5_EDITS = (
    ("  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;\n"
     "  if (ray >= R) return;\n",
     "  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;\n"
     "#ifdef EMPTY\n  return;\n#endif\n  if (ray >= R) return;\n"),
    ("  const U4 o = philox4x32_10(U4{(uint32_t)(j >> 2), (uint32_t)ray,\n"
     "                                (uint32_t)((unsigned long long)ray >> 32), kStream},\n"
     "                             k0, k1);\n",
     "#ifdef CONST_BITS\n"
     "  const U4 o = U4{0x9E3779B9u * (uint32_t)(j + 1), 0x85EBCA6Bu ^ (uint32_t)ray, k0, k1};\n"
     "#else\n"
     "  const U4 o = philox4x32_10(U4{(uint32_t)(j >> 2), (uint32_t)ray,\n"
     "                                (uint32_t)((unsigned long long)ray >> 32), kStream},\n"
     "                             k0, k1);\n#endif\n"),
    ("  const double u = ((double)bits + 0.5) * 2.3283064365386963e-10;  // 2^-32\n"
     "  return (float)(-log(u));\n",
     "#ifdef LOGF\n  return -logf(((float)bits + 0.5f) * 2.3283064365386963e-10f);\n#else\n"
     "  const double u = ((double)bits + 0.5) * 2.3283064365386963e-10;  // 2^-32\n"
     "  return (float)(-log(u));\n#endif\n"),
    ("  const int per = (m + 31) / 32;\n  const int a = min(lane * per, m), b = min(a + per, m);\n"
     "  float local = 0.0f;\n",
     "#ifndef NO_SCAN\n"
     "  const int per = (m + 31) / 32;\n  const int a = min(lane * per, m), b = min(a + per, m);\n"
     "  float local = 0.0f;\n"),
    ("    c[j] = run;\n  }\n  __syncwarp();\n",
     "    c[j] = run;\n  }\n  __syncwarp();\n#endif\n"))
K5_ABLATIONS = (("as it is", []), ("empty launch", ["-DEMPTY"]),
                ("constant bits", ["-DCONST_BITS"]), ("logf", ["-DLOGF"]),
                ("no scan", ["-DNO_SCAN"]))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _other_k5(f, r, n, draw, dev):
    out = torch.empty(r, n, device=dev)

    def run():
        err = f(r, n, draw[0] & merge._MASK, draw[1] & merge._MASK, out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"sorted_uniform_fwd: cudaError {err}")
        return out
    return run


def _other_resample(f, name, args, u, rays=None):
    """The other revision's K4 (``resample_chart_fwd``, with ``rays``) or
    K4c (``resample_score_fwd``) on ``args`` with ``u``; returns a run
    giving (z_vals, dists, coords or scores)."""
    feat, z, d, n_f, _, merge_, shift, scale, act = args
    r, s = feat.shape
    n_out = s + n_f if merge_ else n_f
    dev = feat.device
    zo, do = torch.empty(r, n_out, device=dev), torch.empty(r, n_out, device=dev)
    third = (torch.empty(r * n_out, 4, device=dev) if rays is not None
             else torch.empty(r, n_out, device=dev))
    extra = ()
    if rays is not None:
        rays_o, viewdirs, coords = rays
        extra = (rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                 *chart_ops.chart_args(coords, None, dev))

    def run():
        err = f(feat.data_ptr(), z.data_ptr(), d.data_ptr(), u.data_ptr(), n_f,
                chart_ops._recip(n_f - 1) if n_f > 1 else 0.0, r, s, n_f, int(merge_), shift,
                scale, pdf.ACTIVATIONS.index(act), zo.data_ptr(), do.data_ptr(), *extra,
                third.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return zo, do, third
    return run


class FiveLaunchSampler:
    """The other revision's theta sampler on a buffer and cdf: per batch the
    image, the column (``torch.randint``) and the uniform (``torch.rand``)
    from a generator, its K14 for the ids, and the gather."""

    def __init__(self, k14, buffer, cdf, w, h, batch, seed=0):
        self.k14, self.buffer, self.cdf = k14, buffer, cdf
        self.w, self.h, self.batch = w, h, batch
        self.img_len = buffer.shape[0] // (w * h)
        self.gen = torch.Generator(device=buffer.device).manual_seed(seed)
        self.ids = torch.empty(batch, dtype=torch.int64, device=buffer.device)

    def next_batch(self):
        dev, b, g = self.buffer.device, self.batch, self.gen
        img = torch.randint(0, self.img_len, (b,), generator=g, device=dev)
        col = torch.randint(0, self.w, (b,), generator=g, device=dev)
        u = torch.rand(b, generator=g, device=dev)
        err = self.k14(img.data_ptr(), col.data_ptr(), u.data_ptr(), b, self.cdf.data_ptr(),
                       self.h, self.w, self.ids.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"theta_ids: cudaError {err}")
        return self.buffer[self.ids]


def record_step(cs, dev):
    """A production training step's K4 arguments (u None), chart rays and
    (seed, step) key, and its trainer."""
    from ..train.config import load_config
    from ..train.trainer import Trainer

    trainer = Trainer(load_config(overrides=presets.production_overrides(
        basedir=str(OUT / "runs"), expname="production", n_iters=10 ** 9, N_vis=0,
        progress_refresh_rate=10 ** 9)), device=dev)
    rec = cs.Recorder(ops.KERNELS.resample_chart)
    trainer.model.ops = ops.KERNELS._replace(resample_chart=rec)
    trainer.train_step(1)
    trainer.model.ops = ops.KERNELS
    torch.cuda.synchronize()
    return rec.args[:9], rec.args[9:12], rec.kwargs["draw"], trainer


def theta_inputs(cs, dev):
    """The roi-cropped Ricoh raster: its buffer (6 images, rows of 9
    seeded floats), float32 cdf, w and h."""
    import numpy as np

    sam = cs.theta_raster(THETA_ROI)
    cdf = torch.as_tensor(np.cumsum(sam.weight).astype(np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 31)
    buffer = torch.rand(sam.img_len * sam.w * sam.h, 9, generator=gen, device=dev)
    return buffer, cdf, sam.w, sam.h


def sampler_in_steps(cs, trainer, samplers: dict) -> None:
    """Each sampler in ``samplers`` in place of ``trainer``'s, PROFILE_STEPS
    production theta steps under the profiler: the device time a step of
    the torch ops in the sampler's range (the draws and the gather; a kernel
    launched through ``ctypes`` is attributed to no range: K14 and K14f are
    printed apart), and the step's device operations."""
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = trainer.sampler
    try:
        for name, s in samplers.items():
            def next_batch(s=s):
                with record_function("theta sampler"):
                    return s.next_batch()
            trainer.sampler = type("Ranged", (), {"next_batch": staticmethod(next_batch)})()
            for it in range(1, 4):
                trainer.train_step(it)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for it in range(4, 4 + PROFILE_STEPS):
                    trainer.train_step(it)
                torch.cuda.synchronize()
            ranges = [e for e in prof.events() if e.name == "theta sampler"
                      and e.device_type == torch.autograd.DeviceType.CPU]
            dev_us = sum(e.device_time_total for e in ranges)
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation",
                                                                       False)]
            n_ops = sum(e.count for e in rows) / PROFILE_STEPS
            busy = sum(e.self_device_time_total for e in rows) / 1e3 / PROFILE_STEPS
            theta = "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / e.count:.4f} ms"
                              for e in rows if "theta_" in e.key)
            print(f"theta step, {name}: the sampler's torch ops "
                  f"{dev_us / 1e3 / PROFILE_STEPS:.4f} device ms a step; {theta}; the step "
                  f"{n_ops:.1f} device operations, {busy:.3f} device ms", flush=True)
    finally:
        trainer.sampler = saved


def ablate(cs, libs, args, rays, draw, trainer, theta) -> None:
    """The other revision's K5 as it is and ablated, its K4 on K5's
    uniforms, and the theta sampler's five launches against one."""
    r, n_f = args[0].shape[0], args[3]
    dev = args[0].device
    _turns(cs, "ablation K5", {
        name: _other_k5(_fn(libs[f"K5 {name}"], "sorted_uniform_fwd", OTHER_K5_ARGS), r, n_f, draw,
                        dev) for name, _ in K5_ABLATIONS})
    # a kernel held by one warp's chain keeps its time as the warps an SM
    # runs fall, one held by the SM's issue rate falls with them
    k5 = _fn(libs["other sorted_uniform"], "sorted_uniform_fwd", OTHER_K5_ARGS)
    _turns(cs, "ablation K5 rays", {f"{m} rays": _other_k5(k5, m, n_f, draw, dev)
                                    for m in (r // 8, r // 4, r // 2, r)})
    u = _other_k5(k5, r, n_f, draw, dev)().clone()
    _turns(cs, "ablation K4 and K4c training instantiations on K5's uniforms", {
        "K4": _other_resample(_fn(libs["other resample"], "resample_chart_fwd", pdf._CHART_ARGS),
                              "resample_chart_fwd", args, u, rays),
        "K4c": _other_resample(_fn(libs["other resample"], "resample_score_fwd",
                                   pdf._WEIGHTS_ARGS), "resample_score_fwd", args, u)})
    buffer, cdf, w, h = theta
    k14 = _fn(libs["other theta_sampler"], "theta_ids", sampler._ARGS)
    five = FiveLaunchSampler(k14, buffer, cdf, w, h, cs.THETA_DRAWS)
    _turns(cs, f"theta sampler, {cs.THETA_DRAWS} draws on the {w}x{h} raster", {
        "other five launches": five.next_batch,
        "this one launch": lambda: sampler.theta_batch(buffer, cdf, w, h, cs.THETA_DRAWS, 0, 1)})
    sampler_in_steps(cs, trainer, {
        "other five launches": FiveLaunchSampler(k14, trainer.sampler.buffer,
                                                 trainer.sampler.cdf, trainer.sampler.w,
                                                 trainer.sampler.h, trainer.sampler.batch),
        "this one launch": trainer.sampler})


def compare(cs, libs, args, rays, draw, theta) -> bool:
    """This K5, K4 and K4c training instantiations against the other
    revision's, bit for bit, timed in turns; returns whether all held."""
    feat = args[0]
    r, n_c, n_f = feat.shape[0], feat.shape[1], args[3]
    dev = feat.device
    k5 = _fn(libs["other sorted_uniform"], "sorted_uniform_fwd", OTHER_K5_ARGS)
    ok = True
    for n in (n_f, *SWEEP):
        diff = cs.bits_differ([merge.sorted_uniform(r, n, *draw, dev)],
                              [_other_k5(k5, r, n, draw, dev)()])
        ok = ok and diff == 0
        print(f"K5 at {r} x {n}: {diff} uniforms differ from the other's bits -> "
              f"{'ok' if diff == 0 else 'MISS'}", flush=True)
    t = _turns(cs, f"K5 at {r} x {n_f}", {
        "other": _other_k5(k5, r, n_f, draw, dev),
        "this": lambda: merge.sorted_uniform(r, n_f, *draw, dev)})
    bound_ms = 4 * r * n_f / cs.PEAK_BYTES_PER_S * 1e3
    print(f"K5: this {t['this']:.4f} ms (other {t['other']:.4f}); byte bound {bound_ms:.4f} ms",
          flush=True)

    n_grid = rays[2].ref_grid.shape[0]
    for label, entry, argtypes, op, extra, cost in (
            ("K4", "resample_chart_fwd", pdf._CHART_ARGS, ops.KERNELS.resample_chart, rays,
             cs.k4_cost(feat, n_f, n_c + n_f, n_grid=n_grid)),
            ("K4c", "resample_score_fwd", pdf._WEIGHTS_ARGS, ops.KERNELS.resample_score, None,
             cs.k4c_cost(feat, n_f, n_c + n_f))):
        f = _fn(libs["other resample"], entry, argtypes)
        other_u = _other_k5(k5, r, n_f, draw, dev)
        xs = () if extra is None else extra
        for n in (n_f, *SWEEP):
            a = (*args[:3], n, *args[4:])
            want = _other_resample(f, entry, a, _other_k5(k5, r, n, draw, dev)().clone(), extra)()
            diff = cs.bits_differ(op(*a, *xs, draw=draw), want)
            ok = ok and diff == 0
            print(f"{label} + draw at {r} x {n_c} + {n}: {diff} outputs differ from the other K5 "
                  f"then {label}'s bits -> {'ok' if diff == 0 else 'MISS'}", flush=True)
        u_buf = other_u()
        other_op = _other_resample(f, entry, args, u_buf, extra)

        def other_pair():
            other_u()
            return other_op()
        t = _turns(cs, f"{label} training instantiation", {
            "other K5 + op": other_pair,
            "this K5 + op": lambda: op(*cs.drawn_u(ops, args, draw), *xs),
            "this op + draw": lambda: op(*args, *xs, draw=draw)})
        b_ms = cost[0] / cs.PEAK_BYTES_PER_S * 1e3
        print(f"{label} + draw: this {t['this op + draw']:.4f} ms against the other pair "
              f"{t['other K5 + op']:.4f} ({t['other K5 + op'] / t['this op + draw']:.2f}x); byte "
              f"bound {b_ms:.4f} ms ({cost[0] / 1e6:.1f} MB), this at "
              f"{b_ms / t['this op + draw']:.1%} of it", flush=True)

    buffer, cdf, w, h = theta
    k14 = _fn(libs["other theta_sampler"], "theta_ids", sampler._ARGS)
    five = FiveLaunchSampler(k14, buffer, cdf, w, h, cs.THETA_DRAWS)
    t = _turns(cs, f"theta batch of {cs.THETA_DRAWS} on the {w}x{h} raster", {
        "other five launches": five.next_batch,
        "this K14f": lambda: sampler.theta_batch(buffer, cdf, w, h, cs.THETA_DRAWS, 0, 1)})
    n_bytes = cs.THETA_DRAWS * (8 + 2 * 36) + 4 * h
    print(f"K14f: this {t['this K14f']:.4f} ms against the other's five launches "
          f"{t['other five launches']:.4f}; byte bound "
          f"{n_bytes / cs.PEAK_BYTES_PER_S * 1e3:.5f} ms ({n_bytes / 1e3:.0f} KB)", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other K5 and the theta samplers")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("draw_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for stem in ("sorted_uniform", "resample", "theta_sampler"):
        for name, regs, spill in _build.ptxas_report(stem):
            print(f"ptxas {stem}: {regs} registers, {spill} bytes spilled: {name[:80]}",
                  flush=True)
    jobs = {f"other {stem}": (args.other / f"{stem}.cu", [])
            for stem in ("sorted_uniform", "resample", "theta_sampler")}
    if args.ablate:
        k5 = _edited(args.other / "sorted_uniform.cu", K5_EDITS, OUT / "ablate_k5")
        jobs.update({f"K5 {name}": (k5, flags) for name, flags in K5_ABLATIONS})
    libs = _build_all(jobs, OUT)
    k4_args, rays, draw, trainer = record_step(cs, dev)
    theta = theta_inputs(cs, dev)
    print(f"inputs: a production step's K4, {k4_args[0].shape[0]} rays x "
          f"{k4_args[0].shape[1]} + {k4_args[3]}, key {draw}; theta raster "
          f"{theta[2]}x{theta[3]}, {theta[0].shape[0]:,} rows", flush=True)
    if args.ablate:
        cfg = trainer.cfg
        cfg.sampling_method, cfg.theta_importance_lambda = "theta_importance", cs.THETA_LAMBDA
        trainer._install_sampler()
        ablate(cs, libs, k4_args, rays, draw, trainer, theta)
    del trainer
    torch.cuda.empty_cache()
    ok = compare(cs, libs, k4_args, rays, draw, theta)
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("draw_ab: a kernel disagrees with the other revision's (above)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    raise SystemExit(main())
