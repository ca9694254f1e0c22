#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure exits non-zero:

1. the card's name and power limit, and the build of every kernel in
   ``egonerf_torch/csrc`` from the checkout;
2. each kernel of the render path (K1, K3, K4, K6) against its plain
   PyTorch version on the card, on the inputs one 4096-ray chunk of the
   production model gives it, and each kernel of the training step (K2,
   K5, K6b) on the inputs of one production training step, with times
   from CUDA events;
3. one 2000x1000 equirectangular view at full production width through
   ``Renderer.render_view``, with seeded random weights: finite rgb in
   [0, 1], finite depth, and each render kernel launched once per chunk;
4. a few chunks rendered with the kernels and with the plain versions on
   the card, end to end;
5. where the time of those chunks goes on the device, from torch.profiler;
6. production training steps through ``Trainer.train_step`` (batch 4096,
   128 + 128 samples, N_voxel 27e6, MSE, Adam) on the synthetic scene:
   step ms, train rays/s, peak memory, every kernel launched once per
   step, and where the time goes from torch.profiler;
7. one production training step with the kernels and with the plain
   versions, same weights and draws: the loss and every gradient;
8. the smoke run of ``configs/smoke/synthetic.txt`` (300 iterations)
   through the command line ``python -m egonerf_torch``, its test PSNR
   against the JAX package's 14.92 dB, and ``--evaluation 1`` from the
   checkpoint it wrote.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 2.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the float32
# rate outside the tensor cores, which the kernels of this path use
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# kernel vs plain on identical inputs: float32 sums taken in another order
REL_TOL = 1e-5
# K2 against its plain version, per gradient cell: float32 atomics add in
# another order, so the error is held to the sum of the absolute terms
K2_TOL = 1e-4
# K5: the same Philox bits and float64 logs; only the float32 cumsum order
# differs, on values in (0, 1)
K5_TOL = 1e-6
# one training step, kernels vs plain: the loss to rel 1e-5; each gradient
# tensor in relative L2 norm, see phase 7
GRAD_TOL = 1e-3
SEED = 0
IMAGE_HW = (1000, 2000)
# ~0.1 s of device spin at H100 clocks: longer than the host needs to
# enqueue one timed run
SLEEP_CYCLES = 200_000_000
# device-side names of the kernels in csrc/
PORT_KERNELS = ("vm_lookup_kernel", "vm_field_bwd_kernel", "resample_kernel",
                "sorted_uniform_kernel", "composite_kernel", "composite_bwd_kernel")
TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 5, 20, 3
SMOKE_ITERS = 300
DEVICE = "cuda"
# the JAX package's smoke result and its seed band (NOTES.md:77, :139)
JAX_SMOKE_PSNR, SEED_BAND_DB = 14.92, 2.45
SMOKE_CONFIG = "configs/smoke/synthetic.txt"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn`` call, after one warm run: the mean of
    ``reps`` back-to-back calls queued behind a device-side sleep, so the
    host's launch work stays outside the two events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, n_ops: float):
    b = n_bytes / PEAK_BYTES_PER_S * 1e3
    o = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def max_err(outs, refs):
    """(max abs error, max abs error / max |ref|) over matching outputs."""
    abs_err = rel = 0.0
    for o, r in zip(outs, refs):
        e = float((o - r).abs().max())
        abs_err = max(abs_err, e)
        rel = max(rel, e / max(float(r.abs().max()), 1e-30))
    return abs_err, rel


def profile(run, n: int, label: str, unit: str, top: int = 12) -> None:
    """Device time by kernel over ``run()`` (``n`` units of work), and the
    share of the wall time the device was busy (under the profiler's
    overhead)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # a user annotation's device row (Adam's "Optimizer.step#Adam.step")
    # spans kernels that have rows of their own: it would count them twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(ms for _, ms, _ in rows)
    if not rows:
        print(f"{label} profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    print(f"{label} profile over {n} {unit}s: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.1%}), {busy_ms / n:.3f} "
          f"ms/{unit} on the device", flush=True)
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"{label}   {ms / n:9.4f} ms/{unit} {ms / busy_ms:6.1%} "
              f"x{count // n:<3d} {name[:90]}", flush=True)
    # the port's kernels inside the run, where the L2 holds what the
    # preceding kernels left (phase 2 runs each back to back)
    for name, ms, count in rows:
        if any(f"::{k}" in name or name.startswith(k) for k in PORT_KERNELS):
            print(f"{label} in the run: {ms / count:.4f} ms/launch x{count} "
                  f"{name[:60]}", flush=True)


def check_close(name: str, tol_desc: str, ok: bool, abs_err: float, rel_err: float):
    print(f"phase 2 {name}: max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
          f"({tol_desc}) -> {'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")


class Recorder:
    """A kernel wrapper that keeps the arguments of its last call."""

    def __init__(self, fn):
        self.fn, self.args = fn, None

    def __call__(self, *args):
        self.args = args
        return self.fn(*args)


def kernel_row(name, source, replaces, abs_err, ms, plain_ms, n_bytes, n_ops) -> dict:
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"phase 2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop)",
          flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def render_kernel_checks(model, params, dirs, ops, presets, dists_of) -> list:
    """Phase 2, render path: K1, K3, K4, K6 on one production chunk."""
    dev = dirs.device
    cfg, coords = model.cfg, model.coordinates
    n_view = dirs.shape[0]
    chunk = presets.EVAL_CHUNK
    n_c, n_f = presets.RENDER["n_coarse"], presets.RENDER["n_fine"]
    pick = torch.arange(chunk, device=dev) * (n_view // chunk)  # spread over the view
    viewdirs = dirs[pick]
    rays_o = torch.zeros_like(viewdirs)
    ray_dz = viewdirs[:, 2].contiguous()
    tables = model.lookup_tables(params)
    coarse_xyz, coarse_z = model.sample_ray_exp(rays_o, viewdirs, n_c)
    coarse_dists = dists_of(coarse_z)
    c_norm = coords.normalize_coord(coords.from_cartesian(coarse_xyz),
                                    downsample=2).reshape(-1, 4).contiguous()
    c_feat = ops.PLAIN.density(c_norm, tables.coarse_planes, tables.coarse_lines)
    c_feat = c_feat.reshape(chunk, n_c)
    act = (cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
    z_vals, dists = ops.PLAIN.resample(c_feat, coarse_z, coarse_dists, n_f, None, True, *act)
    xyz = rays_o[:, None, :] + viewdirs[:, None, :] * z_vals[..., None]
    f_norm = coords.normalize_coord(coords.from_cartesian(xyz)).reshape(-1, 4).contiguous()
    hat = model._line_hat(tables.fine_lines, f_norm.shape[0])
    feat, app_feat = model.compute_field(params, f_norm, tables)
    feat = feat.reshape(chunk, -1)
    rgb = model.shader.apply_params(params, "shader.", viewdirs[:, None, :].expand(
        chunk, z_vals.shape[1], 3), app_feat.reshape(chunk, z_vals.shape[1], -1))
    n_s = z_vals.shape[1]
    print(f"phase 2 inputs: {chunk} rays, {c_norm.shape[0]:,} coarse and "
          f"{f_norm.shape[0]:,} fine samples; line hat path {hat}", flush=True)

    cases = [
        ("K1 field_fwd", "egonerf_torch/csrc/vm_lookup.cu",
         "egonerf_tpu/ops/vm_lookup.py:467", ops.KERNELS.field, ops.PLAIN.field,
         (f_norm, tables.fine_planes, tables.fine_lines, cfg.density_n_comp, hat),
         nbytes(f_norm, *tables.fine_planes, *tables.fine_lines)
         + f_norm.shape[0] * (1 + sum(cfg.app_n_comp)) * 4,
         f_norm.shape[0] * sum(p.shape[-1] for p in tables.fine_planes) * 11),
        ("K3 density_fwd", "egonerf_torch/csrc/vm_lookup.cu",
         "egonerf_tpu/ops/vm_lookup.py:436", ops.KERNELS.density, ops.PLAIN.density,
         (c_norm, tables.coarse_planes, tables.coarse_lines),
         nbytes(c_norm, *tables.coarse_planes, *tables.coarse_lines) + c_norm.shape[0] * 4,
         c_norm.shape[0] * sum(p.shape[-1] for p in tables.coarse_planes) * 11),
        ("K4 resample", "egonerf_torch/csrc/resample.cu",
         "egonerf_tpu/ops/pdf.py:14", ops.KERNELS.resample, ops.PLAIN.resample,
         (c_feat, coarse_z, coarse_dists, n_f, None, True, *act),
         nbytes(c_feat, coarse_z, coarse_dists) + n_f * 4 + 2 * chunk * n_s * 4,
         chunk * (12 * n_c + n_f * (int(np.log2(n_c)) + 8) + 2 * n_s)),
        ("K6 composite", "egonerf_torch/csrc/composite.cu",
         "egonerf_tpu/ops/volrend.py:11", ops.KERNELS.composite, ops.PLAIN.composite,
         (feat, dists, z_vals, rgb, ray_dz, *act),
         nbytes(feat, dists, z_vals, rgb, ray_dz) + chunk * 6 * 4,
         chunk * n_s * 20),
    ]
    table = []
    for name, source, replaces, kern, plain, args, n_bytes, n_ops in cases:
        out = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(out, ref):
            if o.shape != r.shape:
                fail(f"{name}: shape {tuple(o.shape)} != plain {tuple(r.shape)}")
            if not torch.isfinite(o).all():
                fail(f"{name}: non-finite output")
        abs_err, rel_err = max_err(out, ref)
        if name.startswith("K4"):
            # depths: float32 sums in another order, <= 1e-5 of far
            ok = abs_err <= REL_TOL * model.near_far[1]
            tol = f"abs <= {REL_TOL * model.near_far[1]:.1e} (1e-5 x far)"
        else:
            ok = rel_err <= REL_TOL
            tol = f"rel <= {REL_TOL:.0e} of max|plain|"
        check_close(name, tol, ok, abs_err, rel_err)
        table.append(kernel_row(name, source, replaces, abs_err, time_ms(lambda: kern(*args)),
                                time_ms(lambda: plain(*args), reps=5), n_bytes, n_ops))

    # K4's inputs off the eval path: sorted uniforms (the training draws)
    # and no merge with the coarse depths
    u = ops.KERNELS.sorted_uniform(chunk, n_f, SEED, 0, dev)
    for label, u_in, merge in (("sorted uniforms", u, True), ("no merge", None, False)):
        args = (c_feat, coarse_z, coarse_dists, n_f, u_in, merge, *act)
        abs_err, _ = max_err(ops.KERNELS.resample(*args), ops.PLAIN.resample(*args))
        ok = abs_err <= REL_TOL * model.near_far[1]
        print(f"phase 2 K4 resample, {label}: max abs err {abs_err:.3e} -> "
              f"{'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"K4 resample ({label}) disagrees with its plain version")
    return table


def train_kernel_checks(trainer, ops) -> list:
    """Phase 2, training step: K2, K5, K6b on the inputs one production
    training step gives them (recorded from a real step)."""
    model = trainer.model
    cfg = model.cfg
    rec_f = Recorder(ops.KERNELS.field_bwd)
    rec_c = Recorder(ops.KERNELS.composite_bwd)
    model.ops = ops.KERNELS._replace(field_bwd=rec_f, composite_bwd=rec_c)
    trainer.train_step(0)
    model.ops = ops.KERNELS
    torch.cuda.synchronize()
    table = []

    # K2: per cell |kernel - plain| <= K2_TOL * sum|terms|
    coords, planes, lines, d_dens, d_app, n_density, line_hat = rec_f.args
    n = coords.shape[0]
    got = ops.KERNELS.field_bwd(*rec_f.args)
    ref = ops.PLAIN.field_bwd(*rec_f.args)
    mag = ops.PLAIN.field_bwd(*rec_f.args, magnitude=True)
    torch.cuda.synchronize()
    worst = abs_err = 0.0
    for g, r, m in zip(got[0] + got[1], ref[0] + ref[1], mag[0] + mag[1]):
        if not torch.isfinite(g).all():
            fail("K2 field_bwd: non-finite gradient")
        d = (g - r).abs()
        abs_err = max(abs_err, float(d.max()))
        worst = max(worst, float((d / (m + 1e-30)).max()))
    check_close("K2 field_bwd", f"per cell <= {K2_TOL:.0e} x sum|terms|",
                worst <= K2_TOL, abs_err, worst)
    del got, ref, mag
    n_ch = sum(p.shape[-1] for p in planes)
    table.append(kernel_row(
        "K2 field_bwd", "egonerf_torch/csrc/vm_lookup.cu", "egonerf_tpu/ops/vm_lookup.py:482",
        abs_err, time_ms(lambda: ops.KERNELS.field_bwd(*rec_f.args)),
        time_ms(lambda: ops.PLAIN.field_bwd(*rec_f.args), reps=5),
        nbytes(coords, *planes, *lines, d_dens, d_app)
        + sum(4 * t.numel() for t in planes + lines),
        # per sample and channel: plane (7) and line (3) recomputed, the
        # product, dp and dl, 4 + 2 weighted contributions
        n * n_ch * 19))

    # K5: the same bits; rel K5_TOL
    b, n_f = trainer.cfg.batch_size, trainer.cfg.n_fine
    u = ops.KERNELS.sorted_uniform(b, n_f, SEED, 1, coords.device)
    u_ref = ops.PLAIN.sorted_uniform(b, n_f, SEED, 1, coords.device)
    torch.cuda.synchronize()
    abs_err = float((u - u_ref).abs().max())
    sorted_ok = bool((u[:, 1:] >= u[:, :-1]).all() and (u > 0).all() and (u < 1).all())
    check_close("K5 sorted_uniform", f"abs <= {K5_TOL:.0e}, sorted in (0, 1)",
                abs_err <= K5_TOL and sorted_ok, abs_err, abs_err)
    table.append(kernel_row(
        "K5 sorted_uniform", "egonerf_torch/csrc/sorted_uniform.cu",
        "egonerf_tpu/ops/merge.py:25", abs_err,
        time_ms(lambda: ops.KERNELS.sorted_uniform(b, n_f, SEED, 1, coords.device)),
        time_ms(lambda: ops.PLAIN.sorted_uniform(b, n_f, SEED, 1, coords.device), reps=5),
        4 * b * n_f,
        # per draw: 10 Philox rounds (~12 integer operations each), the log
        # (~20), the cumsum and the division
        b * (n_f + 1) * 142))

    # K6b: rel REL_TOL of max|plain|
    feat, dists, rgb, g_rgb = rec_c.args[:4]
    got = ops.KERNELS.composite_bwd(*rec_c.args)
    ref = ops.PLAIN.composite_bwd(*rec_c.args)
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(got, ref)
    check_close("K6b composite_bwd", f"rel <= {REL_TOL:.0e} of max|plain|",
                rel_err <= REL_TOL, abs_err, rel_err)
    table.append(kernel_row(
        "K6b composite_bwd", "egonerf_torch/csrc/composite.cu",
        "egonerf_tpu/models/egonerf.py:466", abs_err,
        time_ms(lambda: ops.KERNELS.composite_bwd(*rec_c.args)),
        time_ms(lambda: ops.PLAIN.composite_bwd(*rec_c.args), reps=5),
        nbytes(feat, dists, rgb, g_rgb) + 4 * (feat.numel() + rgb.numel()),
        feat.numel() * 60))
    print(f"phase 2 training inputs: {trainer.cfg.batch_size} rays, {n:,} fine samples; "
          f"line hat path {list(line_hat)}; compute dtype {cfg.compute_dtype}", flush=True)
    return table


def render_phases(model, params, dirs_np, ops, presets, Renderer, wrappers) -> dict:
    """Phases 3-5 under no_grad; returns the launches of the render."""
    dev = model.device
    n_view = dirs_np.shape[0]
    chunk = presets.EVAL_CHUNK
    renderer = Renderer(model, chunk=chunk, **presets.RENDER)
    renderer.set_directions(dirs_np)
    c2w = np.eye(4, dtype=np.float32)[:3]
    renderer.render_view(params, c2w)  # warm: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = renderer.render_view(params, c2w)
    torch.cuda.synchronize()
    s_image = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    n_chunks = -(-n_view // chunk)
    rgb_img, depth_img = out["rgb"], out["depth"]
    print(f"phase 3 render {IMAGE_HW[1]}x{IMAGE_HW[0]}: {s_image:.3f} s/image, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, launches "
          f"{launches} (expect {n_chunks} each of K1/K3/K4/K6, 0 of the rest)", flush=True)
    if tuple(rgb_img.shape) != (n_view, 3) or tuple(depth_img.shape) != (n_view,):
        fail(f"render shapes {tuple(rgb_img.shape)}, {tuple(depth_img.shape)}")
    if not (torch.isfinite(rgb_img).all() and torch.isfinite(depth_img).all()):
        fail("non-finite rgb or depth")
    if float(rgb_img.min()) < 0.0 or float(rgb_img.max()) > 1.0:
        fail("rgb outside [0, 1]")
    want = {k: (n_chunks if k in ("K1", "K3", "K4", "K6") else 0) for k in wrappers}
    if launches != want:
        fail(f"render launch counts {launches}, expected {want}")
    print(f"phase 3 image: rgb mean {float(rgb_img.mean()):.6f}, depth range "
          f"[{float(depth_img.min()):.4f}, {float(depth_img.max()):.4f}]", flush=True)
    del out, rgb_img, depth_img

    # -- phase 4: end to end, kernels against plain versions
    dirs = torch.as_tensor(dirs_np, device=dev)
    n_e2e = 3 * chunk
    pick = torch.arange(n_e2e, device=dev) * (n_view // n_e2e)
    rays = torch.cat([torch.zeros_like(dirs[pick]), dirs[pick]], dim=-1)
    e2e = Renderer(model, chunk=chunk, **presets.RENDER)
    got = e2e.render_rays(params, rays)
    model.ops = ops.PLAIN
    try:
        want_out = e2e.render_rays(params, rays)
    finally:
        model.ops = ops.KERNELS
    d_rgb = float((got["rgb"] - want_out["rgb"]).abs().max())
    d_depth = float((got["depth"] - want_out["depth"]).abs().max())
    # K4's depths differ from the plain ones in the last float32 bits, which
    # moves the fine samples a little; rgb stays within 1e-5 and depth
    # within K4's own 1e-5 x far
    tol_rgb, tol_depth = REL_TOL, REL_TOL * model.near_far[1]
    print(f"phase 4 end to end over {n_e2e} rays: max |rgb - plain| {d_rgb:.3e} "
          f"(<= {tol_rgb:.1e}), max |depth - plain| {d_depth:.3e} (<= {tol_depth:.1e})",
          flush=True)
    if d_rgb > tol_rgb or d_depth > tol_depth:
        fail("end-to-end render disagrees with the plain versions")

    # -- phase 5: where the time goes, from torch.profiler
    profile(lambda: e2e.render_rays(params, rays), n_e2e // chunk, "phase 5", "chunk")
    return launches


def train_phases(trainer, ops, wrappers) -> dict:
    """Phases 6 and 7; returns the launches of the timed steps."""
    cfg = trainer.cfg
    it = 1
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(it)
        it += 1
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    t0 = time.time()
    for start, end in events:
        start.record()
        mse = trainer.train_step(it)
        end.record()
        it += 1
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    median = step_ms[len(step_ms) // 2]
    mse_v = float(mse)
    print(f"phase 6 training step, batch {cfg.batch_size}, {cfg.n_coarse} + {cfg.n_fine} "
          f"samples, grid {trainer.model.grid_size}: median {median:.3f} ms/step (CUDA "
          f"events; min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}), {cfg.batch_size / median * 1e3:,.0f} "
          f"train rays/s; {wall / TRAIN_STEPS * 1e3:.3f} ms/step by the host clock; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; last mse "
          f"{mse_v:.6f}", flush=True)
    print(f"phase 6 launches over {TRAIN_STEPS} steps: {launches} (expect {TRAIN_STEPS} "
          f"each)", flush=True)
    if launches != {k: TRAIN_STEPS for k in wrappers}:
        fail(f"training launch counts {launches}, expected {TRAIN_STEPS} each")
    if not np.isfinite(mse_v):
        fail("non-finite training loss")

    def steps():
        nonlocal it
        for _ in range(PROFILE_STEPS):
            trainer.train_step(it)
            it += 1
    profile(steps, PROFILE_STEPS, "phase 6", "step", top=16)

    # -- phase 7: one step with the kernels and with the plain versions
    model, params = trainer.model, trainer.params
    dev = trainer.device
    row = trainer.sampler.next_batch()
    jitter = torch.rand(cfg.batch_size, cfg.n_coarse, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 7))
    u = ops.KERNELS.sorted_uniform(cfg.batch_size, cfg.n_fine, SEED, 10 ** 6, dev)

    def loss_and_grads(o):
        model.ops = o
        try:
            for p in params.values():
                p.grad = None
            out = model.forward(params, row[:, :6], is_train=True, n_coarse=cfg.n_coarse,
                                n_fine=cfg.n_fine, jitter=jitter, u=u)
            loss = torch.mean((out["rgb"] - row[:, 6:9]) ** 2)
            loss.backward()
            return loss.item(), {k: p.grad.detach().clone() for k, p in params.items()}
        finally:
            model.ops = ops.KERNELS

    loss_k, grads_k = loss_and_grads(ops.KERNELS)
    loss_p, grads_p = loss_and_grads(ops.PLAIN)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"phase 7 training step, kernels vs plain: loss {loss_k:.8f} vs {loss_p:.8f} "
          f"(rel {rel_loss:.2e} <= {REL_TOL:.0e})", flush=True)
    worst = 0.0
    for k in sorted(grads_p):
        g, r = grads_k[k], grads_p[k]
        if not torch.isfinite(g).all():
            fail(f"non-finite gradient {k}")
        l2 = float((g - r).norm() / r.norm().clamp_min(1e-30))
        mx = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
        worst = max(worst, l2)
        print(f"phase 7   {k:22s} |g - plain| / |plain| {l2:.2e} (<= {GRAD_TOL:.0e}), "
              f"max |g - plain| / max |plain| {mx:.2e}", flush=True)
    for p in params.values():
        p.grad = None
    if rel_loss > REL_TOL or worst > GRAD_TOL:
        fail("the training step with the kernels disagrees with the plain versions")
    return launches


def quality_phase(root: str) -> None:
    """Phase 8: the smoke run through the command line."""
    from egonerf_torch.__main__ import main as cli_main

    base = os.path.join(root, "build", "chip_smoke_runs")
    shutil.rmtree(base, ignore_errors=True)  # the trainer resumes from what it finds
    argv = ["--config", os.path.join(root, SMOKE_CONFIG), "--n_iters", str(SMOKE_ITERS),
            "--vis_list", f"[{SMOKE_ITERS}]", "--N_vis", "-1", "--basedir", base]
    t0 = time.time()
    cli_main(argv)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    logdir = os.path.join(base, "smoke")
    test_psnr = float(np.loadtxt(os.path.join(logdir, "imgs_vis", f"{SMOKE_ITERS - 1:06d}_mean.txt"))[0])
    from egonerf_torch.render.renderer import Renderer, evaluation
    from egonerf_torch.train.checkpoint import latest_checkpoint
    from egonerf_torch.train.config import parse_cli
    from egonerf_torch.train.trainer import _load_model
    from egonerf_torch.data.datasets import SyntheticEgoDataset

    cfg = parse_cli(argv)
    train_views = SyntheticEgoDataset(split="train", is_stack=True, near_far=cfg.near_far)
    model, header = _load_model(cfg, latest_checkpoint(logdir), train_views.scene_bbox,
                                train_views.near_far, DEVICE)
    train_psnr = float(np.mean(evaluation(train_views, model, model.params(),
                                          Renderer.from_config(model, cfg, False))))
    print(f"phase 8 smoke run ({SMOKE_CONFIG}, {SMOKE_ITERS} iterations, {train_s:.1f} s with its "
          f"evaluation): test PSNR {test_psnr:.2f} dB, train-view PSNR {train_psnr:.2f} dB; "
          f"the JAX package {JAX_SMOKE_PSNR:.2f} dB (NOTES.md:77), floor "
          f"{JAX_SMOKE_PSNR - SEED_BAND_DB:.2f} dB (its seed band)", flush=True)
    if not test_psnr >= JAX_SMOKE_PSNR - SEED_BAND_DB:
        fail(f"smoke test PSNR {test_psnr:.2f} dB below {JAX_SMOKE_PSNR - SEED_BAND_DB:.2f}")
    # the checkpoint it wrote, reloaded through --evaluation 1
    cli_main(argv + ["--evaluation", "1"])
    reloaded = float(np.loadtxt(os.path.join(logdir, "evaluation", "mean.txt"))[0])
    print(f"phase 8 --evaluation 1 from {os.path.basename(latest_checkpoint(logdir))} "
          f"(global_step {header['global_step']}): test PSNR {reloaded:.4f} dB", flush=True)
    if abs(reloaded - test_psnr) > 1e-3:
        fail(f"reloaded checkpoint renders {reloaded:.4f} dB, training ended at "
             f"{test_psnr:.4f} dB")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from egonerf_torch import _build, ops, presets
    from egonerf_torch.data.ray_utils import get_ray_directions_360
    from egonerf_torch.models.egonerf import _dists
    from egonerf_torch.ops import merge, pdf, vm_lookup, volrend
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    dev = torch.device(DEVICE)
    wrappers = {"K1": vm_lookup.field_fwd, "K2": vm_lookup.field_bwd,
                "K3": vm_lookup.density_fwd, "K4": pdf.resample, "K5": merge.sorted_uniform,
                "K6": volrend.composite, "K6b": volrend.composite_bwd}

    # -- phase 1: card + build ----------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    libs = _build.build_all()
    print(f"phase 1 build: {len(libs)} libraries ({', '.join(sorted(libs))}) "
          f"in {time.time() - t0:.1f} s", flush=True)

    model = presets.production_model(device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    print(f"model: grid {model.grid_size}, "
          f"{sum(p.numel() for p in params.values()):,} parameters", flush=True)
    dirs_np = get_ray_directions_360(*IMAGE_HW).reshape(-1, 3)
    trainer = Trainer(load_config(overrides=presets.production_overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname="production",
        n_iters=10 ** 9, N_vis=0, progress_refresh_rate=10 ** 9)), device=dev)
    print(f"trainer: synthetic scene, {trainer.sampler.buffer.shape[0]:,} training rays "
          f"resident, grid {trainer.model.grid_size}", flush=True)

    # -- phase 2: each kernel against its plain version ------------------------
    with torch.no_grad():
        table = render_kernel_checks(model, params, torch.as_tensor(dirs_np, device=dev), ops,
                                     presets, _dists)
    table += train_kernel_checks(trainer, ops)
    rows = dict(zip(("K1", "K3", "K4", "K6", "K2", "K5", "K6b"), table))

    # -- phases 3-5: the render -------------------------------------------------
    with torch.no_grad():
        render_launches = render_phases(model, params, dirs_np, ops, presets, Renderer,
                                        wrappers)
    del model, params
    # -- phases 6-7: the training step ------------------------------------------
    train_launches = train_phases(trainer, ops, wrappers)
    for k, row in rows.items():
        # the render path's kernels report their launches per image, the
        # training kernels theirs over the timed steps
        row["launches"] = render_launches[k] if render_launches[k] else train_launches[k]
    del trainer
    torch.cuda.empty_cache()

    # -- phase 8: the smoke run through the command line ------------------------
    quality_phase(root)

    print(json.dumps({"kernels": [rows[k] for k in ("K1", "K2", "K3", "K4", "K5", "K6",
                                                     "K6b")]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
