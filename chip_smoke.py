#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure exits non-zero:

1. the card's name and power limit, and the build of every kernel in
   ``egonerf_torch/csrc`` from the checkout;
2. each kernel of the render path (K1, K3, K4, K6) against its plain
   PyTorch version on the card, on the inputs one 4096-ray chunk of the
   production model gives it, with times from CUDA events;
3. one 2000x1000 equirectangular view at full production width through
   ``Renderer.render_view``, with seeded random weights: finite rgb in
   [0, 1], finite depth, and each kernel launched once per chunk;
4. a few chunks rendered with the kernels and with the plain versions on
   the card, end to end;
5. where the time of those chunks goes on the device, from torch.profiler.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 2.
"""
from __future__ import annotations

import json
import os
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
SEED = 0
IMAGE_HW = (1000, 2000)
# ~0.1 s of device spin at H100 clocks: longer than the host needs to
# enqueue one timed run
SLEEP_CYCLES = 200_000_000
# device-side names of the kernels in csrc/
PORT_KERNELS = ("vm_lookup_kernel", "resample_kernel", "composite_kernel")


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


def profile_chunks(renderer, params, rays, n_chunks: int, top: int = 12) -> None:
    """Device time by kernel over ``n_chunks`` rendered chunks, and the share
    of the wall time the device was busy (under the profiler's overhead)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        renderer.render_rays(params, rays)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    if not rows:
        print("phase 5 profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    print(f"phase 5 profile over {n_chunks} chunks: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.1%}), {busy_ms / n_chunks:.3f} "
          f"ms/chunk on the device", flush=True)
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"phase 5   {ms / n_chunks:9.4f} ms/chunk {ms / busy_ms:6.1%} "
              f"x{count // n_chunks:<3d} {name[:90]}", flush=True)
    # the port's kernels inside the render, where the L2 holds what the
    # preceding kernels left (phase 2 runs each back to back)
    for name, ms, count in rows:
        if any(f"::{k}" in name for k in PORT_KERNELS):
            print(f"phase 5 in the render: {ms / count:.4f} ms/launch x{count} "
                  f"{name[:60]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from egonerf_torch import _build, ops, presets
    from egonerf_torch.data.ray_utils import get_ray_directions_360
    from egonerf_torch.models.egonerf import _dists
    from egonerf_torch.render.renderer import Renderer

    dev = torch.device("cuda")

    # -- phase 1: card + build ----------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    libs = _build.build_all()
    print(f"phase 1 build: {len(libs)} libraries ({', '.join(sorted(libs))}) "
          f"in {time.time() - t0:.1f} s", flush=True)

    model = presets.production_model(device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    cfg = model.cfg
    coords = model.coordinates
    print(f"model: grid {model.grid_size}, "
          f"{sum(p.numel() for p in params.values()):,} parameters", flush=True)

    dirs_np = get_ray_directions_360(*IMAGE_HW).reshape(-1, 3)
    n_view = dirs_np.shape[0]
    dirs = torch.as_tensor(dirs_np, device=dev)

    # -- phase 2: each kernel against its plain version ------------------------
    chunk = presets.EVAL_CHUNK
    n_c, n_f = presets.RENDER["n_coarse"], presets.RENDER["n_fine"]
    pick = torch.arange(chunk, device=dev) * (n_view // chunk)  # spread over the view
    viewdirs = dirs[pick]
    rays_o = torch.zeros_like(viewdirs)
    ray_dz = viewdirs[:, 2].contiguous()
    tables = model.lookup_tables(params)
    coarse_xyz, coarse_z = model.sample_ray_exp(rays_o, viewdirs, n_c)
    coarse_dists = _dists(coarse_z)
    c_norm = coords.normalize_coord(coords.from_cartesian(coarse_xyz),
                                    downsample=2).reshape(-1, 4).contiguous()
    c_feat = ops.PLAIN.density(c_norm, tables.coarse_planes, tables.coarse_lines)
    c_feat = c_feat.reshape(chunk, n_c)
    act = (cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
    z_vals, dists = ops.PLAIN.resample(c_feat, coarse_z, coarse_dists, n_f, None, True, *act)
    xyz = rays_o[:, None, :] + viewdirs[:, None, :] * z_vals[..., None]
    f_norm = coords.normalize_coord(coords.from_cartesian(xyz)).reshape(-1, 4).contiguous()
    hat = model._line_hat(tables, f_norm.shape[0])
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
            # depths: float32 sums in another order, ≤ 1e-5 of far
            ok = abs_err <= REL_TOL * model.near_far[1]
            tol = f"abs <= {REL_TOL * model.near_far[1]:.1e} (1e-5 x far)"
        else:
            ok = rel_err <= REL_TOL
            tol = f"rel <= {REL_TOL:.0e} of max|plain|"
        ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: plain(*args), reps=5)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"phase 2 {name}: max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
              f"({tol}) -> {'ok' if ok else 'MISS'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{n_bytes / 1e6:.1f} MB)", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version")
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0, "max_abs_err": abs_err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None})

    # K4's inputs off the eval path: sorted uniforms (the training draws)
    # and no merge with the coarse depths
    u = torch.sort(torch.rand(chunk, n_f, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED)))[0]
    for label, u_in, merge in (("sorted uniforms", u, True), ("no merge", None, False)):
        args = (c_feat, coarse_z, coarse_dists, n_f, u_in, merge, *act)
        abs_err, _ = max_err(ops.KERNELS.resample(*args), ops.PLAIN.resample(*args))
        ok = abs_err <= REL_TOL * model.near_far[1]
        print(f"phase 2 K4 resample, {label}: max abs err {abs_err:.3e} -> "
              f"{'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"K4 resample ({label}) disagrees with its plain version")
    del cases, app_feat, rgb, feat, f_norm, xyz

    # -- phase 3: one full view at production width ---------------------------
    renderer = Renderer(model, chunk=chunk, **presets.RENDER)
    renderer.set_directions(dirs_np)
    c2w = np.eye(4, dtype=np.float32)[:3]
    renderer.render_view(params, c2w)  # warm: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    wrappers = [ops.KERNELS.field, ops.KERNELS.density, ops.KERNELS.resample,
                ops.KERNELS.composite]
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = renderer.render_view(params, c2w)
    torch.cuda.synchronize()
    s_image = time.time() - t0
    launches = [w.launches for w in wrappers]
    n_chunks = -(-n_view // chunk)
    rgb_img, depth_img = out["rgb"], out["depth"]
    print(f"phase 3 render {IMAGE_HW[1]}x{IMAGE_HW[0]}: {s_image:.3f} s/image, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, launches "
          f"K1/K3/K4/K6 {launches} (expect {n_chunks} each)", flush=True)
    if tuple(rgb_img.shape) != (n_view, 3) or tuple(depth_img.shape) != (n_view,):
        fail(f"render shapes {tuple(rgb_img.shape)}, {tuple(depth_img.shape)}")
    if not (torch.isfinite(rgb_img).all() and torch.isfinite(depth_img).all()):
        fail("non-finite rgb or depth")
    if float(rgb_img.min()) < 0.0 or float(rgb_img.max()) > 1.0:
        fail("rgb outside [0, 1]")
    if launches != [n_chunks] * 4:
        fail(f"launch counts {launches}, expected {n_chunks} each")
    for entry, n in zip(table, launches):
        entry["launches"] = n
    print(f"phase 3 image: rgb mean {float(rgb_img.mean()):.6f}, depth range "
          f"[{float(depth_img.min()):.4f}, {float(depth_img.max()):.4f}]", flush=True)
    del out, rgb_img, depth_img

    # -- phase 4: end to end, kernels against plain versions -------------------
    n_e2e = 3 * chunk
    pick = torch.arange(n_e2e, device=dev) * (n_view // n_e2e)
    rays = torch.cat([torch.zeros_like(dirs[pick]), dirs[pick]], dim=-1)
    e2e = Renderer(model, chunk=chunk, **presets.RENDER)
    got = e2e.render_rays(params, rays)
    model.ops = ops.PLAIN
    try:
        want = e2e.render_rays(params, rays)
    finally:
        model.ops = ops.KERNELS
    d_rgb = float((got["rgb"] - want["rgb"]).abs().max())
    d_depth = float((got["depth"] - want["depth"]).abs().max())
    # K4's depths differ from the plain ones in the last float32 bits, which
    # moves the fine samples a little; rgb stays within 1e-5 and depth
    # within K4's own 1e-5 x far
    tol_rgb, tol_depth = REL_TOL, REL_TOL * model.near_far[1]
    print(f"phase 4 end to end over {n_e2e} rays: max |rgb - plain| {d_rgb:.3e} "
          f"(<= {tol_rgb:.1e}), max |depth - plain| {d_depth:.3e} (<= {tol_depth:.1e})",
          flush=True)
    if d_rgb > tol_rgb or d_depth > tol_depth:
        fail("end-to-end render disagrees with the plain versions")

    # -- phase 5: where the time goes, from torch.profiler ----------------------
    profile_chunks(e2e, params, rays, n_e2e // chunk)

    print(json.dumps({"kernels": table}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    with torch.no_grad():
        sys.exit(main())
