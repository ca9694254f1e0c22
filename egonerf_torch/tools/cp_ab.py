"""TensorCP's line product (K17) and its backward (K17b) of this checkout
against another revision's, on one CUDA card, on the inputs of one recorded
TensorCP training step at CP-384 (``presets.tensorcp_overrides``: 4096
rays x 256 samples, three lines of 500 rows of 96 + 288 channels), as
``chip_smoke.py``'s phase 2 records them.

    python -m egonerf_torch.tools.cp_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's
``cp_lookup.cu`` and ``lookup_common.cuh`` (its ``egonerf_torch/csrc``
from ``git archive``), whose ``cp_fwd`` and ``cp_bwd`` take the earlier
arguments: dims of ten and thirteen ints (``LEGACY_*``), no partial sums.

The step is recorded with K17 and K17b's plain versions, so the inputs do
not rest on either revision's kernels.  ``--ablate`` first times the other
revision's kernels as they are and ablated by text edits of its source
(``OTHER_EDITS``; the outputs are wrong, and the tool stops where an edit
does not apply): K17 (eval and training) with its row loads served from
shared memory; K17b walking one pass of 128 channels, without its REDs
and as an empty walk (its second pass kept); then this checkout's K17
without its appearance stores and K17b without its REDs and as an empty
walk (``THIS_EDITS``).

Then this checkout's K17 (eval, training, density-only) and K17b are held
to the other's: the appearance bit for bit, the density at rel 1e-5 of
max|other| (its sums go over slices), K17b per row within 1e-4 of the
float64-summed plain version's sum|terms| on the step and with every
sample on four points; a miss is printed and makes the exit code 1 after
the timings.  Each pair is timed by ``chip_smoke.time_ms`` in turns
(other, this, this, other) beside its byte bound; every wrapper-level
time includes the gradient copies' zeroing and the second passes.
Prints ptxas's registers and each plan's shared bytes, one line a
measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
from pathlib import Path

import torch

from .. import _build, ops, presets
from ..ops import cp
from .resample_ab import _build_all, _edit, _fn, _turns

OUT = _build.BUILD_ROOT.parent / "cp_ab"
LEGACY_FWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
LEGACY_BWD_ARGS = cp._BWD_ARGS
# the other revision's K17b copies: as many as fit 64 MB
LEGACY_WORK_BYTES = 64 << 20
# text edits of the other cp_lookup.cu: its rows read from a 16 KB shared
# array in place of L2 (SMEM_ROWS), one pass of group * 4 channels
# (ONE_PASS), no REDs (NO_RED: the sums kept alive by one test), an empty
# walk (EMPTY)
OTHER_EDITS = (
    ("namespace {\n\nconstexpr int kThreads = 256;",
     "namespace {\n\n#ifdef SMEM_ROWS\n__shared__ uint2 smem_rows2[2048];\n"
     "__shared__ float4 smem_rows4[1024];\n#endif\n\nconstexpr int kThreads = 256;"),
    ("    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0));\n",
     "#ifdef SMEM_ROWS\n    const uint2 v = smem_rows2[((size_t)(row + c0) >> 3) & 2047];\n#else\n"
     "    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0));\n#endif\n"),
    ("    const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));\n",
     "#ifdef SMEM_ROWS\n    const float4 v = smem_rows4[((size_t)(row + c0) >> 4) & 1023];\n#else\n"
     "    const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));\n#endif\n"),
    ("  if constexpr (kVec) {\n    atomicAdd(reinterpret_cast<float4*>(row + c0), "
     "make_float4(v[0], v[1], v[2], v[3]));\n",
     "#ifdef NO_RED\n  if (v[0] == -7.0f) row[c0] = v[1];\n  return;\n#endif\n"
     "  if constexpr (kVec) {\n    atomicAdd(reinterpret_cast<float4*>(row + c0), "
     "make_float4(v[0], v[1], v[2], v[3]));\n"),
    ("  constexpr int K = kVec ? kCh : 1;  // a lane's channels\n",
     "#ifdef EMPTY\n  return;\n#endif\n"
     "  constexpr int K = kVec ? kCh : 1;  // a lane's channels\n"),
    ("  for (int c0 = g * K; c0 < C; c0 += group * K) {\n    int row[6]",
     "#ifdef ONE_PASS\n  for (int c0 = g * K; c0 < C && c0 < group * K; c0 += group * K) {\n#else\n"
     "  for (int c0 = g * K; c0 < C; c0 += group * K) {\n#endif\n    int row[6]"))
OTHER_ABLATIONS = (("as it is", []), ("rows from shared memory", ["-DSMEM_ROWS"]),
                   ("one 128-channel pass", ["-DONE_PASS"]), ("no REDs", ["-DNO_RED"]),
                   ("empty walk", ["-DEMPTY"]))
# text edits of this cp_lookup.cu: K17 without its appearance stores
# (NO_STORE), K17b without its REDs (NO_RED) and as an empty walk (EMPTY)
THIS_EDITS = (
    ("            if (c >= CD && c < C) {\n              __stcs(",
     "#ifdef NO_STORE\n            if (prod[0] == -7.0f && c >= CD && c < C) {\n#else\n"
     "            if (c >= CD && c < C) {\n#endif\n              __stcs("),
    ("  if (row >= 0 && row < rows && c < C && v != 0.0f) atomicAdd(g + (size_t)row * C + c, v);\n",
     "#ifdef NO_RED\n  if (v == -7.0f) g[c] = v;\n#else\n"
     "  if (row >= 0 && row < rows && c < C && v != 0.0f) atomicAdd(g + (size_t)row * C + c, v);\n"
     "#endif\n"),
    ("  const int walkers = kBwdThreads >> lg;\n",
     "#ifdef EMPTY\n  return;\n#endif\n  const int walkers = kBwdThreads >> lg;\n"))
THIS_ABLATIONS = (("as it is", []), ("K17 no appearance stores", ["-DNO_STORE"]),
                  ("K17b no REDs", ["-DNO_RED"]), ("K17b empty walk", ["-DEMPTY"]))


def _edited(src: Path, edits, out: Path) -> Path:
    text = src.read_text()
    for old, new in edits:
        text = _edit(text, old, new)
    out.mkdir(parents=True, exist_ok=True)
    for h in src.parent.glob("*.cuh"):
        shutil.copy(h, out)
    (out / src.name).write_text(text)
    return out / src.name


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ptrs(ts):
    return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])


def _legacy_dims(lines, nd, modes, geometry=None):
    layout = cp.cp_layout(lines[0].new_zeros(0, 4), lines, nd)
    group = layout.group if geometry is None else geometry.group
    dims = [l.shape[1] for l in lines] + [int(m) for m in modes] + [
        lines[0].shape[-1], nd, group.bit_length() - 1, int(layout.vector)]
    if geometry is not None:
        dims += [geometry.run, geometry.blocks, geometry.copies]
    return (ctypes.c_int * len(dims))(*dims)


def other_fwd(f, coords, lines, nd, modes):
    """A run of the other K17 on these arguments, giving (density, app)."""
    n, c = coords.shape[0], lines[0].shape[-1]
    dens = torch.empty(n, device=coords.device)
    app = torch.empty(n, c - nd, device=coords.device)
    dims, ptrs = _legacy_dims(lines, nd, modes), _ptrs(lines)
    f32 = int(lines[0].dtype == torch.float32)

    def run():
        err = f(coords.data_ptr(), n, ptrs, dims, dens.data_ptr(),
                app.data_ptr() if c > nd else 0, f32, _stream())
        if err:
            raise RuntimeError(f"other cp_fwd: cudaError {err}")
        return dens, app
    return run


def other_bwd(f, coords, lines, d_dens, d_app, nd, modes):
    """A run of the other K17b (its copies zeroed first), giving the three
    gradients."""
    n, c = coords.shape[0], lines[0].shape[-1]
    rows = sum(l.shape[1] for l in lines)
    layout = cp.cp_layout(coords, lines, nd, d_app if c > nd else None)
    sms = torch.cuda.get_device_properties(coords.device).multi_processor_count
    geo = cp.bwd_geometry(n, c, rows, layout.vector, sms)
    geo = geo._replace(copies=max(1, min(geo.blocks, LEGACY_WORK_BYTES // (rows * c * 4),
                                         -(-n // cp.SAMPLES_PER_COPY))))
    work = torch.empty(geo.copies * rows * c, device=coords.device)
    out = torch.empty(rows, c, device=coords.device)
    dims, ptrs = _legacy_dims(lines, nd, modes, geo), _ptrs(lines)

    def run():
        work.zero_()
        err = f(coords.data_ptr(), n, ptrs, dims, d_dens.data_ptr(),
                d_app.data_ptr() if c > nd else 0, work.data_ptr(), out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"other cp_bwd: cudaError {err}")
        return out.split([l.shape[1] for l in lines])
    return run


def this_fwd(f, coords, lines, nd, modes):
    """A run of an edited build of this K17 (the wrapper's plan)."""
    n, c = coords.shape[0], lines[0].shape[-1]
    layout, plan = cp.launch_plan(coords, lines, nd)
    dens = torch.empty(n, device=coords.device)
    app = torch.empty(n, c - nd, device=coords.device)
    partial = torch.empty(plan.density_slices, n, device=coords.device)
    dims, ptrs = cp._dims(lines, nd, modes, layout, plan), _ptrs(lines)
    f32 = int(lines[0].dtype == torch.float32)

    def run():
        err = f(coords.data_ptr(), n, ptrs, dims, dens.data_ptr(), partial.data_ptr(),
                app.data_ptr() if c > nd else 0, f32, _stream())
        if err:
            raise RuntimeError(f"this cp_fwd: cudaError {err}")
    return run


def this_bwd(f, coords, lines, d_dens, d_app, nd, modes):
    """A run of an edited build of this K17b (copies zeroed first)."""
    c, rows = lines[0].shape[-1], sum(l.shape[1] for l in lines)
    layout, plan = cp.launch_plan(coords, lines, nd, d_app, backward=True)
    work = torch.empty(plan.copies * rows * c, device=coords.device)
    out = torch.empty(rows, c, device=coords.device)
    dims, ptrs = cp._dims(lines, nd, modes, layout, plan, backward=True), _ptrs(lines)

    def run():
        work.zero_()
        err = f(coords.data_ptr(), coords.shape[0], ptrs, dims, d_dens.data_ptr(),
                d_app.data_ptr(), work.data_ptr(), out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"this cp_bwd: cudaError {err}")
    return run


def record_step(cs, dev):
    """(coords, lines, n_density, line modes, d_dens, d_app) of one
    TensorCP training step at CP-384, K17 and K17b run by their plain
    versions."""
    trainer = cs.family_trainer(str(OUT.parent.parent), presets, presets.tensorcp_overrides,
                                "cp_ab")
    args = cs.record_cp_step(trainer, ops, plain=True)
    del trainer
    torch.cuda.empty_cache()
    return args


def fwd_bytes(coords, tabs, nd) -> int:
    """K17's bytes: coords and the lines read once, the density and the
    appearance written once."""
    n = coords.shape[0]
    return coords.numel() * 4 + sum(t.numel() * t.element_size() for t in tabs) + n * 4 * (
        1 + tabs[0].shape[-1] - nd)


def per_row_err(got, args) -> float:
    """K17b's worst |got - plain| / sum|terms| over rows and channels, the
    plain version's float32 terms summed in float64."""
    ref = cp.cp_bwd_plain(*args, accumulate=torch.float64)
    mag = cp.cp_bwd_plain(*args, magnitude=True, accumulate=torch.float64)
    return max(float(((g.reshape(r.shape).double() - r).abs() / (m + 1e-30)).max())
               for g, r, m in zip(got, ref, mag))


def ablate(cs, libs, args) -> None:
    coords, lines, nd, modes, d_dens, d_app = args
    bf = [l.to(torch.bfloat16) for l in lines]
    for form, tabs in (("eval", bf), ("train", lines)):
        _turns(cs, f"ablation other K17 ({form})", {
            name: other_fwd(_fn(libs[f"other {name}"], "cp_fwd", LEGACY_FWD_ARGS), coords, tabs,
                            nd, modes)
            for name in ("as it is", "rows from shared memory")})
    _turns(cs, "ablation other K17b", {
        name: other_bwd(_fn(libs[f"other {name}"], "cp_bwd", LEGACY_BWD_ARGS), coords, lines,
                        d_dens, d_app, nd, modes)
        for name in ("as it is", "one 128-channel pass", "no REDs", "empty walk")})
    for form, tabs in (("eval", bf), ("train", lines)):
        _turns(cs, f"ablation this K17 ({form})", {
            name: this_fwd(_fn(libs[f"this {name}"], "cp_fwd", cp._FWD_ARGS), coords, tabs, nd,
                           modes)
            for name in ("as it is", "K17 no appearance stores")})
    _turns(cs, "ablation this K17b", {
        name: this_bwd(_fn(libs[f"this {name}"], "cp_bwd", cp._BWD_ARGS), coords, lines, d_dens,
                       d_app, nd, modes)
        for name in ("as it is", "K17b no REDs", "K17b empty walk")})


def compare(cs, libs, args) -> bool:
    """This K17 and K17b against the other's, checked and timed in turns;
    returns whether every check held."""
    coords, lines, nd, modes, d_dens, d_app = args
    n = coords.shape[0]
    f_other = _fn(libs["other as it is"], "cp_fwd", LEGACY_FWD_ARGS)
    b_other = _fn(libs["other as it is"], "cp_bwd", LEGACY_BWD_ARGS)
    ok = True
    forms = (("eval", [l.to(torch.bfloat16) for l in lines]), ("train", lines),
             ("density", [l[..., :nd].contiguous() for l in lines]))
    for form, tabs in forms:
        other = other_fwd(f_other, coords, tabs, nd, modes)
        want_d, want_a = (t.clone() for t in other())
        got_d, got_a = ops.KERNELS.cp(coords, tabs, nd, modes)
        torch.cuda.synchronize()
        app_diff = int((got_a != want_a).sum())
        rel = float((got_d - want_d).abs().max()) / max(float(want_d.abs().max()), 1e-30)
        held = app_diff == 0 and rel <= cs.REL_TOL
        ok = ok and held
        t = _turns(cs, f"K17 ({form})", {"other": other,
                                         "this": lambda t=tabs: ops.KERNELS.cp(coords, t, nd,
                                                                               modes)})
        byte_ms = fwd_bytes(coords, tabs, nd) / cs.PEAK_BYTES_PER_S * 1e3
        _, plan = cp.launch_plan(coords, tabs, nd)
        print(f"K17 ({form}): {app_diff} appearance values differ from the other's bits, density "
              f"rel {rel:.2e} -> {'ok' if held else 'MISS'}; this {t['this']:.4f} ms (other "
              f"{t['other']:.4f}, {t['other'] / t['this']:.2f}x), {plan}; byte bound "
              f"{byte_ms:.4f} ms, this at {byte_ms / t['this']:.1%} of it", flush=True)
    few = coords[torch.arange(n, device=coords.device) % 4 * (n // 4)].contiguous()
    for label, c_in in (("step", coords), ("every sample on four points", few)):
        b_args = (c_in, lines, d_dens, d_app, nd, modes)
        other = other_bwd(b_other, *b_args)
        e_this = per_row_err(ops.KERNELS.cp_bwd(*b_args), b_args)
        e_other = per_row_err(other(), b_args)
        held = e_this <= cs.K2_TOL
        ok = ok and held
        t = _turns(cs, f"K17b ({label})", {"other": other,
                                           "this": lambda a=b_args: ops.KERNELS.cp_bwd(*a)})
        byte_ms = (cs.nbytes(c_in, *lines, d_dens, d_app) + sum(4 * l.numel() for l in lines)
                   ) / cs.PEAK_BYTES_PER_S * 1e3
        _, plan = cp.launch_plan(c_in, lines, nd, d_app, backward=True)
        print(f"K17b ({label}): per row {e_this:.2e} of sum|terms| (other {e_other:.2e}; limit "
              f"{cs.K2_TOL:.0e}) -> {'ok' if held else 'MISS'}; this {t['this']:.4f} ms (other "
              f"{t['other']:.4f}, {t['other'] / t['this']:.2f}x), {plan}; byte bound "
              f"{byte_ms:.4f} ms, this at {byte_ms / t['this']:.1%} of it", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other and of this K17 and K17b")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("cp_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for name, regs, spill in _build.ptxas_report("cp_lookup"):
        print(f"ptxas this cp_lookup: {regs} registers, {spill} bytes spilled: {name[:90]}",
              flush=True)
    jobs = {"other as it is": (args.other / "cp_lookup.cu", [])}
    if args.ablate:
        other = _edited(args.other / "cp_lookup.cu", OTHER_EDITS, OUT / "ablate_other")
        jobs.update({f"other {name}": (other, flags) for name, flags in OTHER_ABLATIONS})
        this = _edited(_build.CSRC / "cp_lookup.cu", THIS_EDITS, OUT / "ablate_this")
        jobs.update({f"this {name}": (this, flags) for name, flags in THIS_ABLATIONS})
    libs = _build_all(jobs, OUT)
    step = record_step(cs, dev)
    coords, lines = step[:2]
    print(f"step: {coords.shape[0]:,} samples, lines {[tuple(l.shape) for l in lines]}, "
          f"{step[2]} density channels, line modes {list(step[3])}", flush=True)
    if args.ablate:
        ablate(cs, libs, step)
    ok = compare(cs, libs, step)
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("cp_ab: a kernel missed its check against the other revision's (above)",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    raise SystemExit(main())
