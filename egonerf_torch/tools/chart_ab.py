"""K7s (generic_sphere's chart, with the samplers' in-box mask) of this
checkout against another revision's, on one CUDA card: the kernels on
``chip_smoke.py``'s phase-29 inputs, K7 and K4 with its chart on phase 2's,
and the generic_sphere view and training step of both checkouts.

    python -m egonerf_torch.tools.chart_ab --other DIR [--ablate]

run from the repository root.  DIR is the other revision's checkout (from
``git archive``) whose K7s is its first form, K7 with the yin test forced
true (``chart_kernel<true>``, coords only; the samplers formed the points
and ``_in_box`` in torch).

The kernels, each pair timed by ``chip_smoke.time_ms`` in turns (a, b,
..., b, a): on phase 29's chunk (4096 rays x 256 exponential depths of
TensorVMSplit at 256^3 on generic_sphere) and on a recorded training step,
this K7s with and without the mask, the other K7s, and the other K7s with
torch's points and ``_in_box`` after it (what the other revision's path
launched); this K7s's radial column must equal the other's bit for bit,
its angles lie within K7_TOL of the other's, its mask equal ``_in_box``'s,
and both radial columns the plain version's on the grid's entries and an
ulp either side.  On phase 2's chunk and recorded
production step, K7's coarse chart and K4 with its chart epilogue of both
checkouts.  ``--ablate`` first times the other K7s as it is, in radial
mode 2 (no search, no grid lerp), without its binary search (a fixed cell)
and without its store; and this K7s without its stores, without its
angles, with the library's acosf and atan2f, with nothing but its loads and
stores, with its radial walk as a loop, and at 2 and 4 samples a lane (text
edits of the sources; the outputs are wrong, and the tool stops where an
edit does not apply).

Then each checkout's generic_sphere view (2000x1000, s/image), training
step (median of 20, CUDA events) and device operations of one chunk and one
step (``torch.profiler``), each in a process of its own in that checkout,
in turns (other, this, this, other): this file is copied into the other
checkout's tools and run there with ``--measure``.  Prints one line a
measurement, ptxas's registers of both builds and the card's name and
power limit; a miss is printed and makes the exit code 1.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _build, ops, presets
from ..ops import chart as chart_ops
from ..ops import pdf
from .resample_ab import _build_all, _edit, _fn, _turns

OUT = _build.BUILD_ROOT.parent / "chart_ab"
REPO = Path(__file__).resolve().parents[2]
# the other chart.cuh without its binary search (a fixed cell)
OTHER_CUH_EDITS = ((
    "    while (lo_i < hi_i) {\n      const int mid = (lo_i + hi_i) >> 1;\n"
    "      if (grid[mid] <= r) lo_i = mid + 1; else hi_i = mid;\n    }\n",
    "#ifdef NO_SEARCH\n    lo_i = hi_i >> 1;\n#else\n"
    "    while (lo_i < hi_i) {\n      const int mid = (lo_i + hi_i) >> 1;\n"
    "      if (grid[mid] <= r) lo_i = mid + 1; else hi_i = mid;\n    }\n#endif\n"),)
# the other chart.cu without its store (the value kept alive by one test)
_OTHER_STORE = ("      po[s] = chart_point<kSphere>(cr.ox, cr.oy, cr.oz, cr.dx, cr.dy, cr.dz, "
                "zr[s], a, grid);\n")
OTHER_CU_EDITS = ((
    _OTHER_STORE,
    "#ifdef NO_STORE\n      { const float4 c = chart_point<kSphere>(cr.ox, cr.oy, cr.oz, cr.dx, "
    "cr.dy, cr.dz, zr[s], a, grid); if (c.x == -7.0f) po[s] = c; }\n#else\n" + _OTHER_STORE
    + "#endif\n"),)
# this chart.cu: K7s without its stores (NO_STORE), without its angles
# (NO_ANGLES), with the library's acosf and atan2f (LIB_ANGLES), with
# nothing but its loads and stores (NO_MATH), walking its radial cell in a
# loop (LOOP_WALK), at SAMPLES samples a lane
_THIS_ANGLES = ("      c.y = chart_to_unit(__fmul_rn(__fsub_rn(sphere_acos(chart_q(dz, r)), "
                "a.near_t), a.inv_t));\n"
                "      c.z = chart_to_unit(__fmul_rn(__fsub_rn(sphere_atan2(dy, dx), a.near_p), "
                "a.inv_p));\n")
_THIS_WALK = "              : walk <= 1 ? chart_sphere_kernel<1> : chart_sphere_kernel<0>;\n"
THIS_CU_EDITS = (
    ("constexpr int kSphereSamples = 8;",
     "#ifndef SAMPLES\n#define SAMPLES 8\n#endif\nconstexpr int kSphereSamples = SAMPLES;"),
    (_THIS_ANGLES,
     "#if defined(NO_ANGLES)\n      c.y = dz; c.z = dy;\n#elif defined(LIB_ANGLES)\n"
     + _THIS_ANGLES.replace("sphere_acos(", "acosf(").replace("sphere_atan2(", "atan2f(")
     + "#else\n" + _THIS_ANGLES + "#endif\n"),
    ("      c.w = 0.0f;\n",
     "      c.w = 0.0f;\n#ifdef NO_MATH\n      c = make_float4(px, py, pz, 0.0f);\n#endif\n"),
    ("      out[row + s] = c;\n      if (mask != nullptr)\n",
     "#ifdef NO_STORE\n      if (c.x == -7.0f) out[row + s] = c;\n"
     "      if (mask != nullptr && px == -7.0f)\n"
     "#else\n      out[row + s] = c;\n      if (mask != nullptr)\n#endif\n"),
    (_THIS_WALK,
     "#ifdef LOOP_WALK\n              : chart_sphere_kernel<0>;\n#else\n" + _THIS_WALK
     + "#endif\n"))
OTHER_ABLATIONS = (("as it is", []), ("no search", ["-DNO_SEARCH"]),
                   ("no store", ["-DNO_STORE"]))
THIS_ABLATIONS = (("as it is", []), ("no stores", ["-DNO_STORE"]),
                  ("no angles", ["-DNO_ANGLES"]), ("the library's acosf, atan2f", ["-DLIB_ANGLES"]),
                  ("loads and stores alone", ["-DNO_MATH"]), ("a walk loop", ["-DLOOP_WALK"]),
                  ("2 samples a lane", ["-DSAMPLES=2"]), ("4 samples a lane", ["-DSAMPLES=4"]))
# K4's eval form with the chart epilogue (its arguments did not change)
K4_CHART_ARGS = pdf._CHART_ARGS


def _edited(csrc: Path, edits: dict, out: Path) -> Path:
    """A copy of ``csrc`` in ``out`` with ``edits`` ({file name: edits})
    applied; returns the copy's chart.cu."""
    out.mkdir(parents=True, exist_ok=True)
    for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        shutil.copy(f, out)
    for name, pairs in edits.items():
        text = (out / name).read_text()
        for old, new in pairs:
            text = _edit(text, old, new)
        (out / name).write_text(text)
    return out / "chart.cu"


def _stream():
    return torch.cuda.current_stream().cuda_stream


def other_sphere(f, rays_o, viewdirs, z, coords, mode=None):
    """A run of the other K7s (coords only): the argument list K7 takes."""
    r, s = z.shape
    out = torch.empty(r * s, 4, device=z.device)
    args = chart_ops.chart_args(coords, None, z.device)
    if mode is not None:
        args[8] = mode

    def run():
        err = f(rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                z.data_ptr(), z.stride(0), r, s, *args, out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"other chart_sphere_fwd: cudaError {err}")
        return out
    return run


def this_sphere(f, rays_o, viewdirs, z, coords, box):
    """A run of an edited build of this K7s with the mask."""
    r, s = z.shape
    out = torch.empty(r * s, 4, device=z.device)
    mask = torch.empty(r * s, dtype=torch.bool, device=z.device)
    args = chart_ops.chart_args(coords, None, z.device)
    start, inv_w, walk = chart_ops._bucket_table(coords, z.device)

    def run():
        err = f(rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                z.data_ptr(), z.stride(0), r, s, *args, start.data_ptr(), start.shape[0], inv_w,
                walk, box.data_ptr(), out.data_ptr(), mask.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"this chart_sphere_fwd: cudaError {err}")
        return out, mask
    return run


def other_chart(f, rays_o, viewdirs, z, coords, downsample):
    """A run of the other K7 (the yin-yang chart)."""
    r, s = z.shape
    out = torch.empty(r * s, 4, device=z.device)
    args = chart_ops.chart_args(coords, downsample, z.device)

    def run():
        err = f(rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                z.data_ptr(), z.stride(0), r, s, *args, out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"other chart_fwd: cudaError {err}")
        return out
    return run


def k4_chart(f, feat, z, d, n_f, merge, act, rays_o, viewdirs, coords):
    """A run of a K4 with its chart epilogue, eval form (u the linspace)."""
    r, s = feat.shape
    n_out = s + n_f if merge else n_f
    zo, do = (torch.empty(r, n_out, device=feat.device) for _ in range(2))
    norm = torch.empty(r * n_out, 4, device=feat.device)
    chart = chart_ops.chart_args(coords, None, feat.device)

    def run():
        err = f(feat.data_ptr(), z.data_ptr(), d.data_ptr(), None, n_f,
                chart_ops._recip(n_f - 1), r, s, n_f, int(merge), act[0], act[1],
                pdf.ACTIVATIONS.index(act[2]), zo.data_ptr(), do.data_ptr(), rays_o.data_ptr(),
                rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0), *chart,
                norm.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"resample_chart_fwd: cudaError {err}")
        return zo, norm
    return run


def sphere_inputs(cs, dev):
    """(trainer, [(label, rays_o, viewdirs, z)]): phase 29's trainer, its
    chunk (4096 view rays from the origin, exponential depths) and the K7s
    arguments of one recorded training step."""
    from ..data.ray_utils import get_ray_directions_360

    trainer = cs.chart_trainer(str(REPO), presets, "chart_ab")
    model = trainer.model
    chunk, n = presets.EVAL_CHUNK, trainer.cfg.n_coarse
    dirs = torch.as_tensor(get_ray_directions_360(*cs.IMAGE_HW).reshape(-1, 3), device=dev)
    viewdirs = dirs[torch.arange(chunk, device=dev) * (dirs.shape[0] // chunk)]
    rays_o = torch.zeros_like(viewdirs)
    rec = cs.Recorder(ops.KERNELS.chart_sphere)
    model.ops = ops.KERNELS._replace(chart_sphere=rec)
    trainer.train_step(0)
    model.ops = ops.KERNELS
    torch.cuda.synchronize()
    with torch.no_grad():
        z = model.sample_ray_exp(rays_o, viewdirs, n)[1]
    return trainer, [("chunk", rays_o, viewdirs, z), ("step", *rec.args[:3])]


def radial_bits(got, ref) -> int:
    return int((got[:, 0] != ref[:, 0]).sum())


def sphere_compare(cs, libs, trainer, cases) -> bool:
    """This K7s against the other's, checked and timed in turns; returns
    whether every check held."""
    model = trainer.model
    coords, dev = model.coordinates, cases[0][1].device
    box = model._box(dev)
    other_f = _fn(libs["other as it is"], "chart_sphere_fwd", chart_ops._ARGS)
    ok = True
    edge = cs.sphere_edge_radii(coords, dev)
    with torch.no_grad():
        ref = ops.PLAIN.chart_sphere(*edge)
        bits = {"other": radial_bits(other_sphere(other_f, *edge)(), ref),
                "this": radial_bits(ops.KERNELS.chart_sphere(*edge), ref)}
    torch.cuda.synchronize()
    print(f"radial column on {edge[2].numel()} edge radii (the grid's entries, an ulp either "
          f"side, 0, past the last): other K7s differs from plain on {bits['other']}, this "
          f"K7s on {bits['this']}", flush=True)
    ok = ok and bits["this"] <= bits["other"]
    table = chart_ops.radial_buckets(coords.ref_grid)
    for label, ro, rd, z in cases:
        with torch.no_grad():
            want = other_sphere(other_f, ro, rd, z, coords)().clone()
            got, mask = ops.KERNELS.chart_sphere(ro, rd, z, coords, box)
            in_box = model._in_box(ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1)
        torch.cuda.synchronize()
        same_r = torch.equal(got[:, [0, 3]], want[:, [0, 3]])
        angle = float((got[:, 1:3] - want[:, 1:3]).abs().max())
        m_bits = int((mask != in_box).sum())
        held = same_r and angle <= cs.K7_TOL and m_bits == 0
        ok = ok and held
        print(f"K7s {label}: {z.numel():,} samples; radial column and flags equal to the other "
              f"K7s's bit for bit: {same_r}; angles within {angle:.2e} of its (limit "
              f"{cs.K7_TOL:.0e}); mask differs from _in_box on {m_bits} -> "
              f"{'ok' if held else 'MISS'}", flush=True)

        def other_path(ro=ro, rd=rd, z=z, run=other_sphere(other_f, ro, rd, z, coords)):
            run()
            model._in_box(ro[:, None, :] + rd[:, None, :] * z[..., None])
        with torch.no_grad():
            t = _turns(cs, f"K7s {label}", {
                "other": other_sphere(other_f, ro, rd, z, coords),
                "this, mask": lambda: ops.KERNELS.chart_sphere(ro, rd, z, coords, box),
                "this, coords only": lambda: ops.KERNELS.chart_sphere(ro, rd, z, coords),
                "other + torch points and _in_box": other_path})
        n_bytes, _ = cs.chart_cost(ro, z, coords.ref_grid.shape[0])
        byte_ms = (n_bytes + z.numel() + 4 * len(table.start)) / cs.PEAK_BYTES_PER_S * 1e3
        print(f"K7s {label}: this {t['this, mask']:.4f} ms with the mask (other "
              f"{t['other']:.4f}, {t['other'] / t['this, mask']:.2f}x); the other path with "
              f"torch's points and _in_box {t['other + torch points and _in_box']:.4f}; byte "
              f"bound {byte_ms:.4f} ms, this at {byte_ms / t['this, mask']:.1%} of it, half "
              f"the bound {2 * byte_ms:.4f}", flush=True)
    return ok


def sphere_ablate(cs, libs, trainer, cases) -> None:
    model = trainer.model
    coords = model.coordinates
    label, ro, rd, z = cases[0]
    box = model._box(ro.device)
    runs = {f"other {name}": other_sphere(_fn(libs[f"other {name}"], "chart_sphere_fwd",
                                              chart_ops._ARGS), ro, rd, z, coords)
            for name, _ in OTHER_ABLATIONS}
    runs["other, radial mode 2"] = other_sphere(_fn(libs["other as it is"], "chart_sphere_fwd",
                                                    chart_ops._ARGS), ro, rd, z, coords, mode=2)
    runs.update({f"this {name}": this_sphere(_fn(libs[f"this {name}"], "chart_sphere_fwd",
                                                 chart_ops._SPHERE_ARGS), ro, rd, z, coords, box)
                 for name, _ in THIS_ABLATIONS})
    with torch.no_grad():
        _turns(cs, f"ablation K7s {label}", runs)


def k7_k4_compare(cs, libs) -> None:
    """K7's coarse chart and K4 with its chart, both checkouts', on phase
    2's chunk and recorded production step, in turns."""
    from .resample_ab import _inputs

    other_k7 = _fn(libs["other as it is"], "chart_fwd", chart_ops._ARGS)
    other_k4 = _fn(libs["other k4"], "resample_chart_fwd", K4_CHART_ARGS)
    this_k4 = _fn(ctypes.CDLL(str(_build.build_all()["resample"])), "resample_chart_fwd",
                  K4_CHART_ARGS)
    dev = torch.device("cuda")
    for label, (feat, z, d, n_f, _, merge, *act), (ro, rd, coords) in _inputs(cs, dev):
        with torch.no_grad():
            a = k4_chart(other_k4, feat, z, d, n_f, merge, act, ro, rd, coords)
            b = k4_chart(this_k4, feat, z, d, n_f, merge, act, ro, rd, coords)
            (za, na), (zb, nb) = (t.clone() for t in a()), b()
            ca = other_chart(other_k7, ro, rd, z, coords, 2)().clone()
            cb = ops.KERNELS.chart(ro, rd, z, coords, 2)
        torch.cuda.synchronize()
        print(f"K4 + chart {label}: depths and coords equal to the other's bit for bit: "
              f"{torch.equal(za, zb) and torch.equal(na, nb)}; K7 coarse equal: "
              f"{torch.equal(ca, cb)}", flush=True)
        _turns(cs, f"K4 + chart {label}", {"other": a, "this": b})
        _turns(cs, f"K7 coarse {label}", {
            "other": other_chart(other_k7, ro, rd, z, coords, 2),
            "this": lambda: ops.KERNELS.chart(ro, rd, z, coords, 2)})


def measure() -> dict:
    """This checkout's generic_sphere view, step and device operations
    (run with ``--measure`` from a checkout's root; the other checkout runs
    this same function on its own package)."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from ..data.ray_utils import get_ray_directions_360
    from ..render.renderer import Renderer

    dev = torch.device("cuda")
    trainer = cs.chart_trainer(os.getcwd(), presets, "chart_ab_e2e")
    model, cfg = trainer.model, trainer.cfg
    renderer = Renderer.from_config(model, cfg, trainer.white_bg)
    dirs = get_ray_directions_360(*cs.IMAGE_HW).reshape(-1, 3)
    renderer.set_directions(dirs)
    c2w = np.eye(4, dtype=np.float32)[:3]
    t = torch.as_tensor(dirs, device=dev)
    pick = torch.arange(renderer.chunk, device=dev) * (t.shape[0] // renderer.chunk)
    chunk_rays = torch.cat([torch.zeros_like(t[pick]), t[pick]], -1)
    out = {}
    with torch.no_grad():
        renderer.render_view(trainer.params, c2w)
        views = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            renderer.render_view(trainer.params, c2w)
            t1.record()
            torch.cuda.synchronize()
            views.append(t0.elapsed_time(t1) / 1e3)
    out["view_s"] = views
    for i in range(5):
        trainer.train_step(i)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(20)]
    for i, (a, b) in enumerate(events):
        a.record()
        trainer.train_step(10 + i)
        b.record()
    torch.cuda.synchronize()
    steps = sorted(a.elapsed_time(b) for a, b in events)
    out["step_ms"] = steps[len(steps) // 2]
    from ..ops import chart

    for name, run in (("chunk", lambda: renderer.render_rays(trainer.params, chunk_rays)),
                      ("step", lambda: trainer.train_step(100))):
        chart.chart_sphere_fwd.launches = 0
        torch.cuda.synchronize()
        with torch.no_grad() if name == "chunk" else torch.enable_grad():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        rows = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)}
        out[f"{name}_ops"] = rows
        out[f"{name}_k7s"] = chart.chart_sphere_fwd.launches
    return out


def e2e(cs, other_root: Path) -> bool:
    """Both checkouts' view and step, each in a process of its own, in
    turns (other, this, this, other); returns whether this one launched
    fewer device operations a chunk and a step and one K7s each."""
    tool = other_root / "egonerf_torch" / "tools" / "chart_ab.py"
    if tool.resolve() != Path(__file__).resolve():
        shutil.copy(__file__, tool)
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        root = other_root if name == "other" else REPO
        proc = subprocess.run([sys.executable, "-m", "egonerf_torch.tools.chart_ab", "--measure"],
                              cwd=root, capture_output=True, text=True, timeout=900,
                              env={**os.environ, "PYTHONPATH": str(root)})
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            raise SystemExit(f"chart_ab: the {name} checkout's measurement failed")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name, rs in runs.items():
        print(f"generic_sphere {name}: view " + " / ".join(
            f"{v:.4f}" for r in rs for v in r["view_s"]) + " s; step " + " / ".join(
            f"{r['step_ms']:.3f}" for r in rs) + " ms (median of 20); device operations "
            f"a chunk {[sum(r['chunk_ops'].values()) for r in rs]}, a step "
            f"{[sum(r['step_ops'].values()) for r in rs]}; K7s a chunk "
            f"{[r['chunk_k7s'] for r in rs]}, a step {[r['step_k7s'] for r in rs]}", flush=True)
    ok = True
    for unit in ("chunk", "step"):
        a, b = runs["other"][0][f"{unit}_ops"], runs["this"][0][f"{unit}_ops"]
        gone = {k: a[k] - b.get(k, 0) for k in a if a[k] > b.get(k, 0)}
        new = {k: b[k] - a.get(k, 0) for k in b if b[k] > a.get(k, 0)}
        print(f"device operations a {unit}: the other's {sum(a.values())}, this "
              f"{sum(b.values())}; gone {json.dumps(gone)}; new {json.dumps(new)}", flush=True)
        ok = ok and sum(b.values()) < sum(a.values()) and all(
            r[f"{unit}_k7s"] == 1 for r in runs["this"])
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other revision's checkout root")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other and of this K7s")
    ap.add_argument("--measure", action="store_true",
                    help="print this checkout's view, step and device operations as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chart_ab: torch sees no CUDA device")
    if args.measure:
        print(json.dumps(measure()), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    import chip_smoke as cs

    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for stem in ("chart", "resample"):
        for name, regs, spill in _build.ptxas_report(stem):
            print(f"ptxas this {stem}: {regs} registers, {spill} bytes spilled: {name[:90]}",
                  flush=True)
    other_csrc = args.other / "egonerf_torch" / "csrc"
    jobs = {"other as it is": (other_csrc / "chart.cu", []),
            "other k4": (other_csrc / "resample.cu", [])}
    if args.ablate:
        other = _edited(other_csrc, {"chart.cuh": OTHER_CUH_EDITS, "chart.cu": OTHER_CU_EDITS},
                        OUT / "ablate_other")
        jobs.update({f"other {name}": (other, flags) for name, flags in OTHER_ABLATIONS[1:]})
        this = _edited(_build.CSRC, {"chart.cu": THIS_CU_EDITS}, OUT / "ablate_this")
        jobs.update({f"this {name}": (this, flags) for name, flags in THIS_ABLATIONS})
    libs = _build_all(jobs, OUT)
    dev = torch.device("cuda")
    trainer, cases = sphere_inputs(cs, dev)
    if args.ablate:
        sphere_ablate(cs, libs, trainer, cases)
    ok = sphere_compare(cs, libs, trainer, cases)
    del trainer, cases
    torch.cuda.empty_cache()
    k7_k4_compare(cs, libs)
    torch.cuda.empty_cache()
    ok = e2e(cs, args.other) and ok
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("chart_ab: a check missed (above)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    raise SystemExit(main())
