"""K4 and K7 of this checkout against another revision's, on one CUDA card:
the production render chunk and a recorded production training step.

    python -m egonerf_torch.tools.resample_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's
``resample.cu``, ``chart.cu`` and the headers they include (its
``egonerf_torch/csrc`` from ``git archive``).  Its ``resample_fwd`` takes
the earlier argument list, without ``u_step`` (eval's linspace comes as a
row of stride 0).

This checkout's K4 (with and without its chart epilogue) and K7 are first
held to their plain versions by ``chip_smoke``'s phase-2 functions.  Then,
each timed by ``chip_smoke.time_ms`` in turns (a, b, ..., b, a) on the same
inputs: the other K4, this K4, this K4 with the chart epilogue, the same
built with both charts' angles for every sample, the other K7 and this K7
on the fine depths; and the coarse chart of each K7.  ``--ablate`` first
times the other K4 as it is, with its merge replaced by a copy, with its
inverse-CDF search replaced by a fixed bracket, and with both, and the
other K7 with the yin angles skipped for every sample: text edits of the
other sources that measure where their time goes (the outputs are wrong);
the tool stops where an edit does not apply.  Prints one line a
measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from .. import _build, ops, presets
from ..ops import chart as chart_ops
from ..ops import pdf

OUT = _build.BUILD_ROOT.parent / "resample_ab"
# the earlier resample_fwd: no u_step, eval's u a row of stride 0
OTHER_K4_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3)


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"the edit does not apply: {old.splitlines()[0]!r}")
    return src.replace(old, new)


def _ablations(other: Path) -> dict:
    """{name: (source, flags)} of the other K4's and K7's ablated builds."""
    k4 = (other / "resample.cu").read_text()
    k4 = _edit(k4, "  if (merge) {\n", "  if (merge) {\n#ifdef NO_MERGE\n"
               "    for (int i = lane; i < S; i += 32) zo[i] = zc[i];\n"
               "    for (int j = lane; j < F; j += 32) zo[S + j] = zf[j];\n#else\n")
    k4 = _edit(k4, "    src = zo;\n", "#endif\n    src = zo;\n")
    k4 = _edit(k4, """    int lo = 0, hi = B;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= uk) lo = mid + 1; else hi = mid;
    }
""", """#ifdef NO_SEARCH
    int lo = 1 + (k * (B - 1)) / F;
#else
    int lo = 0, hi = B;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= uk) lo = mid + 1; else hi = mid;
    }
#endif
""")
    k7 = _edit((other / "chart.cu").read_text(), """  const float theta_n = safe_acos(dz, r);
  const float phi_n = atan2f(dy, dx);
  const bool yin = kLo <= theta_n && theta_n <= kHi && kPhiLo <= phi_n && phi_n <= kPhiHi;
""", """  const bool yin = fabsf(dz) < 0.7f * r;
  const float theta_n = 0.5f, phi_n = 0.25f;
""")
    d = OUT / "ablate"
    d.mkdir(parents=True, exist_ok=True)
    for h in other.glob("*.cuh"):
        shutil.copy(h, d)
    (d / "resample.cu").write_text(k4)
    (d / "chart.cu").write_text(k7)
    return {"k4 as it is": (d / "resample.cu", []),
            "k4 no merge": (d / "resample.cu", ["-DNO_MERGE"]),
            "k4 no search": (d / "resample.cu", ["-DNO_SEARCH"]),
            "k4 neither": (d / "resample.cu", ["-DNO_MERGE", "-DNO_SEARCH"]),
            "k7 as it is": (other / "chart.cu", []),
            "k7 no yin angles": (d / "chart.cu", [])}


def _both_angles() -> Path:
    """This checkout's kernels with both charts' angles taken for every
    sample (no early yin test)."""
    d = OUT / "both_angles"
    d.mkdir(parents=True, exist_ok=True)
    for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        shutil.copy(f, d)
    h = (d / "chart.cuh").read_text()
    a, b = h.index("  const float qz = chart_q(dz, r);"), h.index("  float4 c;")
    (d / "chart.cuh").write_text(h[:a] + """  const float theta_n = acosf(chart_q(dz, r));
  const float phi_n = atan2f(dy, dx);
  const bool yin = kChartLo <= theta_n && theta_n <= kChartHi && kChartPhiLo <= phi_n &&
                   phi_n <= kChartPhiHi;
  const float theta = yin ? theta_n : acosf(chart_q(dy, r));
  const float phi = yin ? phi_n : atan2f(dz, -dx);

""" + h[b:])
    return d


def _build_all(jobs: dict, out: Path = OUT) -> dict:
    """{name: (source, flags)} -> {name: CDLL}, one nvcc each, in parallel,
    into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, (src, flags)) in enumerate(jobs.items()):
        so = out / f"lib{i}.so"
        procs[name] = (so, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(so),
                                             str(src)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name} did not build:\n{log}")
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _fn(lib, name, argtypes):
    f = getattr(lib, name)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _other_k4(f, feat, z, d, n_f, u, merge, act):
    r, s = feat.shape
    n_out = s + n_f if merge else n_f
    zo, do = (torch.empty(r, n_out, device=feat.device) for _ in range(2))
    u_ptr = pdf.linspace01(n_f, feat.device) if u is None else u

    def run():
        err = f(feat.data_ptr(), z.data_ptr(), d.data_ptr(), u_ptr.data_ptr(),
                0 if u is None else n_f, r, s, n_f, int(merge), act[0], act[1],
                pdf.ACTIVATIONS.index(act[2]), zo.data_ptr(), do.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"resample_fwd: cudaError {err}")
        return zo, do
    return run


def _chart_with(f, rays_o, viewdirs, z, coords, downsample):
    r, s = z.shape
    out = torch.empty(r * s, 4, device=z.device)
    args = chart_ops.chart_args(coords, downsample, z.device)

    def run():
        err = f(rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                z.data_ptr(), z.stride(0), r, s, *args, out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"chart_fwd: cudaError {err}")
        return out
    return run


def _fused_with(f, feat, z, d, n_f, u, merge, act, rays_o, viewdirs, coords):
    r, s = feat.shape
    n_out = s + n_f if merge else n_f
    zo, do = (torch.empty(r, n_out, device=feat.device) for _ in range(2))
    out = torch.empty(r * n_out, 4, device=feat.device)
    chart = chart_ops.chart_args(coords, None, feat.device)

    def run():
        err = f(feat.data_ptr(), z.data_ptr(), d.data_ptr(), None if u is None else u.data_ptr(),
                n_f, chart_ops._recip(n_f - 1), r, s, n_f, int(merge), act[0], act[1],
                pdf.ACTIVATIONS.index(act[2]), zo.data_ptr(), do.data_ptr(), rays_o.data_ptr(),
                rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0), *chart,
                out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"resample_chart_fwd: cudaError {err}")
        return out
    return run


def _turns(cs, label: str, runs: dict) -> dict:
    """Each of ``runs`` timed in turns (a, b, ..., b, a); the mean of its two."""
    names = list(runs)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append(cs.time_ms(runs[n]))
    for n in names:
        print(f"{label} {n}: " + " / ".join(f"{x:.4f}" for x in t[n]) + " ms", flush=True)
    return {n: sum(v) / len(v) for n, v in t.items()}


def _inputs(cs, dev):
    """The production model's K4 inputs on one render chunk (spread over a
    2000x1000 view, rays from the origin) and on one recorded production
    training step: [(label, K4 args, (rays_o, viewdirs, coords))]."""
    from ..data.ray_utils import get_ray_directions_360
    from ..models.egonerf import _dists
    from ..train.config import load_config
    from ..train.trainer import Trainer

    model = presets.production_model(device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(cs.SEED))
    dirs = torch.as_tensor(get_ray_directions_360(*cs.IMAGE_HW).reshape(-1, 3), device=dev)
    with torch.no_grad():
        cs.render_kernel_checks(model, params, dirs, ops, presets, _dists)
    chunk, n_c, n_f = presets.EVAL_CHUNK, presets.RENDER["n_coarse"], presets.RENDER["n_fine"]
    coords, cfg = model.coordinates, model.cfg
    viewdirs = dirs[torch.arange(chunk, device=dev) * (dirs.shape[0] // chunk)]
    rays = torch.cat([torch.zeros_like(viewdirs), viewdirs], -1)
    with torch.no_grad():
        tables = model.lookup_tables(params)
        coarse_z = model.sample_depths_exp(chunk, n_c, dev)
        c_feat = ops.KERNELS.density(ops.KERNELS.chart(rays[:, :3], rays[:, 3:6], coarse_z,
                                                       coords, 2),
                                     tables.coarse_planes, tables.coarse_lines)
    act = (cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
    chunk_args = (c_feat.reshape(chunk, n_c), coarse_z, _dists(coarse_z), n_f, None, True, *act)
    del model, params, tables

    trainer = Trainer(load_config(overrides=presets.production_overrides(
        basedir=str(OUT / "runs"), expname="production", n_iters=10 ** 9, N_vis=0,
        progress_refresh_rate=10 ** 9)), device=dev)
    rec = cs.Recorder(ops.KERNELS.resample_chart)
    trainer.model.ops = ops.KERNELS._replace(resample_chart=rec)
    trainer.train_step(0)
    trainer.model.ops = ops.KERNELS
    torch.cuda.synchronize()
    cs.k4_checks("training step", ops, rec.args[:9], trainer.model.near_far[1], rec.args[9:12])
    return [("chunk", chunk_args, (rays[:, :3], rays[:, 3:6], coords)),
            ("step", rec.args[:9], rec.args[9:12])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other K4 and K7")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("resample_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for stem in ("resample", "chart"):
        for name, regs, spill in _build.ptxas_report(stem):
            print(f"ptxas {stem}: {regs} registers, {spill} bytes spilled: {name[:60]}",
                  flush=True)
    both = _both_angles()
    jobs = {"other k4": (args.other / "resample.cu", []),
            "other k7": (args.other / "chart.cu", []),
            "both angles k4": (both / "resample.cu", []),
            "both angles k7": (both / "chart.cu", [])}
    if args.ablate:
        jobs.update(_ablations(args.other))
    libs = _build_all(jobs)
    other_k4 = _fn(libs["other k4"], "resample_fwd", OTHER_K4_ARGS)
    other_k7 = _fn(libs["other k7"], "chart_fwd", chart_ops._ARGS)
    both_k7 = _fn(libs["both angles k7"], "chart_fwd", chart_ops._ARGS)
    both_k4 = _fn(libs["both angles k4"], "resample_chart_fwd", pdf._CHART_ARGS)

    cases = _inputs(cs, dev)
    for label, (feat, z, d, n_f, u, merge, *act), (ro, rd, coords) in cases:
        if args.ablate:
            _turns(cs, f"ablation K4 {label}", {
                n: _other_k4(_fn(libs[n], "resample_fwd", OTHER_K4_ARGS), feat, z, d, n_f, u,
                             merge, act)
                for n in ("k4 as it is", "k4 no merge", "k4 no search", "k4 neither")})
        new_z = pdf.resample(feat, z, d, n_f, u, merge, *act)[0]
        old_z = _other_k4(other_k4, feat, z, d, n_f, u, merge, act)()[0]
        fused = ops.KERNELS.resample_chart(feat, z, d, n_f, u, merge, *act, ro, rd, coords)[2]
        old_c = _chart_with(other_k7, ro, rd, new_z, coords, None)()
        torch.cuda.synchronize()
        print(f"{label}: this K4's depths equal the other's: {torch.equal(new_z, old_z)} (max "
              f"abs {float((new_z - old_z).abs().max()):.3e}); the fused coords equal the other "
              f"K7's on the same depths: {torch.equal(fused, old_c)}", flush=True)
        t = _turns(cs, f"K4 {label}", {
            "other K4": _other_k4(other_k4, feat, z, d, n_f, u, merge, act),
            "this K4": lambda: pdf.resample(feat, z, d, n_f, u, merge, *act),
            "this K4 + chart": lambda: ops.KERNELS.resample_chart(feat, z, d, n_f, u, merge,
                                                                  *act, ro, rd, coords),
            "this K4 + chart, both angles": _fused_with(both_k4, feat, z, d, n_f, u, merge, act,
                                                        ro, rd, coords),
            "other K7 (fine)": _chart_with(other_k7, ro, rd, old_z, coords, None),
            "this K7 (fine)": lambda: ops.KERNELS.chart(ro, rd, new_z, coords)})
        print(f"K4 {label}: other K4 + K7 {t['other K4'] + t['other K7 (fine)']:.4f} ms; this "
              f"K4 + K7 apart {t['this K4'] + t['this K7 (fine)']:.4f} ms; fused "
              f"{t['this K4 + chart']:.4f} ms", flush=True)
    ro, rd, coords = cases[0][2]
    coarse_z = cases[0][1][1]
    if args.ablate:
        _turns(cs, "ablation K7 coarse", {
            n: _chart_with(_fn(libs[n], "chart_fwd", chart_ops._ARGS), ro, rd, coarse_z, coords, 2)
            for n in ("k7 as it is", "k7 no yin angles")})
    _turns(cs, "K7 coarse", {
        "other": _chart_with(other_k7, ro, rd, coarse_z, coords, 2),
        "this": lambda: ops.KERNELS.chart(ro, rd, coarse_z, coords, 2),
        "this, both angles": _chart_with(both_k7, ro, rd, coarse_z, coords, 2)})
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
