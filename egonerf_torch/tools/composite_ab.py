"""The composite's kernels of this checkout against another revision's, on
one CUDA card, on the composite inputs of recorded production training
steps (4096 rays, 256 merged samples, as ``chip_smoke.py``'s phase 2
records them for K6b): the indoor EgoNeRF step, the outdoor step with the
envmap (``presets.outdoor_overrides``, a 2000x1000x3 table) and the
TensoRF ``tensorf_bench`` step with its gates (a 128^3 mask of half
occupancy).

    python -m egonerf_torch.tools.composite_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's
``composite.cu``, ``envmap.cu`` and the headers they include (its
``egonerf_torch/csrc`` from ``git archive``), whose ``envmap_fwd`` and
``composite_bwd`` take this checkout's arguments and whose
``composite_fwd`` takes the earlier ones (no envmap form).

``--ablate`` first times the other revision's kernels as they are and
ablated by text edits of their sources (``K8_EDITS``, ``K6B_EDITS``; the
outputs are wrong, and the tool stops where an edit does not apply): K8
as an empty launch of its grid; K6b without its d_feat and d_rgb stores,
with one read of rgb in place of three (the later two read shared
memory), without the forward scan's recomputation (alpha from dists
alone, no feat read, no forward sum) and as an empty launch; then the
other K6b on 1/8, 1/4, 1/2 and all of the step's rays, and its env and
gated instantiations as they are.  Then this checkout's K6b with its
row stores dropped (``THIS_EDITS``), as an empty launch, and on 1/8 to
all of the step's rays.

Then this checkout's K6e (the envmap form of ``composite``) is held to the
other revision's K8 followed by its K6 with that env, every output (rgb,
depth, acc, bg, bg_map, env) bit for bit, and this K6b to the other's
in its three instantiations (EgoNeRF, envmap, gated), d_feat, d_rgb and
d_env bit for bit, on the recorded steps and on seeded rays of S = 1, 33,
96, 256 and 1536 samples; a miss is printed and makes the exit code 1
after the timings.  Each comparison is timed by ``chip_smoke.time_ms`` in
turns (other, this, this, other) on the same inputs, beside its byte
bound (inputs read once, outputs written once).  Prints one line a
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
from ..ops import envmap, volrend
from .resample_ab import _build_all, _edit, _fn, _turns

OUT = _build.BUILD_ROOT.parent / "composite_ab"
# the earlier composite_fwd (no envmap form)
OTHER_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_float, ctypes.c_int, ctypes.c_float] + \
    [ctypes.c_void_p] * 6
# text edits of the other envmap_kernel: an empty launch
K8_EDITS = (
    ("  if (ray >= R) return;\n  const Corners c = corners_of(dirs + (long long)ray * d_stride, "
     "h, inv_2pi);\n#pragma unroll\n  for (int ch = 0; ch < 3; ++ch) {\n    float acc",
     "#ifdef EMPTY\n  return;\n#endif\n"
     "  if (ray >= R) return;\n  const Corners c = corners_of(dirs + (long long)ray * d_stride, "
     "h, inv_2pi);\n#pragma unroll\n  for (int ch = 0; ch < 3; ++ch) {\n    float acc"),)
# text edits of the other composite_bwd_kernel: an empty launch (EMPTY),
# the stores of d_feat and d_rgb folded into a sum kept alive by one test
# (NO_STORES), rgb read once, in the forward sum (ONE_RGB), and alpha from
# dists alone with no forward sum (NO_RECOMPUTE)
K6B_EDITS = (
    ("namespace {\n",
     "#ifdef NO_STORES\n#define ST(dst, v) (sink += (v))\n#else\n#define ST(dst, v) ((dst) = (v))"
     "\n#endif\n\nnamespace {\n"),
    ("  float* tr = al + S;\n  if (ray >= R) return;\n",
     "  float* tr = al + S;\n#ifdef EMPTY\n  return;\n#endif\n  if (ray >= R) return;\n"),
    ("  // the forward scan: alpha, the exclusive transmittance, the unclipped sum\n"
     "  const int per = (S + 31) / 32;\n  const int a = min(lane * per, S), b = min(a + per, S);\n"
     "  float prod = 1.0f;\n  for (int j = a; j < b; ++j) {\n"
     "    const float alpha = kGates ? gated_alpha(feat, dists, valid, j, shift, scale, act)\n"
     "                               : alpha_of(feat[j], dists[j], shift, scale, act);\n",
     "  const int per = (S + 31) / 32;\n  const int a = min(lane * per, S), b = min(a + per, S);\n"
     "  float prod = 1.0f;\n  for (int j = a; j < b; ++j) {\n#ifdef NO_RECOMPUTE\n"
     "    const float alpha = 0.01f * dists[j];\n#else\n"
     "    const float alpha = kGates ? gated_alpha(feat, dists, valid, j, shift, scale, act)\n"
     "                               : alpha_of(feat[j], dists[j], shift, scale, act);\n#endif\n"),
    ("    if (!kGates || wj > thres) {\n      r += wj * rgb[3 * j];\n"
     "      g += wj * rgb[3 * j + 1];\n      bl += wj * rgb[3 * j + 2];\n    }\n  }\n"
     "  r = warp_sum(r);\n  g = warp_sum(g);\n  bl = warp_sum(bl);\n  float e0",
     "#ifndef NO_RECOMPUTE\n    if (!kGates || wj > thres) {\n      r += wj * rgb[3 * j];\n"
     "      g += wj * rgb[3 * j + 1];\n      bl += wj * rgb[3 * j + 2];\n    }\n#endif\n  }\n"
     "  r = warp_sum(r);\n  g = warp_sum(g);\n  bl = warp_sum(bl);\n  float e0"),
    ("    const float q = kept(j) ? rgb[3 * j] * gr + rgb[3 * j + 1] * gg + rgb[3 * j + 2] * gb : "
     "0.0f;\n",
     "#ifdef ONE_RGB\n    const float q = kept(j) ? tr[j] * gr : 0.0f;\n#else\n"
     "    const float q = kept(j) ? rgb[3 * j] * gr + rgb[3 * j + 1] * gg + rgb[3 * j + 2] * gb : "
     "0.0f;\n#endif\n"),
    ("    const float c0 = rgb[3 * j], c1 = rgb[3 * j + 1], c2 = rgb[3 * j + 2];\n",
     "#ifdef ONE_RGB\n    const float c0 = tr[j], c1 = al[j], c2 = tr[j];\n#else\n"
     "    const float c0 = rgb[3 * j], c1 = rgb[3 * j + 1], c2 = rgb[3 * j + 2];\n#endif\n"),
    ("  float Rn = lane == 31 ? r_end : An + Bn * r_end;\n",
     "  float Rn = lane == 31 ? r_end : An + Bn * r_end;\n  float sink = 0.0f;\n"),
    ("      d_feat[j] = 0.0f;\n", "      ST(d_feat[j], 0.0f);\n"),
    ("      d_feat[j] = d_alpha * e * D * density_act_grad(f, shift, act);\n",
     "      ST(d_feat[j], d_alpha * e * D * density_act_grad(f, shift, act));\n"),
    ("    d_rgb[3 * j] = wj * gr;\n    d_rgb[3 * j + 1] = wj * gg;\n"
     "    d_rgb[3 * j + 2] = wj * gb;\n  }\n}\n",
     "    ST(d_rgb[3 * j], wj * gr);\n    ST(d_rgb[3 * j + 1], wj * gg);\n"
     "    ST(d_rgb[3 * j + 2], wj * gb);\n  }\n#ifdef NO_STORES\n"
     "  if (sink == -7.0f) d_feat[ray * S] = sink;\n#endif\n}\n"))
K6B_ABLATIONS = (("as it is", []), ("no d_feat, d_rgb stores", ["-DNO_STORES"]),
                 ("one rgb read", ["-DONE_RGB"]), ("no forward recompute", ["-DNO_RECOMPUTE"]),
                 ("empty launch", ["-DEMPTY"]))
# text edits of this checkout's composite_bwd_kernel: an empty launch, and
# the rows' stores dropped (the last pass's values kept alive by one test)
THIS_EDITS = (
    ("  if (ray >= R) return;\n  const int per = (S + 31) / 32;\n  const int P = 32 * per;\n",
     "#ifdef EMPTY\n  return;\n#endif\n"
     "  if (ray >= R) return;\n  const int per = (S + 31) / 32;\n  const int P = 32 * per;\n"),
    ("  __syncwarp();\n  store_row(f, S, d_feat + ray * S, lane);\n"
     "  store_rgb(c0, S, P, d_rgb + ray * S * 3, lane);\n",
     "  __syncwarp();\n#ifdef NO_STORES\n"
     "  if (f[sw(lane)] + c1[sw(lane)] == -7.0f) d_feat[ray * S] = 0.0f;\n#else\n"
     "  store_row(f, S, d_feat + ray * S, lane);\n"
     "  store_rgb(c0, S, P, d_rgb + ray * S * 3, lane);\n#endif\n"))
THIS_ABLATIONS = (("as it is", []), ("no row stores", ["-DNO_STORES"]),
                  ("empty launch", ["-DEMPTY"]))


def _edited(src: Path, edits, out: Path) -> Path:
    text = src.read_text()
    for old, new in edits:
        text = _edit(text, old, new)
    out.mkdir(parents=True, exist_ok=True)
    for h in src.parent.glob("*.cuh"):
        shutil.copy(h, out)
    (out / src.name).write_text(text)
    return out / src.name


def _ablations(other: Path) -> dict:
    """{name: (source, flags)} of the ablated builds."""
    k8 = _edited(other / "envmap.cu", K8_EDITS, OUT / "ablate_k8")
    k6b = _edited(other / "composite.cu", K6B_EDITS, OUT / "ablate_k6b")
    this = _edited(_build.CSRC / "composite.cu", THIS_EDITS, OUT / "ablate_this")
    jobs = {"K8 as it is": (other / "envmap.cu", []), "K8 empty launch": (k8, ["-DEMPTY"])}
    jobs.update({f"K6b {name}": (k6b, flags) for name, flags in K6B_ABLATIONS})
    jobs.update({f"this K6b {name}": (this, flags) for name, flags in THIS_ABLATIONS})
    return jobs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _other_k8(f, table, dirs):
    out = torch.empty(dirs.shape[0], 3, device=dirs.device)

    def run():
        err = f(dirs.data_ptr(), dirs.stride(0), table.data_ptr(), table.shape[1],
                dirs.shape[0], envmap.INV_2PI, out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"envmap_fwd: cudaError {err}")
        return out
    return run


def _other_k6(f, feat, dists, z, rgb, ray_dz, shift, scale, act, env=None):
    """The other composite_fwd (ungated) on these inputs; returns a run
    giving (rgb, depth, acc, bg[, bg_map])."""
    r, s = feat.shape
    dev = feat.device
    outs = [torch.empty(r, 3, device=dev), torch.empty(r, device=dev),
            torch.empty(r, device=dev), torch.empty(r, 1, device=dev)]
    bg_map = None if env is None else torch.empty(r, 3, device=dev)

    def run():
        err = f(feat.data_ptr(), dists.data_ptr(), z.data_ptr(), rgb.data_ptr(),
                ray_dz.data_ptr(), volrend._ptr(env), None, r, s, shift, scale,
                volrend.ACTIVATIONS.index(act), float("-inf"), *(o.data_ptr() for o in outs),
                volrend._ptr(bg_map), _stream())
        if err:
            raise RuntimeError(f"composite_fwd: cudaError {err}")
        return tuple(outs) + (() if env is None else (bg_map,))
    return run


def _other_k6b(f, feat, dists, rgb, g, shift, scale, act, env, valid, thres):
    r, s = feat.shape
    dev = feat.device
    d_feat, d_rgb = torch.empty(r, s, device=dev), torch.empty(r, s, 3, device=dev)
    d_env = None if env is None else torch.empty(r, 3, device=dev)
    thres = float("-inf") if thres is None else float(thres)

    def run():
        err = f(feat.data_ptr(), dists.data_ptr(), rgb.data_ptr(), g.data_ptr(), volrend._ptr(env),
                volrend._ptr(valid), r, s, shift, scale, volrend.ACTIVATIONS.index(act), thres,
                d_feat.data_ptr(), d_rgb.data_ptr(), volrend._ptr(d_env), _stream())
        if err:
            raise RuntimeError(f"composite_bwd: cudaError {err}")
        return (d_feat, d_rgb) + (() if env is None else (d_env,))
    return run


def _pair(k8, k6, args):
    """The other revision's envmap path: its K8 on the table and the
    directions, then its K6 with that env.  ``args`` are this checkout's
    K6e arguments.  Returns a run giving K6e's six outputs."""
    feat, dists, z, rgb, ray_dz, shift, scale, act, _, _, _, table, dirs = args
    lookup = _other_k8(k8, table, dirs)
    env = lookup()
    blend = _other_k6(k6, feat, dists, z, rgb, ray_dz, shift, scale, act, env)

    def run():
        lookup()
        return blend() + (env,)
    return run


def record_steps(cs, dev) -> dict:
    """The composite arguments of one training step at each shape:
    {"K6b": indoor K6b, "K6b env": outdoor K6b, "K6e": outdoor K6e,
    "K6b gated": TensoRF K6b}, recorded from ``Trainer.train_step``."""
    from ..data.datasets import SyntheticEgoDataset
    from ..models.alphamask import AlphaGridMask
    from ..train.config import load_config
    from ..train.trainer import Trainer

    common = dict(basedir=str(OUT / "runs"), n_iters=10 ** 9, N_vis=0,
                  progress_refresh_rate=10 ** 9)
    shapes = {}

    def record(trainer, fwd_key, bwd_key):
        rec_f, rec_b = cs.Recorder(ops.KERNELS.composite), cs.Recorder(ops.KERNELS.composite_bwd)
        trainer.model.ops = ops.KERNELS._replace(composite=rec_f, composite_bwd=rec_b)
        try:
            trainer.train_step(0)
        finally:
            trainer.model.ops = ops.KERNELS
        torch.cuda.synchronize()
        shapes[bwd_key] = rec_b.args
        if fwd_key:
            shapes[fwd_key] = rec_f.args

    record(Trainer(load_config(overrides=presets.production_overrides(
        expname="production", **common)), device=dev), None, "K6b")
    outdoor = Trainer(load_config(overrides=presets.outdoor_overrides(
        expname="outdoor", **common)), device=dev)
    scene = dict(cs.ENV_SCENE, near_far=outdoor.cfg.near_far)
    outdoor.set_datasets(SyntheticEgoDataset(split="train", **scene),
                         SyntheticEgoDataset(split="test", is_stack=True, **scene))
    record(outdoor, "K6e", "K6b env")
    del outdoor
    tf = Trainer(load_config(overrides=presets.tensorf_mask_overrides(
        expname="tensorf", **common)), device=dev)
    tf_scene = dict(presets.TENSORF_BENCH_SCENE, near_far=tf.cfg.near_far)
    tf.set_datasets(SyntheticEgoDataset(split="train", **tf_scene),
                    SyntheticEgoDataset(split="test", is_stack=True, **tf_scene))
    tf.model.alpha_mask = AlphaGridMask(cs.half_mask(cs.TF_MASK_RESO, dev), device=dev)
    record(tf, None, "K6b gated")
    return shapes


def bwd_bytes(args) -> int:
    """K6b's bytes: feat, dists, rgb, g (and env, valid) read once, d_feat,
    d_rgb (and d_env) written once."""
    feat, dists, rgb, g, *_, env, valid, _ = args
    n = 4 * (2 * feat.numel() + dists.numel() + 2 * rgb.numel() + g.numel())
    return n + (24 * env.shape[0] if env is not None else 0) + (
        valid.numel() if valid is not None else 0)


def ablate_other(cs, libs, shapes) -> None:
    """The other revision's K8, K6 env and K6b, as they are and ablated."""
    k8 = _fn(libs["other envmap"], "envmap_fwd", envmap._ARGS)
    k6 = _fn(libs["other composite"], "composite_fwd", OTHER_FWD_ARGS)
    k6b = _fn(libs["other composite"], "composite_bwd", volrend._BWD_ARGS)
    e_args = shapes["K6e"]
    _turns(cs, "ablation K8", {
        name: _other_k8(_fn(libs[f"K8 {name}"], "envmap_fwd", envmap._ARGS), e_args[11],
                        e_args[12]) for name in ("as it is", "empty launch")})
    env = _other_k8(k8, e_args[11], e_args[12])()
    _turns(cs, "ablation K6 env", {"as it is": _other_k6(k6, *e_args[:8], env)})
    _turns(cs, "ablation K6b", {
        name: _other_k6b(_fn(libs[f"K6b {name}"], "composite_bwd", volrend._BWD_ARGS),
                         *shapes["K6b"]) for name, _ in K6B_ABLATIONS})
    r = shapes["K6b"][0].shape[0]
    # a kernel held by one warp's chain keeps its time as the warps an SM
    # runs fall, one held by the SM's issue or memory rate falls with them
    _turns(cs, "ablation K6b rays", {
        f"{m} rays": _other_k6b(k6b, *(x[:m].contiguous() if torch.is_tensor(x) else x
                                      for x in shapes["K6b"]))
        for m in (r // 8, r // 4, r // 2, r)})
    _turns(cs, "ablation K6b instantiations", {
        key: _other_k6b(k6b, *shapes[key]) for key in ("K6b", "K6b env", "K6b gated")})


def ablate_this(cs, libs, shapes) -> None:
    """This checkout's K6b as it is, without its row stores and empty."""
    feat, dists, rgb, g, shift, scale, act = shapes["K6b"][:7]
    r, s = feat.shape
    d_feat, d_rgb = torch.empty_like(feat), torch.empty_like(rgb)

    def run_with(f):
        def run():
            err = f(feat.data_ptr(), dists.data_ptr(), rgb.data_ptr(), g.data_ptr(), None, None,
                    r, s, shift, scale, volrend.ACTIVATIONS.index(act), float("-inf"),
                    d_feat.data_ptr(), d_rgb.data_ptr(), None, _stream())
            if err:
                raise RuntimeError(f"composite_bwd: cudaError {err}")
        return run
    _turns(cs, "ablation this K6b", {
        name: run_with(_fn(libs[f"this K6b {name}"], "composite_bwd", volrend._BWD_ARGS))
        for name, _ in THIS_ABLATIONS})
    _turns(cs, "ablation this K6b rays", {
        f"{m} rays": (lambda a: lambda: ops.KERNELS.composite_bwd(*a))(
            tuple(x[:m].contiguous() if torch.is_tensor(x) else x for x in shapes["K6b"]))
        for m in (r // 8, r // 4, r // 2, r)})


def compare(cs, libs, shapes) -> bool:
    """This K6e against the other K8 + K6 env pair and this K6b against the
    other's, bit for bit, each timed in turns; prints a line each and
    returns whether every output held."""
    k8 = _fn(libs["other envmap"], "envmap_fwd", envmap._ARGS)
    k6 = _fn(libs["other composite"], "composite_fwd", OTHER_FWD_ARGS)
    k6b = _fn(libs["other composite"], "composite_bwd", volrend._BWD_ARGS)
    e_args = shapes["K6e"]
    pair = _pair(k8, k6, e_args)
    want = pair()
    got = ops.KERNELS.composite(*e_args)
    torch.cuda.synchronize()
    diff = cs.bits_differ(got, want)
    ok = diff == 0
    print(f"K6e: {diff} of {sum(g.numel() for g in got):,} outputs (rgb, depth, acc, bg, "
          f"bg_map, env) differ from the other K8 + K6 env's bits -> "
          f"{'ok' if diff == 0 else 'MISS'}", flush=True)
    t = _turns(cs, "K6e", {"other K8 + K6 env": pair,
                           "this K6e": lambda: ops.KERNELS.composite(*e_args)})
    r = e_args[0].shape[0]
    table, dirs = e_args[11], e_args[12]
    texels = int(torch.cat([i[w > 0] for i, w in envmap.envmap_corners(dirs, table.shape[1])])
                 .unique().numel())
    # K6 env's inputs and outputs, the directions, the texels and env out
    n_bytes = cs.nbytes(*e_args[:5]) + r * 9 * 4 + r * 12 + texels * 12 + r * 12
    byte_ms = n_bytes / cs.PEAK_BYTES_PER_S * 1e3
    print(f"K6e: this {t['this K6e']:.4f} ms (other pair {t['other K8 + K6 env']:.4f}); "
          f"byte bound {byte_ms:.4f} ms ({n_bytes / 1e6:.1f} MB), this at "
          f"{byte_ms / t['this K6e']:.1%} of it", flush=True)

    # K6b against the other's, each instantiation on its recorded step
    for key in ("K6b", "K6b env", "K6b gated"):
        b_args = shapes[key]
        other = _other_k6b(k6b, *b_args)
        diff = cs.bits_differ(ops.KERNELS.composite_bwd(*b_args), other())
        ok = ok and diff == 0
        t = _turns(cs, key, {"other": other, "this": lambda: ops.KERNELS.composite_bwd(*b_args)})
        byte_ms = bwd_bytes(b_args) / cs.PEAK_BYTES_PER_S * 1e3
        warps, smem = volrend.bwd_geometry(b_args[0].shape[1], key == "K6b gated")
        print(f"{key}: {diff} outputs differ from the other's bits -> "
              f"{'ok' if diff == 0 else 'MISS'}; this {t['this']:.4f} ms (other "
              f"{t['other']:.4f}, {t['other'] / t['this']:.2f}x), {warps} warps a block, "
              f"{smem} shared bytes; byte bound {byte_ms:.4f} ms "
              f"({bwd_bytes(b_args) / 1e6:.1f} MB), this at {byte_ms / t['this']:.1%} of it",
              flush=True)

    # K6b on seeded rays of other sample counts, each instantiation
    dev = e_args[0].device
    for s in cs.K6B_SWEEP_S:
        r = 1024 if s > 256 else 4096
        for label, env, gated in (("EgoNeRF", False, False), ("env", True, False),
                                  ("gated", False, True)):
            b_args = cs.k6b_case(r, s, env, gated, cs.SEED + s, dev)
            diff = cs.bits_differ(ops.KERNELS.composite_bwd(*b_args), _other_k6b(k6b, *b_args)())
            ok = ok and diff == 0
            print(f"K6b {label} at {r} x {s}: {diff} outputs differ from the other's bits -> "
                  f"{'ok' if diff == 0 else 'MISS'}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other K8 and K6b and of this K6b")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("composite_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for stem in ("composite", "envmap"):
        for name, regs, spill in _build.ptxas_report(stem):
            print(f"ptxas {stem}: {regs} registers, {spill} bytes spilled: {name[:70]}",
                  flush=True)
    jobs = {"other composite": (args.other / "composite.cu", []),
            "other envmap": (args.other / "envmap.cu", [])}
    if args.ablate:
        jobs.update(_ablations(args.other))
    libs = _build_all(jobs, OUT)
    shapes = record_steps(cs, dev)
    feat = shapes["K6b"][0]
    print(f"steps: {feat.shape[0]} rays x {feat.shape[1]} samples; outdoor table "
          f"{tuple(shapes['K6e'][11].shape)}; TensoRF {tuple(shapes['K6b gated'][0].shape)}, "
          f"{float(shapes['K6b gated'][8].float().mean()):.1%} of the samples valid", flush=True)
    if args.ablate:
        ablate_other(cs, libs, shapes)
        ablate_this(cs, libs, shapes)
    ok = compare(cs, libs, shapes)
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("composite_ab: a kernel disagrees with the other revision's (above)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    raise SystemExit(main())
