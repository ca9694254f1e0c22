"""The cull's kernels of this checkout against another revision's, on one
CUDA card, on the production render chunk (4096 rays, 128 coarse + 128
fine samples, the coarse pass of seeded random weights, as
``chip_smoke.py``'s phase 2 builds it): the coarse pass (this checkout's
fused K4c, ``pdf.resample_score``, against the other's K4 weights
instantiation followed by its K12) and K13 at K = 192 and 128.

    python -m egonerf_torch.tools.cull_kernel_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's
``resample.cu``, ``cull.cu`` and the headers they include (its
``egonerf_torch/csrc`` from ``git archive``), whose ``resample_weights_fwd``,
``cull_score`` and ``top_k`` take the same arguments as this checkout's.

``--ablate`` first times the other revision's K4 weights instantiation
and K12, and this checkout's K4c, in turns, each as it is and ablated by
a text edit of its source (``K4W_EDITS``, ``PAD_EDITS``, ``K12_EDITS``,
``K4C_EDITS``; the outputs are wrong, and the tool stops where an edit
does not apply): K4w without its weights store, with the inverse-CDF
search replaced by a fixed bracket (the merge path then taken whatever
the draws' order), with the merge replaced by a copy, with its shared
arrays padded to a stride of run + 1 (shifts: the production runs are
powers of two) and as an empty launch of its grid; K12 without its
binary search, without its store and as an empty launch; K4c without its
output stores, with a fixed bracket, with a copy in place of the union's
ranks, without the score's reads and as an empty launch; then K4c on
1/8, 1/4, 1/2 and all of the chunk's rays.

Then the fused kernel's z, dists and score are held to the other pair's
bit for bit, and each K13 to ``select_top_k_plain`` on the chunk's scores
and on three harder score sets (the training tie-break, long runs of
equal scores, all zero); a miss is printed and makes the exit code 1
after the timings.  Each comparison is timed by ``chip_smoke.time_ms`` in
turns (other, this, this, other) on the same inputs, beside its byte
bound (inputs read once, outputs written once).  Prints one line a
measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import re
import shutil
from pathlib import Path

import torch

from .. import _build, ops, presets
from ..ops import cull, pdf
from .resample_ab import _build_all, _edit, _fn, _turns

OUT = _build.BUILD_ROOT.parent / "cull_kernel_ab"
KEEPS = (192, 128)
# text edits of the other resample_kernel: an empty launch (EMPTY), no
# weights store (NO_WSTORE), a fixed bracket for every draw with the merge
# path taken whatever the draws' order (FIXED_BRACKET), a copy for the
# merge (NO_MERGE)
K4W_EDITS = (
    ("  extern __shared__ float smem[];\n  const int n_grid",
     "  extern __shared__ float smem[];\n#ifdef EMPTY\n  return;\n#endif\n  const int n_grid"),
    ("    for (int j = lane; j < S; j += 32) w_out[ray * S + j] = w[j];\n",
     "#ifndef NO_WSTORE\n    for (int j = lane; j < S; j += 32) w_out[ray * S + j] = w[j];\n"
     "#endif\n"),
    ("      if (k == k0) {\n        pos = upper_bound(cdf, 0, B, uk);\n",
     "#ifdef FIXED_BRACKET\n      pos = 1 + (k * (B - 1)) / F;\n#else\n"
     "      if (k == k0) {\n        pos = upper_bound(cdf, 0, B, uk);\n"),
    ("      }\n      const int below = max(pos - 1, 0);\n",
     "      }\n#endif\n      const int below = max(pos - 1, 0);\n"),
    ("    if (__all_sync(kFullMask, ordered)) {\n",
     "#ifdef FIXED_BRACKET\n    ordered = true;\n#endif\n"
     "    if (__all_sync(kFullMask, ordered)) {\n"),
    ("  if (merge) {\n", "  if (merge) {\n#ifdef NO_MERGE\n"
     "    for (int i = lane; i < S; i += 32) zo[i] = zc[i];\n"
     "    for (int j = lane; j < F; j += 32) zo[S + j] = zf[j];\n#else\n"),
    ("    src = zo;\n", "#endif\n    src = zo;\n"))
# the padded layout: each lane-run array (w, the pdf / cdf, the fine and
# the merged z) gets one spare word after every run, so a lane's run
# starts at lane * (run + 1); the index shifts are log2 of each run
PAD_EDITS = (
    ("  return s + (s - 1) + s + f + t;", "  return s + (s - 1) + s + f + t + 4 * 33;"),
    ("int upper_bound(const float* x, int lo, int hi, float v) {",
     "int upper_bound(const float* x, int lo, int hi, float v, int sh) {"),
    ("    if (x[mid] <= v) lo = mid + 1; else hi = mid;",
     "    if (x[mid + (mid >> sh)] <= v) lo = mid + 1; else hi = mid;"),
    ("  const int T = merge ? S + F : F;\n  float* w",
     "  const int T = merge ? S + F : F;\n"
     "  const int pad_w = 31 - __clz((S + 31) / 32), pad_c = 31 - __clz((S + 29) / 32),\n"
     "            pad_f = 31 - __clz((F + 31) / 32), pad_o = 31 - __clz((T + 31) / 32);\n"
     "  float* w"),
    ("  float* cdf = w + S;", "  float* cdf = w + S + 33;"),
    ("  float* zc = cdf + S - 1;", "  float* zc = cdf + S - 1 + 33;"),
    ("  float* zo = zf + F;", "  float* zo = zf + F + 33;"))
PAD_MACROS = """#define PAD_w(j) ((j) + ((j) >> pad_w))
#define PAD_cdf(j) ((j) + ((j) >> pad_c))
#define PAD_zf(j) ((j) + ((j) >> pad_f))
#define PAD_zo(j) ((j) + ((j) >> pad_o))
#define PAD_src(j) ((j) + ((j) >> pad_o))
"""
K4W_ABLATIONS = (("as it is", "k4w", []), ("no weights store", "k4w", ["-DNO_WSTORE"]),
                 ("fixed bracket", "k4w", ["-DFIXED_BRACKET"]),
                 ("merge a copy", "k4w", ["-DNO_MERGE"]),
                 ("padded runs", "k4w pad", []), ("empty launch", "k4w", ["-DEMPTY"]))
# text edits of the other cull_score_kernel
K12_EDITS = (
    ("  if (ray >= R) return;\n  float* zc = smem + warp * 2 * C;\n",
     "#ifdef EMPTY\n  return;\n#endif\n  if (ray >= R) return;\n"
     "  float* zc = smem + warp * 2 * C;\n"),
    ("    int lo = 0, hi = C;\n    while (lo < hi) {\n",
     "#ifdef NO_SEARCH\n    int lo = (j * C) / S + (v < 0.0f);\n#else\n"
     "    int lo = 0, hi = C;\n    while (lo < hi) {\n"),
    ("      if (zc[mid] <= v) lo = mid + 1; else hi = mid;\n    }\n",
     "      if (zc[mid] <= v) lo = mid + 1; else hi = mid;\n    }\n#endif\n"),
    ("    score[j] = lo > 0 ? wd[lo - 1] : 0.0f;\n",
     "#ifdef NO_STORE\n    const float sv = lo > 0 ? wd[lo - 1] : 0.0f;\n"
     "    if (sv == -7.0f) score[j] = sv;\n#else\n"
     "    score[j] = lo > 0 ? wd[lo - 1] : 0.0f;\n#endif\n"))
K12_ABLATIONS = (("as it is", []), ("no search", ["-DNO_SEARCH"]),
                 ("no store", ["-DNO_STORE"]), ("empty launch", ["-DEMPTY"]))
# text edits of this checkout's resample_score_kernel (K4c): an empty
# launch, a fixed bracket for every draw (t clamped into its bin, the
# ranks then taken whatever the draws' order), a copy for the merge, the
# score's reads of the dilated weights dropped, the output stores dropped
# (the outputs kept alive by one test)
K4C_EDITS = (
    ("  extern __shared__ float4 smem4[];\n",
     "  extern __shared__ float4 smem4[];\n#ifdef EMPTY\n  return;\n#endif\n"),
    ("    for (int e = kTopLog; e >= 0; --e) {\n",
     "#ifdef FIXED_BRACKET\n#pragma unroll\n"
     "    for (int i = 0; i < PF; ++i) pos[i] = 1 + ((k0 + i) * (B - 1)) / F;\n"
     "    for (int e = -1; e >= 0; --e) {\n#else\n"
     "    for (int e = kTopLog; e >= 0; --e) {\n#endif\n"),
    ("  // every output to its place in shared memory, with its score\n",
     "#ifdef FIXED_BRACKET\n  ordered = true;\n#endif\n"
     "  // every output to its place in shared memory, with its score\n"),
    ("  } else if (__all_sync(kFullMask, ordered)) {\n",
     "  } else if (__all_sync(kFullMask, ordered)) {\n#ifdef NO_MERGE\n"
     "    for (int p = lane; p < T; p += 32) {\n"
     "      zo[p] = p < S ? zc[p] : zf[p - S];\n      so[p] = wd[min(p, S - 1)];\n    }\n"
     "#else\n"),
    ("  } else {\n    // the full-rank walk, as K4",
     "#endif\n  } else {\n    // the full-rank walk, as K4"),
    ("        so[p] = c >= 0 ? wd[c] : 0.0f;\n",
     "#ifdef NO_SCORE\n        so[p] = (float)c;\n#else\n"
     "        so[p] = c >= 0 ? wd[c] : 0.0f;\n#endif\n"),
    ("        float sc = wdv[i];\n",
     "#ifdef NO_SCORE\n        float sc = v;\n#else\n        float sc = wdv[i];\n#endif\n"),
    ("      const float t = __fdiv_rn(__fsub_rn(uk[i], c_lo), denom);\n",
     "      float t = __fdiv_rn(__fsub_rn(uk[i], c_lo), denom);\n"
     "#ifdef FIXED_BRACKET\n      t = fminf(fmaxf(t, 0.0f), 1.0f);\n#endif\n"),
    ("      *reinterpret_cast<float4*>(z_out + row + p) = v;\n",
     "#ifdef NO_STORE\n      if (v.x + d.w + sc.y == -7.0f) z_out[row] = v.y;\n"
     "      continue;\n#endif\n"
     "      *reinterpret_cast<float4*>(z_out + row + p) = v;\n"))
K4C_ABLATIONS = (("as it is", []), ("no output stores", ["-DNO_STORE"]),
                 ("fixed bracket", ["-DFIXED_BRACKET"]), ("merge a copy", ["-DNO_MERGE"]),
                 ("no score reads", ["-DNO_SCORE"]), ("empty launch", ["-DEMPTY"]))


def _padded(src: str) -> str:
    """The resample kernel with its lane-run arrays padded: every index of
    w, cdf, zf, zo and src through its PAD_ macro."""
    for old, new in PAD_EDITS:
        src = _edit(src, old, new)
    a, b = src.index("resample_kernel("), src.index("\ntemplate <bool kChart, bool kWeights>\nint")
    body = re.sub(r"(?<![\w.])(w|cdf|zf|zo|src)\[([^\[\]]+)\]",
                  lambda m: f"{m[1]}[PAD_{m[1]}({m[2]})]", src[a:b])
    body = re.sub(r"upper_bound\(cdf, ([^;]*?), uk\)", r"upper_bound(cdf, \1, uk, pad_c)", body)
    src = src[:a] + body + src[b:]
    return _edit(src, "namespace {\n", PAD_MACROS + "namespace {\n")


def _ablations(other: Path) -> dict:
    """{name: (source, flags)} of the other K4w's and K12's ablated builds."""
    d = OUT / "ablate"
    (d / "pad").mkdir(parents=True, exist_ok=True)
    k4 = (other / "resample.cu").read_text()
    for h in other.glob("*.cuh"):
        shutil.copy(h, d)
        shutil.copy(h, d / "pad")
    (d / "pad" / "resample.cu").write_text(_padded(k4))
    for old, new in K4W_EDITS:
        k4 = _edit(k4, old, new)
    (d / "resample.cu").write_text(k4)
    k12 = (other / "cull.cu").read_text()
    for old, new in K12_EDITS:
        k12 = _edit(k12, old, new)
    (d / "cull.cu").write_text(k12)
    srcs = {"k4w": d / "resample.cu", "k4w pad": d / "pad" / "resample.cu"}
    jobs = {f"K4w {name}": (srcs[src], flags) for name, src, flags in K4W_ABLATIONS}
    jobs.update({f"K12 {name}": (d / "cull.cu", flags) for name, flags in K12_ABLATIONS})
    k4c = (_build.CSRC / "resample.cu").read_text()
    for old, new in K4C_EDITS:
        k4c = _edit(k4c, old, new)
    (d / "this").mkdir(exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, d / "this")
    (d / "this" / "resample.cu").write_text(k4c)
    jobs.update({f"K4c {name}": (d / "this" / "resample.cu", flags)
                 for name, flags in K4C_ABLATIONS})
    return jobs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _k4w_with(f, feat, z, d, n_f, act, third=None):
    """A K4 launch at eval (merge on, u the linspace formed in the kernel)
    with a third output: the other revision's weights instantiation (R, S),
    or with ``third`` = R x T a K4c build's score."""
    r, s = feat.shape
    zo, do = (torch.empty(r, s + n_f, device=feat.device) for _ in range(2))
    w = torch.empty(r, third or s, device=feat.device)

    def run():
        err = f(feat.data_ptr(), z.data_ptr(), d.data_ptr(), None, n_f, pdf._recip(n_f - 1), r,
                s, n_f, 1, act[0], act[1], pdf.ACTIVATIONS.index(act[2]), zo.data_ptr(),
                do.data_ptr(), w.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"resample fwd: cudaError {err}")
        return zo, do, w
    return run


def _k12_with(f, z, cz, cw):
    r, s = z.shape
    score = torch.empty(r, s, device=z.device)

    def run():
        err = f(z.data_ptr(), cz.data_ptr(), cw.data_ptr(), r, s, cz.shape[1], score.data_ptr(),
                _stream())
        if err:
            raise RuntimeError(f"cull_score: cudaError {err}")
        return score
    return run


def _pair_with(k4w, k12, feat, z, d, n_f, act):
    """The other revision's coarse pass: its K4w, then its K12 on K4w's
    output.  Returns (z_vals, dists, score)."""
    first = _k4w_with(k4w, feat, z, d, n_f, act)
    zo, do, w = first()
    second = _k12_with(k12, zo, z, w)

    def run():
        first()
        return zo, do, second()
    return run


def _top_k_with(f, z, d, s, k):
    r, n = z.shape
    zo, do = (torch.empty(r, k, device=z.device) for _ in range(2))

    def run():
        err = f(z.data_ptr(), d.data_ptr(), s.data_ptr(), r, n, k, zo.data_ptr(), do.data_ptr(),
                _stream())
        if err:
            raise RuntimeError(f"top_k: cudaError {err}")
        return zo, do
    return run


def chunk_inputs(cs, dev):
    """K4's arguments on the production render chunk: the coarse pass of
    seeded random weights (rays from the origin, spread over a 2000x1000
    view), as phase 2 of ``chip_smoke.py`` builds them:
    (c_feat, coarse_z, coarse_dists, n_fine, None, True, shift, scale, act)."""
    from ..data.ray_utils import get_ray_directions_360
    from ..models.egonerf import _dists

    model = presets.production_model(device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(cs.SEED))
    dirs = torch.as_tensor(get_ray_directions_360(*cs.IMAGE_HW).reshape(-1, 3), device=dev)
    chunk, n_c, n_f = presets.EVAL_CHUNK, presets.RENDER["n_coarse"], presets.RENDER["n_fine"]
    viewdirs = dirs[torch.arange(chunk, device=dev) * (dirs.shape[0] // chunk)]
    cfg = model.cfg
    with torch.no_grad():
        tables = model.lookup_tables(params)
        z = model.sample_depths_exp(chunk, n_c, dev)
        norm = ops.KERNELS.chart(torch.zeros_like(viewdirs), viewdirs, z, model.coordinates, 2)
        feat = ops.KERNELS.density(norm, tables.coarse_planes, tables.coarse_lines)
    return (feat.reshape(chunk, n_c), z, _dists(z), n_f, None, True, cfg.density_shift,
            cfg.distance_scale, cfg.fea2dense_act)


def _differ(got, want) -> int:
    return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for g, w in zip(got, want))


def check(label, runs: dict, z, d, s, k) -> bool:
    """Each of ``runs`` (name: fn returning (z_out, d_out)) against
    ``select_top_k_plain`` bit for bit; prints one line, returns whether
    all held."""
    want = cull.select_top_k_plain(z, d, s, k)
    ok, parts = True, []
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        diff = _differ(got, want)
        ok = ok and diff == 0
        parts.append(f"{name} {diff} outputs differ")
    print(f"{label}, K={k}: " + "; ".join(parts) + f" -> {'ok' if ok else 'MISS'}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other K4w and K12")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("cull_kernel_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for stem in ("resample", "cull"):
        for name, regs, spill in _build.ptxas_report(stem):
            print(f"ptxas {stem}: {regs} registers, {spill} bytes spilled: {name[:70]}",
                  flush=True)
    jobs = {"other resample": (args.other / "resample.cu", []),
            "other cull": (args.other / "cull.cu", [])}
    if args.ablate:
        jobs.update(_ablations(args.other))
    libs = _build_all(jobs, OUT)
    k4w = _fn(libs["other resample"], "resample_weights_fwd", pdf._WEIGHTS_ARGS)
    k12 = _fn(libs["other cull"], "cull_score", cull._SCORE_ARGS)
    top_k = _fn(libs["other cull"], "top_k", cull._TOP_K_ARGS)

    args_c = chunk_inputs(cs, dev)
    feat, z, d, n_f = args_c[:4]
    act = args_c[6:]
    r, n_c = feat.shape
    n = n_c + n_f
    print(f"chunk: {r} rays x {n_c} coarse + {n_f} fine samples", flush=True)
    if args.ablate:
        _turns(cs, "ablation K4w", {
            name: _k4w_with(_fn(libs[f"K4w {name}"], "resample_weights_fwd", pdf._WEIGHTS_ARGS),
                            feat, z, d, n_f, act)
            for name, _, _ in K4W_ABLATIONS})
        zo, _, w = _k4w_with(k4w, feat, z, d, n_f, act)()
        _turns(cs, "ablation K12", {
            name: _k12_with(_fn(libs[f"K12 {name}"], "cull_score", cull._SCORE_ARGS), zo, z, w)
            for name, _ in K12_ABLATIONS})
        _turns(cs, "ablation K4c", {
            name: _k4w_with(_fn(libs[f"K4c {name}"], "resample_score_fwd", pdf._WEIGHTS_ARGS),
                            feat, z, d, n_f, act, third=n)
            for name, _ in K4C_ABLATIONS})
        # K4c on a part of the chunk's rays: a kernel held by one warp's
        # chain keeps its time as the warps an SM runs fall, one held by the
        # SM's issue or memory rate falls with them
        _turns(cs, "ablation K4c rays", {
            f"{m} rays": (lambda a: lambda: pdf.resample_score(*a))(
                tuple(x[:m].contiguous() if torch.is_tensor(x) else x for x in args_c))
            for m in (r // 8, r // 4, r // 2, r)})

    # the coarse pass: this checkout's one launch against the other's two
    pair = _pair_with(k4w, k12, feat, z, d, n_f, act)
    want = pair()
    got = pdf.resample_score(*args_c)
    torch.cuda.synchronize()
    diff = _differ(got, want)
    ok = diff == 0
    print(f"coarse pass: {diff} of {sum(g.numel() for g in got):,} outputs (z, dists, score) "
          f"of K4c differ from the other K4w + K12's bits -> {'ok' if ok else 'MISS'}",
          flush=True)
    t = _turns(cs, "coarse pass", {"other K4w + K12": pair,
                                   "this K4c": lambda: pdf.resample_score(*args_c)})
    byte_ms = 4 * r * (3 * n_c + 3 * n) / cs.PEAK_BYTES_PER_S * 1e3
    print(f"coarse pass: this K4c {t['this K4c']:.4f} ms (other K4w + K12 "
          f"{t['other K4w + K12']:.4f}, {t['other K4w + K12'] / t['this K4c']:.2f}x); byte "
          f"bound {byte_ms:.4f} ms ({4 * r * (3 * n_c + 3 * n) / 1e6:.1f} MB), this at "
          f"{byte_ms / t['this K4c']:.1%} of it", flush=True)

    z, d, s = got
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    u = torch.rand(r, n, generator=gen, device=dev)
    runs16 = torch.randint(0, 3, (r, -(-n // 16)), generator=gen, device=dev).float() * 0.25
    cases = (("chunk", s), ("tie-break scores", cull.train_tiebreak(s, u)),
             ("long runs of equal scores", runs16.repeat_interleave(16, 1)[:, :n].contiguous()),
             ("all zero", torch.zeros_like(s)))
    for label, sc in cases:
        for k in (*KEEPS, 1, n - 1):
            ok = check(label, {"other": _top_k_with(top_k, z, d, sc, k),
                               "this": lambda: cull.select_top_k(z, d, sc, k)},
                       z, d, sc, k) and ok
    for k in KEEPS:
        t = _turns(cs, f"K13 K={k}", {"other": _top_k_with(top_k, z, d, s, k),
                                      "this": lambda: cull.select_top_k(z, d, s, k)})
        byte_ms = 4 * r * (3 * n + 2 * k) / cs.PEAK_BYTES_PER_S * 1e3
        print(f"K13 K={k}: this {t['this']:.4f} ms (other {t['other']:.4f}, "
              f"{t['other'] / t['this']:.2f}x); byte bound {byte_ms:.4f} ms, this at "
              f"{byte_ms / t['this']:.1%} of it (other {byte_ms / t['other']:.1%})", flush=True)
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("cull_kernel_ab: a kernel disagrees with the other revision's or its plain version "
              "(above)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
