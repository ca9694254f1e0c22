"""K13 (the cull's top-K compaction) of this checkout against another
revision's, on one CUDA card, on the production render chunk (4096 rays x
256 merged samples, scores from K12 on seeded random weights, as
``chip_smoke.py``'s phase 2 makes them) at K = 192 and 128.

    python -m egonerf_torch.tools.cull_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's ``cull.cu``
(its ``egonerf_torch/csrc`` from ``git archive``), whose ``top_k`` takes
the same arguments as this checkout's.

Both kernels are first held to ``select_top_k_plain`` bit for bit on the
chunk's scores and on three harder score sets (the training tie-break,
long runs of equal scores, all zero); a miss is printed and makes the exit
code 1 after the timings.  Then each K is timed by ``chip_smoke.time_ms``
in turns (other, this, this, other) on the same inputs, beside the byte
bound (z, dists and the score read once, the kept z and dists written
once).  ``--ablate`` first times the other kernel and this checkout's as
they are, with the selection of T (the bitwise select: 32 steps in the
other, stopping early in this one) replaced by a fixed threshold (T = 0: every sample
above it, the first K stored), with their stores removed (the other's
also drop the z and dists reads that feed them), and as an empty launch
of the same grid: text edits of the two sources (``PARENT_EDITS``, which
fit the radix-select kernel, and ``THIS_EDITS``; the outputs are wrong);
the tool stops where an edit does not apply.  Prints one line a
measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import _build, ops, presets
from ..ops import cull
from .resample_ab import _build_all, _edit, _fn, _turns

OUT = _build.BUILD_ROOT.parent / "cull_ab"
KEEPS = (192, 128)
# text edits of each revision's top_k_kernel: an empty launch (EMPTY), T
# fixed at 0 so every sample is above it and the first K are stored
# (FIXED_T), no stores (NO_STORE)
PARENT_EDITS = (
    ("  if (ray >= R) return;\n  const int per = (S + 31) / 32;\n",
     "#ifdef EMPTY\n  return;\n#endif\n  if (ray >= R) return;\n  const int per = (S + 31) / 32;\n"),
    ("  unsigned T = 0u;\n  for (int bit = 31; bit >= 0; --bit) {\n",
     "  unsigned T = 0u;\n#ifndef FIXED_T\n  for (int bit = 31; bit >= 0; --bit) {\n"),
    ("    if (warp_sum(cnt) >= K) T = cand;\n  }\n",
     "    if (warp_sum(cnt) >= K) T = cand;\n  }\n#endif\n"),
    ("  for (int t = 0; t < n; ++t) {\n    if (kept >> t & 1u) {\n",
     "#ifdef NO_STORE\n  if (slot + (int)kept == -7) z_out[0] = (float)T;\n"
     "  for (int t = 0; t < 0; ++t) {\n#else\n  for (int t = 0; t < n; ++t) {\n#endif\n"
     "#ifdef FIXED_T\n    if ((kept >> t & 1u) && slot < K) {\n#else\n"
     "    if (kept >> t & 1u) {\n#endif\n"))
THIS_EDITS = (
    ("  if (ray >= R) return;\n  const int rows = (S + 31) / 32;\n",
     "#ifdef EMPTY\n  return;\n#endif\n  if (ray >= R) return;\n  const int rows = (S + 31) / 32;\n"),
    ("  for (int bit = 31; bit >= 0 && ge != K; --bit) {\n",
     "#ifndef FIXED_T\n  for (int bit = 31; bit >= 0 && ge != K; --bit) {\n"),
    ("      ge = cnt;\n    }\n  }\n", "      ge = cnt;\n    }\n  }\n#endif\n"),
    ("        z_out[o] = zv[t];\n        d_out[o] = dv[t];\n",
     "#if defined(NO_STORE)\n        if (o == -7) z_out[0] = zv[t] + dv[t];\n"
     "#elif defined(FIXED_T)\n        if (o < K) {\n          z_out[o] = zv[t];\n"
     "          d_out[o] = dv[t];\n        }\n#else\n"
     "        z_out[o] = zv[t];\n        d_out[o] = dv[t];\n#endif\n"))
ABLATIONS = (("as it is", []), ("fixed T", ["-DFIXED_T"]), ("no stores", ["-DNO_STORE"]),
             ("empty launch", ["-DEMPTY"]))


def _ablations(tag: str, src_dir: Path, edits) -> dict:
    """{f"{tag} {name}": (source, flags)}: the K13 of ``src_dir`` as it is,
    with a fixed threshold in place of its selection, without its stores,
    and empty."""
    src = (src_dir / "cull.cu").read_text()
    for old, new in edits:
        src = _edit(src, old, new)
    d = OUT / f"ablate_{tag}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "cull.cu").write_text(src)
    return {f"{tag} {name}": (d / "cull.cu", flags) for name, flags in ABLATIONS}


def _stream():
    return torch.cuda.current_stream().cuda_stream


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
    """(z_vals, dists, score) of the production render chunk: the coarse
    pass of seeded random weights (rays from the origin, spread over a
    2000x1000 view), K4's weights instantiation and K12, as phase 2 of
    ``chip_smoke.py`` builds them."""
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
        z_vals, dists, w = ops.KERNELS.resample_weights(
            feat.reshape(chunk, n_c), z, _dists(z), n_f, None, True, cfg.density_shift,
            cfg.distance_scale, cfg.fea2dense_act)
        score = ops.KERNELS.coarse_importance(z_vals, z, w)
    return z_vals, dists, score


def check(label, runs: dict, z, d, s, k) -> bool:
    """Each of ``runs`` (name: fn returning (z_out, d_out)) against
    ``select_top_k_plain`` bit for bit; prints one line, returns whether
    all held."""
    want = cull.select_top_k_plain(z, d, s, k)
    ok, parts = True, []
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        diff = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                   for g, w in zip(got, want))
        ok = ok and diff == 0
        parts.append(f"{name} {diff} outputs differ")
    print(f"{label}, K={k}: " + "; ".join(parts) + f" -> {'ok' if ok else 'MISS'}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other K13 and of this one")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("cull_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for name, regs, spill in _build.ptxas_report("cull"):
        print(f"ptxas cull: {regs} registers, {spill} bytes spilled: {name[:70]}", flush=True)
    jobs = {"other": (args.other / "cull.cu", [])}
    if args.ablate:
        jobs.update(_ablations("other", args.other, PARENT_EDITS))
        jobs.update(_ablations("this", _build.CSRC, THIS_EDITS))
    libs = _build_all(jobs, OUT)
    other = _fn(libs["other"], "top_k", cull._TOP_K_ARGS)

    z, d, s = chunk_inputs(cs, dev)
    r, n = z.shape
    print(f"chunk: {r} rays x {n} merged samples, {int((s == 0).sum()):,} of {s.numel():,} "
          "scores 0", flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    u = torch.rand(r, n, generator=gen, device=dev)
    runs16 = torch.randint(0, 3, (r, -(-n // 16)), generator=gen, device=dev).float() * 0.25
    cases = (("chunk", s), ("tie-break scores", cull.train_tiebreak(s, u)),
             ("long runs of equal scores", runs16.repeat_interleave(16, 1)[:, :n].contiguous()),
             ("all zero", torch.zeros_like(s)))
    ok = True
    for label, sc in cases:
        for k in (*KEEPS, 1, n - 1):
            ok = check(label, {"other": _top_k_with(other, z, d, sc, k),
                               "this": lambda: cull.select_top_k(z, d, sc, k)},
                       z, d, sc, k) and ok

    for k in KEEPS:
        if args.ablate:
            for tag in ("other", "this"):
                _turns(cs, f"ablation K13 K={k}", {
                    f"{tag} {name}": _top_k_with(_fn(libs[f"{tag} {name}"], "top_k",
                                                     cull._TOP_K_ARGS), z, d, s, k)
                    for name, _ in ABLATIONS})
        t = _turns(cs, f"K13 K={k}", {"other": _top_k_with(other, z, d, s, k),
                                      "this": lambda: cull.select_top_k(z, d, s, k)})
        byte_ms = 4 * r * (3 * n + 2 * k) / cs.PEAK_BYTES_PER_S * 1e3
        print(f"K13 K={k}: this {t['this']:.4f} ms (other {t['other']:.4f}, "
              f"{t['other'] / t['this']:.2f}x); byte bound {byte_ms:.4f} ms, this at "
              f"{byte_ms / t['this']:.1%} of it (other {byte_ms / t['other']:.1%})", flush=True)
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("cull_ab: a K13 disagrees with its plain version (above)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
