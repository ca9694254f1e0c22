"""K10's forward and weight gradient (db) of this checkout against another
revision's, on one CUDA card, at every shape that ``chip_smoke.py``'s
phase 2 records under MIXED_MM (random operands from a seed).

    python -m egonerf_torch.tools.mm_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's
``mixed_mm.cu`` (its ``egonerf_torch/csrc`` from ``git archive``), whose
``mixed_mm_fwd`` takes the earlier argument list (no layout index) and
whose ``mixed_mm_db`` takes rows_per_block without a stage count.

First this checkout's forward (and the other's) is held to its plain
version bit for bit and its db to the exact product (float64) within
``chip_smoke.K2_TOL`` of sum|terms|, equal to itself over two calls; a
miss is printed and makes the exit code 1 after the timings.  Then each
shape's forward and db are timed by ``chip_smoke.time_ms`` in turns
(other, this, this, other) on the same inputs, beside the byte bound,
the float32 fma floor at the SM clock that ``nvidia-smi`` reads under
load, and the PyTorch call that computes the same function
(``chip_smoke.mm_library``; with and without the casts of the float32
operands).  ``--ablate`` first times the other db as it is, with
one tile group in place of its two (l1, the hoist) and with its mma
removed (the staging alone): text edits of the other source (the outputs
are wrong).  Prints one line a measurement and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from .. import _build
from ..ops import mm
from .resample_ab import _build_all, _edit, _fn, _turns

OUT = _build.BUILD_ROOT.parent / "mm_ab"
# (name, M, K, N, b as a weight's transpose): chip_smoke phase 2's K10
# shapes at the production chunk (4096 rays x 256 samples)
SHAPES = (("l1", 1 << 20, 150, 128, True), ("l2", 1 << 20, 128, 128, True),
          ("l3", 1 << 20, 128, 3, True), ("basis", 1 << 20, 144, 54, False),
          ("hoist", 1 << 20, 135, 128, True), ("ray term", 4096, 15, 128, True))
SEED = 0
OTHER_FWD_ARGS = mm._ROWS_ARGS
OTHER_DB_ARGS = mm._DB_ARGS[:6] + mm._DB_ARGS[8:]


def _ablations(other: Path) -> dict:
    """{name: (source, flags)}: the other db as it is, with one tile group
    (a warp's tiles up to 20), and without its mma."""
    src = (other / "mixed_mm.cu").read_text()
    src = _edit(src, "  const int groups = (tiles + 127) / 128;\n",
                "#ifdef ONE_GROUP\n  const int groups = 1;\n#else\n"
                "  const int groups = (tiles + 127) / 128;\n#endif\n")
    src = _edit(src, "  } else {\n    launch_db<16>(", "  } else if (per_warp > 16) {\n"
                "    launch_db<20>(grid, smem, st, a, d, m, k, n, rows_per_block, per_warp, part);\n"
                "  } else {\n    launch_db<16>(")
    fb = "          ldmatrix_x2_trans(fb, ds + (ks + mrow + 8 * (mat & 1)) * ld_d + 8 * ni);\n"
    src = _edit(src, fb + "          mma_bf16(acc[j], fa, fb);\n",
                fb + "#ifndef NO_MMA\n          mma_bf16(acc[j], fa, fb);\n#endif\n")
    d = OUT / "ablate"
    d.mkdir(parents=True, exist_ok=True)
    (d / "mixed_mm.cu").write_text(src)
    return {"db as it is": (d / "mixed_mm.cu", []),
            "db one group": (d / "mixed_mm.cu", ["-DONE_GROUP"]),
            "db no mma": (d / "mixed_mm.cu", ["-DNO_MMA"])}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _other_fwd(f, a, b):
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty(m, n, device=a.device)

    def run():
        err = f(a.data_ptr(), m, k, b.data_ptr(), b.stride(0), b.stride(1), n, c.data_ptr(),
                _stream())
        if err:
            raise RuntimeError(f"mixed_mm_fwd: cudaError {err}")
        return c
    return run


def _other_db(f, a, d):
    """The other revision's db with its own row ranges (two blocks an SM)."""
    m, k = a.shape
    n = d.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    per_block = max(32, -(-m // (2 * sms)))
    part = torch.empty(-(-m // per_block), k, n, device=a.device)
    out = torch.empty(k, n, device=a.device)

    def run():
        err = f(a.data_ptr(), d.data_ptr(), m, k, n, per_block, part.data_ptr(), out.data_ptr(),
                _stream())
        if err:
            raise RuntimeError(f"mixed_mm_db: cudaError {err}")
        return out
    return run


def _inputs(m, k, n, transposed, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(n, k, generator=g, device=dev) / k ** 0.5
    b = w.t() if transposed else w.t().contiguous()
    d = torch.randn(m, n, generator=g, device=dev)
    return a, b, d


def sm_clock_under_load(run, calls: int = 400) -> str:
    """``nvidia-smi``'s SM clock (MHz) while ``calls`` runs of ``run`` are
    queued on the card."""
    torch.cuda.synchronize()
    for _ in range(calls):
        run()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return out


def check(cs, label, a, b, d, other_fwd) -> bool:
    """This checkout's forward against its plain version (bit for bit; the
    other revision's too) and db against the exact product (K2_TOL of
    sum|terms|, equal over two calls).  Prints what differs; returns
    whether everything held."""
    with torch.no_grad():
        got, ref, old = mm.mixed_mm(a, b), mm.mixed_mm_plain(a, b), other_fwd()
        diff = got != ref
        db1, db2 = mm.mixed_mm_db(a, d), mm.mixed_mm_db(a, d)
        a16, d16 = a.to(torch.bfloat16).double(), d.to(torch.bfloat16).double()
        share = float(((db1.double() - a16.t() @ d16).abs()
                       / (a16.abs().t() @ d16.abs() + 1e-30)).max())
    torch.cuda.synchronize()
    same = not bool(diff.any())
    where = ""
    if not same:
        rows, cols = diff.nonzero(as_tuple=True)
        where = (f" ({int(diff.sum())} outputs differ, max abs {float((got - ref).abs().max()):.3e},"
                 f" rows {int(rows.min())}..{int(rows.max())}, columns {int(cols.min())}.."
                 f"{int(cols.max())}; the other forward equal to the plain version: "
                 f"{torch.equal(old, ref)})")
    ok = same and share <= cs.K2_TOL and torch.equal(db1, db2)
    print(f"{label}: forward equal to its plain version bit for bit: {same}{where}; db per "
          f"element {share:.3e} of sum|terms| (<= {cs.K2_TOL:.0e}), equal over two calls: "
          f"{torch.equal(db1, db2)} -> {'ok' if ok else 'MISS'}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other db")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("mm_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    _build.build_all()
    for name, regs, spill in _build.ptxas_report("mixed_mm"):
        print(f"ptxas mixed_mm: {regs} registers, {spill} bytes spilled: {name[:70]}", flush=True)
    jobs = {"other": (args.other / "mixed_mm.cu", [])}
    if args.ablate:
        jobs.update(_ablations(args.other))
    libs = _build_all(jobs, OUT)
    other_fwd = _fn(libs["other"], "mixed_mm_fwd", OTHER_FWD_ARGS)
    other_db = _fn(libs["other"], "mixed_mm_db", OTHER_DB_ARGS)
    lib_label, lib_call = cs.mm_library()
    print(f"library call: {lib_label}", flush=True)
    ok = True

    for label, m, k, n, transposed in SHAPES:
        a, b, d = _inputs(m, k, n, transposed, dev)
        ok = check(cs, label, a, b, d, _other_fwd(other_fwd, a, b)) and ok
        if args.ablate and label in ("l1", "hoist"):
            _turns(cs, f"ablation db {label}", {
                name: _other_db(_fn(libs[name], "mixed_mm_db", OTHER_DB_ARGS), a, d)
                for name in ("db as it is", "db one group", "db no mma")})
        a16, bt16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        at16, d16 = a16.t(), d.to(torch.bfloat16)
        fwd = _turns(cs, f"fwd {label} ({m}x{k} @ {k}x{n})", {
            "other": _other_fwd(other_fwd, a, b), "this": lambda: mm.mixed_mm(a, b)})
        db = _turns(cs, f"db {label} ({k}x{m} @ {m}x{n})", {
            "other": _other_db(other_db, a, d), "this": lambda: mm.mixed_mm_db(a, d)})
        lib = {"fwd": cs.time_ms(lambda: lib_call(a16, bt16)),
               "fwd with casts": cs.time_ms(lambda: lib_call(a.to(torch.bfloat16),
                                                             b.to(torch.bfloat16))),
               "db": cs.time_ms(lambda: lib_call(at16, d16)),
               "db with casts": cs.time_ms(lambda: lib_call(a.to(torch.bfloat16).t(),
                                                            d.to(torch.bfloat16)))}
        clock = sm_clock_under_load(lambda: mm.mixed_mm(a, b))
        mhz = float(clock.split(",")[0])
        fma_ms = m * k * n / (132 * 128 * mhz * 1e6) * 1e3
        byte_ms = 4 * (m * k + k * n + m * n) / cs.PEAK_BYTES_PER_S * 1e3
        print(f"{label}: fwd this {fwd['this']:.4f} ms (other {fwd['other']:.4f}, "
              f"{fwd['other'] / fwd['this']:.2f}x); db this {db['this']:.4f} ms (other "
              f"{db['other']:.4f}, {db['other'] / db['this']:.2f}x); byte bound "
              f"{byte_ms:.4f} ms; fma floor {fma_ms:.4f} ms at {mhz:.0f} MHz (nvidia-smi "
              f"clocks.sm, clocks.max.sm: {clock}); library fwd {lib['fwd']:.4f} "
              f"({lib['fwd with casts']:.4f} with the casts), db {lib['db']:.4f} "
              f"({lib['db with casts']:.4f} with the casts)", flush=True)
        del a, b, d, a16, bt16, at16, d16
        torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("mm_ab: this checkout's K10 disagrees (above)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
