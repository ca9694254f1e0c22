"""K10's forward, weight gradient (db) and input gradient (da) of this
checkout against another revision's, on one CUDA card, at every shape that
``chip_smoke.py``'s phase 2 records under MIXED_MM (random operands from a
seed).

    python -m egonerf_torch.tools.mm_ab --other DIR [--ablate]

run from the repository root.  DIR holds the other revision's
``mixed_mm.cu`` (its ``egonerf_torch/csrc`` from ``git archive``), whose C
entry points take the argument lists of ``OTHER_FWD_ARGS``,
``OTHER_DB_ARGS`` and ``OTHER_ROWS_ARGS`` (the forward with its layout
index, db with its stage count and warp layout, da's ``mixed_mm_rows``
with b^T at element strides).

First this checkout's forward (and the other's) is held to its plain
version bit for bit, its db to the exact product (float64) within
``chip_smoke.K2_TOL`` of sum|terms|, equal to itself over two calls, and
its da (and the other's) to the exact product within ``chip_smoke.MM_TOL``
of sum|terms|, also at ``chip_smoke.MM_ODD_ROWS`` rows; a miss is printed
and makes the exit code 1 after the timings.  Then each shape's forward,
db and da are timed by ``chip_smoke.time_ms`` in turns (other, this,
this, other) on the same inputs, beside the byte bound, the float32 fma
floor at the SM clock that ``nvidia-smi`` reads under load, and the
PyTorch call that computes the same function (``chip_smoke.mm_library``;
with and without the casts of the float32 operands).  ``--ablate`` first
times the other da at l1 as it is, with its mma instructions compiled out
(loads, rounding and stores only), with its final stores compiled out,
and with its loads of dout replaced by a constant: text edits of the
other source (the outputs are wrong); the tool stops where an edit does
not apply.  Prints one line a measurement and the card's name and power
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
# shapes at the production chunk (4096 rays x 256 samples); every one but
# the hoist's ray term (whose input carries no gradient) has a da
SHAPES = (("l1", 1 << 20, 150, 128, True), ("l2", 1 << 20, 128, 128, True),
          ("l3", 1 << 20, 128, 3, True), ("basis", 1 << 20, 144, 54, False),
          ("hoist", 1 << 20, 135, 128, True), ("ray term", 4096, 15, 128, True))
NO_DA = ("ray term",)
SEED = 0
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OTHER_ROWS_ARGS = [_P, _L, _I, _P, _L, _L, _I, _P, _P]
OTHER_FWD_ARGS = OTHER_ROWS_ARGS[:7] + [_I] + OTHER_ROWS_ARGS[7:]
OTHER_DB_ARGS = [_P, _P, _L, _I, _I, _L, _I, _I, _P, _P, _P]
DA_ABLATIONS = ("da as it is", "da no mma", "da no stores", "da constant loads")


def _ablations(other: Path) -> dict:
    """{name: (source, flags)}: the other da (mm_rows_kernel) as it is,
    without its mma instructions, without its final stores, and with its
    loads of dout replaced by a constant."""
    src = (other / "mixed_mm.cu").read_text()
    src = _edit(src, "          mma_bf16(acc[j], fa, fb);\n",
                "#ifndef NO_MMA\n          mma_bf16(acc[j], fa, fb);\n#endif\n")
    src = _edit(src, "          const long long r = r0 + 8 * h;\n          if (r < m && col < n) {\n",
                "          const long long r = r0 + 8 * h;\n#ifdef NO_STORE\n"
                "          if (r < 0 && col < n) {\n#else\n"
                "          if (r < m && col < n) {\n#endif\n")
    src = _edit(src, "      pa[e] = (r < m && kk < k) ? __ldg(a + r * k + kk) : 0.0f;\n",
                "#ifdef CONST_LOAD\n      pa[e] = (r < m && kk < k) ? 1.0f : 0.0f;\n#else\n"
                "      pa[e] = (r < m && kk < k) ? __ldg(a + r * k + kk) : 0.0f;\n#endif\n")
    d = OUT / "ablate"
    d.mkdir(parents=True, exist_ok=True)
    (d / "mixed_mm.cu").write_text(src)
    return dict(zip(DA_ABLATIONS, ((d / "mixed_mm.cu", flags) for flags in
                                   ([], ["-DNO_MMA"], ["-DNO_STORE"], ["-DCONST_LOAD"]))))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _other_fwd(f, a, b):
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty(m, n, device=a.device)
    layout = mm.FWD_LAYOUTS.index(mm.fwd_layout(k, n))

    def run():
        err = f(a.data_ptr(), m, k, b.data_ptr(), b.stride(0), b.stride(1), n, layout,
                c.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"mixed_mm_fwd: cudaError {err}")
        return c
    return run


def _other_db(f, a, d):
    """The other revision's db with this checkout's row ranges and stages."""
    m, k = a.shape
    n = d.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    per_block, splits = mm.db_row_ranges(m, sms, mm.db_groups(k, n))
    part = torch.empty(splits, k, n, device=a.device)
    out = torch.empty(k, n, device=a.device)
    stages, narrow = mm.db_stages(k, n), int(mm.db_layout(n) == "narrow")

    def run():
        err = f(a.data_ptr(), d.data_ptr(), m, k, n, per_block, stages, narrow, part.data_ptr(),
                out.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"mixed_mm_db: cudaError {err}")
        return out
    return run


def _other_da(f, d, b):
    """The other revision's da: its rows layout on (dout, b^T)."""
    m, n = d.shape
    bt = b.t()
    k = bt.shape[1]
    c = torch.empty(m, k, device=d.device)

    def run():
        err = f(d.data_ptr(), m, n, bt.data_ptr(), bt.stride(0), bt.stride(1), k, c.data_ptr(),
                _stream())
        if err:
            raise RuntimeError(f"mixed_mm_rows: cudaError {err}")
        return c
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


def share_of_terms(got, x, y) -> float:
    """max over elements of |got - x16 @ y16| / (|x16| @ |y16|), the bf16
    operands' exact product in float64."""
    x64, y64 = x.to(torch.bfloat16).double(), y.to(torch.bfloat16).double()
    return float(((got.double() - x64 @ y64).abs() / (x64.abs() @ y64.abs() + 1e-30)).max())


def check(cs, label, a, b, d, other_fwd, other_da) -> bool:
    """This checkout's forward against its plain version (bit for bit; the
    other revision's too), db against the exact product (K2_TOL of
    sum|terms|, equal over two calls) and da (this and the other's, also at
    MM_ODD_ROWS rows) against the exact product (MM_TOL of sum|terms|).
    Prints what differs; returns whether everything held."""
    with torch.no_grad():
        got, ref, old = mm.mixed_mm(a, b), mm.mixed_mm_plain(a, b), other_fwd()
        diff = got != ref
        db1, db2 = mm.mixed_mm_db(a, d), mm.mixed_mm_db(a, d)
        db_share = share_of_terms(db1, a.t(), d)
    torch.cuda.synchronize()
    same = not bool(diff.any())
    where = ""
    if not same:
        rows, cols = diff.nonzero(as_tuple=True)
        where = (f" ({int(diff.sum())} outputs differ, max abs {float((got - ref).abs().max()):.3e},"
                 f" rows {int(rows.min())}..{int(rows.max())}, columns {int(cols.min())}.."
                 f"{int(cols.max())}; the other forward equal to the plain version: "
                 f"{torch.equal(old, ref)})")
    del got, ref, old, diff
    ok = same and db_share <= cs.K2_TOL and torch.equal(db1, db2)
    line = (f"{label}: forward equal to its plain version bit for bit: {same}{where}; db per "
            f"element {db_share:.3e} of sum|terms| (<= {cs.K2_TOL:.0e}), equal over two calls: "
            f"{torch.equal(db1, db2)}")
    if other_da is not None:
        with torch.no_grad():
            shares = {"this": share_of_terms(mm.mixed_mm_da(d, b), d, b.t()),
                      "other": share_of_terms(other_da(), d, b.t())}
            for m in cs.MM_ODD_ROWS:
                shares[f"this at {m} rows"] = share_of_terms(mm.mixed_mm_da(d[:m], b), d[:m],
                                                             b.t())
        torch.cuda.synchronize()
        ok = ok and max(shares.values()) <= cs.MM_TOL
        line += "; da per element of sum|terms| (<= {:.0e}): ".format(cs.MM_TOL) + ", ".join(
            f"{n} {v:.3e}" for n, v in shares.items())
    print(f"{line} -> {'ok' if ok else 'MISS'}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's egonerf_torch/csrc")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated builds of the other da at l1")
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
    other_rows = _fn(libs["other"], "mixed_mm_rows", OTHER_ROWS_ARGS)
    lib_label, lib_call = cs.mm_library()
    print(f"library call: {lib_label}", flush=True)
    ok = True

    for label, m, k, n, transposed in SHAPES:
        a, b, d = _inputs(m, k, n, transposed, dev)
        has_da = label not in NO_DA
        ok = check(cs, label, a, b, d, _other_fwd(other_fwd, a, b),
                   _other_da(other_rows, d, b) if has_da else None) and ok
        if args.ablate and label == "l1":
            _turns(cs, f"ablation da {label}", {
                name: _other_da(_fn(libs[name], "mixed_mm_rows", OTHER_ROWS_ARGS), d, b)
                for name in DA_ABLATIONS})
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
        if has_da:
            da = _turns(cs, f"da {label} ({m}x{n} @ {n}x{k})", {
                "other": _other_da(other_rows, d, b), "this": lambda: mm.mixed_mm_da(d, b)})
            bt = b.t()
            lib_da = cs.time_ms(lambda: lib_call(d16, bt16.t()))
            lib_da_casts = cs.time_ms(lambda: lib_call(d.to(torch.bfloat16),
                                                       bt.to(torch.bfloat16)))
            print(f"{label}: da this {da['this']:.4f} ms (other {da['other']:.4f}, "
                  f"{da['other'] / da['this']:.2f}x); byte bound {byte_ms:.4f} ms, this at "
                  f"{byte_ms / da['this']:.1%} of it; library da {lib_da:.4f} "
                  f"({lib_da_casts:.4f} with the casts), this {lib_da / da['this']:.2f}x its "
                  "rate", flush=True)
        del a, b, d, a16, bt16, at16, d16
        torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}", flush=True)
    if not ok:
        print("mm_ab: this checkout's K10 disagrees (above)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
