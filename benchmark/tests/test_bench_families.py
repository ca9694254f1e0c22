"""The families bucket the device operations of the program's recorded
profiles (the production step and an eval view, docs/torch/) as those
records do, with nothing left in "other"; the trace reader sums, counts
and finds the device's idle time."""
import json

import pytest

from benchlib import trace
from benchlib.spec import ROOT, families

RECORDS = ["results_profile_families.json", "results_profile_eval_families.json"]


@pytest.mark.parametrize("record", RECORDS)
def test_recorded_ops_bucket_as_recorded(record):
    rec = json.loads((ROOT / "docs" / "torch" / record).read_text())
    fams = families()
    label = {f.NAME: f.LABEL for f in fams}
    n = 0
    for row in rec["families"]:
        for op in row["top_ops"]:
            fam = trace.family_of(op["name"], fams)
            assert fam != trace.OTHER, op["name"]
            assert label[fam] == row["family"], op["name"]
            n += 1
    assert n >= 20


def test_read_sums_counts_and_idles():
    fams = families()
    ops = [("void (anonymous namespace)::vm_lookup_kernel<true, true, true, true, true>(f)",
            0.0, 100.0),
           ("void (anonymous namespace)::composite_kernel<false, true, false>(f)", 100.0, 50.0),
           ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 400.0, 100.0),
           ("void at::native::vectorized_elementwise_kernel<4, f>", 450.0, 100.0),
           ("Memcpy DtoH (Device -> Pinned)", 600.0, 10.0)]
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d} for n, t, d in ops]
    events += [{"ph": "X", "cat": "user_annotation", "name": "bench.read_loss", "ts": 150.0,
                "dur": 250.0},
               {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 200.0, "dur": 100.0},
               {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 690.0, "dur": 10.0}]
    tr = trace.read(events, fams, units=2)
    assert tr.family_launches == {"K1": 1, "K6e": 1, "gemm": 1, "elementwise": 1, "memcpy": 1}
    assert tr.family_s["gemm"] == pytest.approx(1e-4)
    assert tr.busy_s == pytest.approx(310e-6) and tr.window_s == pytest.approx(700e-6)
    assert tr.idle_gaps[0] == ("bench.read_loss > aten::item", pytest.approx(250e-6))
    assert tr.idle_gaps[1] == ("host idle", pytest.approx(50e-6))


def test_a_trace_without_device_time_raises():
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.read([{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 1}],
                   families(), 1)
