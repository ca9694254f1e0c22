"""The harness finds every cell, configuration, traffic mix, limit file,
metric reader and family from its files, and BENCHMARK.json keeps the
contract's form."""
import json
import re

import pytest

from benchlib import readings
from benchlib.spec import BENCH_DIR, ROOT, families, load_cell, metric_readers

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_contract_form():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = load_cell(name)
    assert cell.mode in ("train", "render")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    readers = metric_readers([m["name"] for m in cell.per_layer])
    assert set(readers) == {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file(name):
    entry = {c["name"]: c for c in SPEC["configs"]}[name]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) == set(cfg["reduced"])
    # every key of the shipped config is run as shipped
    from egonerf_torch.train.config import load_config_chain

    shipped = {}
    for _, values in load_config_chain(str(ROOT / cfg["shipped_config"])):
        shipped.update({k: v for k, v in values.items() if k != "include"})
    for k, v in shipped.items():
        if k not in ("datadir", "basedir", "expname"):
            assert cfg["overrides"].get(k, v) == v, k


def test_every_metric_has_a_reader_that_reads_nothing_without_a_trace():
    class Empty:
        spans, counters, trace = type("S", (), {"s": {}})(), {}, None

    names = [m["name"] for m in SPEC["per_layer"]]
    readers = metric_readers(names)
    cell = load_cell(CELLS[0])
    from benchlib import cells

    for mode in ("train", "render"):
        ctx = readings.Context(mode, Empty, cells.shapes(cell, True), 100, families())
        for name, r in readers.items():
            assert r.read(ctx) is None, name


def test_families_ordered_and_named():
    fams = families()
    assert len({f.NAME for f in fams}) == len(fams) == len(list((BENCH_DIR / "families")
                                                               .glob("*.py")))
    for f in fams:
        re.compile(f.PATTERN)
        assert isinstance(f.LABEL, str) and isinstance(f.KERNEL, bool)
