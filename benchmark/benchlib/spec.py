"""What the harness finds by name: the cells of ``BENCHMARK.json``, each
configuration's file under ``configs/``, each traffic mix's under
``traffic/``, each cell's limits under ``limits/``, each per-layer metric's
reader under ``metrics/`` and each profiler family under ``families/``.
A cell, a metric or a family is added by adding its files."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, prefix: str):
    name = prefix + "_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload: its name, chips, configuration and traffic files, the
    limits of its output check, and the metrics it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _reports(metric: dict, cell_name: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``bench_json`` with everything its files
    say."""
    spec = load_json(bench_json)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, e2e_names)]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(name=name, chips=int(w["chips"]), config=load_json(ROOT / cfg_entry["file"]),
                traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def metric_readers(names: List[str]) -> Dict[str, object]:
    """{name: its reader module} from ``metrics/<name>.py``."""
    return {n: _module(BENCH_DIR / "metrics" / f"{n}.py", "metric") for n in names}


def families() -> list:
    """Every profiler family of ``families/``, in rule order: modules with
    LABEL, PATTERN, ORDER, KERNEL and, for a hand kernel, ``cost``."""
    mods = [_module(p, "family") for p in sorted((BENCH_DIR / "families").glob("*.py"))]
    for m in mods:
        m.NAME = Path(m.__file__).stem
    return sorted(mods, key=lambda m: (m.ORDER, m.NAME))
