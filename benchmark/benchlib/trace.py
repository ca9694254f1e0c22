"""The traced segment of a run: a ``torch.profiler`` window over a fixed
number of steps or views, read from its Chrome trace.

Every device operation (kernel, copy, set) is put in the first family of
``families/`` whose pattern matches its name; the families' device times
sum to the traced device time.  The busy time is the union of the device
intervals, the window the span of every complete event, host and device,
as the program's profile tool computes them.  Idle gaps are labelled by
the benchmark's span and the innermost host operation that cover them.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OTHER = "other"


def family_of(name: str, fams) -> str:
    """The file stem of the first family whose pattern matches ``name``,
    else ``OTHER``."""
    for f in fams:
        if re.search(f.PATTERN, name):
            return f.NAME
    return OTHER


def busy_share(events: list, ops: List[Tuple[str, float, float]]) -> Tuple[float, float]:
    """(union of the device intervals, span of every complete event), us."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
             if e.get("ph") == "X" and "ts" in e]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy, end = 0.0, float("-inf")
    for start, dur in sorted((s, d) for _, s, d in ops):
        lo, hi = max(start, end), start + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy, window


@dataclass
class Trace:
    """What a traced segment of ``units`` steps or views holds."""
    units: int
    busy_s: float
    window_s: float
    family_s: Dict[str, float] = field(default_factory=dict)
    family_launches: Dict[str, int] = field(default_factory=dict)
    other_ops: List[Tuple[str, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _gap_label(mid: float, host: list) -> str:
    """The benchmark's span and the innermost host operation that cover the
    instant ``mid``."""
    span, op = None, None
    for name, cat, start, end in host:
        if start <= mid <= end:
            if cat == "user_annotation" and name.startswith("bench."):
                if span is None or start >= span[1]:
                    span = (name, start)
            elif cat == "cpu_op" and (op is None or start >= op[1]):
                op = (name, start)
    parts = [p[0] for p in (span, op) if p is not None]
    return " > ".join(parts) if parts else "host idle"


def read(events: list, fams, units: int) -> Trace:
    """Bucket and sum a trace's device operations (none raises: the
    benchmark never falls back to host time)."""
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    if not ops:
        raise RuntimeError("the trace holds no device operation: the profiler saw no device time")
    busy, window = busy_share(events, ops)
    fam_s, launches, per_op, other = defaultdict(float), Counter(), Counter(), Counter()
    for name, _, dur in ops:
        fam = family_of(name, fams)
        fam_s[fam] += dur * 1e-6
        launches[fam] += 1
        per_op[name] += dur * 1e-6
        if fam == OTHER:
            other[name] += dur * 1e-6
    host = [(e["name"], e.get("cat"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")]
    gaps, end = [], None
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        if end is not None and start > end:
            gaps.append((end, start))
        end = start + dur if end is None else max(end, start + dur)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [(_gap_label(0.5 * (a + b), host), (b - a) * 1e-6) for a, b in gaps[:10]]
    return Trace(units=units, busy_s=busy * 1e-6, window_s=window * 1e-6, family_s=dict(fam_s),
                 family_launches=dict(launches), other_ops=other.most_common(10),
                 device_ops=per_op.most_common(10), idle_gaps=idle)


def capture(fn: Callable[[], int], fams, device_type: str) -> Trace:
    """Run ``fn`` (which returns the steps or views it ran) under the
    profiler, the device's activity with the host's, and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        units = fn()
        if device_type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read(events, fams, units)
