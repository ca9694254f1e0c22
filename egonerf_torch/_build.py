"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface, and loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

All sources compile in parallel at first use, into
``build/egonerf_torch/<hash>/`` beside the package (``.gitignore`` lists
``build/``); the hash covers the sources and the flags, so an edit rebuilds.
Each library's compiler output is kept beside it (``lib<name>.log``): ptxas
reports every kernel's registers and spills there (:func:`ptxas_report`).
Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check_launch` raises on anything but 0.
A CUDA machine without ``nvcc`` is an error, not a fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "egonerf_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "egonerf_torch kernels are built from csrc/ at first use")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {stem: path of the shared library}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources()}
    todo = [(src, libs[src.stem]) for src in sources() if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    try:
        for src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs.append((src, lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, lib, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                lib.with_suffix(".log").write_text(log)
                os.replace(tmp, lib)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return libs


def ptxas_report(stem: str) -> list:
    """[(kernel, registers, spilled bytes)] for every kernel of
    ``lib<stem>.so`` from its build log, demangled where ``c++filt`` is
    found; spilled bytes are the spill stores plus the spill loads."""
    log = (build_dir() / f"lib{stem}.log").read_text()
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    filt = shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            rows = [(n, regs, sp) for n, (_, regs, sp) in zip(out, rows)]
    return rows


def kernel(stem: str, fn: str, argtypes: list):
    """The C entry point ``fn`` of ``lib<stem>.so`` with its argument types
    declared; builds the libraries at first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no kernel source csrc/{stem}.cu")
            lib = _libs[stem] = ctypes.CDLL(str(paths[stem]))
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
