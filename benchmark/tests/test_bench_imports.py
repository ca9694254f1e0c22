"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: each module's top-level name,
the part before the first dot, compared whole (the program's name begins
with the JAX package's)."""
import ast
import subprocess
import sys

import pytest

from benchlib.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "egonerf_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "benchref").glob("*.py")):
        assert not {n for n in top_level_imports(path) if n.startswith("egonerf")}, path


def test_the_run_time_check_compares_whole_names():
    sys.path.insert(0, str(BENCH_DIR))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["egonerf_tpu_extra"] = sys.modules["egonerf_torch_probe"] = sys
        assert run.loaded_forbidden() == [] or "egonerf_tpu" in saved
        sys.modules["jaxlib.xla"] = sys
        assert "jaxlib" in run.loaded_forbidden()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_the_program_path_loads_no_jax():
    """The modules a run imports, in a fresh process: none is JAX's."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from benchlib import cells, readings;"
            "from egonerf_torch.train.trainer import Trainer;"
            "from egonerf_torch.render.renderer import Renderer;"
            "from egonerf_torch.models import build_model;"
            "from egonerf_torch.coords import make_coordinates;"
            "import benchref.egonerf, run;"
            "print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH_DIR), str(ROOT)],
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
