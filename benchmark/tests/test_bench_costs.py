"""The yardstick's counts at the configs' widths equal the hand counts,
and the kernels' bounds equal those the program's kernel table states."""
import pytest

from benchlib import cells, costs
from benchlib.spec import families, load_cell


@pytest.fixture
def step():
    return cells.shapes(load_cell("indoor-train"), True)


def test_shader_flop(step):
    assert step.n_shader_in == 150 and step.grid == (150, 172, 516)
    assert costs.shader_flop_per_sample(step) == 79_712
    assert costs.gemm_flop(step) == 79_712 * 4096 * 256 * 3  # 2.5075e11
    assert costs.gemm_flop(step) == pytest.approx(2.508e11, rel=1e-3)
    view = cells.shapes(load_cell("indoor-train"), False)
    view.rays = 2000 * 1000
    assert costs.gemm_flop(view) == pytest.approx(4.081e13, rel=1e-3)


def test_model_flop_bounds_the_gemms(step):
    assert costs.gemm_flop(step) < costs.model_flop(step) < 1.1 * costs.gemm_flop(step)


@pytest.mark.parametrize("kernel, bound_ms", [("K1", 0.2013), ("K2", 0.2311), ("K3", 0.0041),
                                              ("K4", 0.0094), ("K6", 0.0075),
                                              ("K6b", 0.0113), ("K7", 0.0032)])
def test_kernel_bounds_match_the_kernel_table(kernel, bound_ms):
    """The eval chunk's bounds in PERF.md's kernel table (K2 and K6b a
    training step's), to its four decimals; K1 in training also writes
    its relu mask."""
    fam = {f.NAME: f for f in families()}[kernel]
    s = cells.shapes(load_cell("indoor-train"), kernel in ("K2", "K6b"))
    assert costs.bound_s(*fam.cost(s)) * 1e3 == pytest.approx(bound_ms, abs=6e-5)


def test_hand_kernels_on_the_paths_have_costs():
    fams = {f.NAME: f for f in families()}
    for k in ("K1", "K2", "K3", "K4", "K6", "K6e", "K6b", "K7", "K8b"):
        assert fams[k].KERNEL and callable(fams[k].cost)
    assert all(callable(f.cost) for f in fams.values() if f.KERNEL)
    for k in ("gemm", "cat", "adam", "fill", "memcpy", "elementwise"):
        assert not fams[k].KERNEL
