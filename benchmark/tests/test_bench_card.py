"""On the card: the harness's sound run at a small size passes its check
through the kernels; at each cell's own size the check's control (the
reference in TF32 in the program's place) and each planted fault fail it
on three seeds.  PERF.md gives the readings, from ``benchmark/control.py``
and the benchmark's own runs."""
import time

import pytest

from benchlib import cells, check
from benchlib.spec import load_cell

CELLS = ["indoor-train", "garden-train", "indoor-render", "garden-render"]
# indoor-train's check does not separate TF32: float32's own noise on that
# configuration reaches the control's size on every number (PERF.md section 2)
CONTROLLED = ["garden-train", "indoor-render", "garden-render"]
FAULTS = [("indoor-train", "half-batch"), ("garden-train", "half-batch"),
          ("indoor-render", "depth-no-background"), ("garden-render", "depth-no-background"),
          ("garden-render", "envmap-nearest")]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_on_the_card(card, small, tmp_path, name):
    cell = small(name)
    run = cells.run_train if cell.mode == "train" else cells.run_render
    res = run(cell, 31337, 0.5, False, card, time.perf_counter(), str(tmp_path))
    assert check.judge(res.numbers, cell.limits), res.numbers


@pytest.mark.card
@pytest.mark.parametrize("name", CONTROLLED)
def test_control_fails_the_check(card, tmp_path, name):
    from control import control_numbers

    cell = load_cell(name)
    for seed in (1, 2, 3):
        nums = control_numbers(cell, seed, card, str(tmp_path))
        assert not check.judge(nums, cell.limits), (seed, nums)


@pytest.mark.card
@pytest.mark.parametrize("name, fault", FAULTS)
def test_fault_fails_the_check(card, tmp_path, name, fault):
    from control import control_numbers

    cell = load_cell(name)
    for seed in (1, 2, 3):
        nums = control_numbers(cell, seed, card, str(tmp_path), fault)
        assert not check.judge(nums, cell.limits), (seed, nums)
