"""The output check catches a broken timed path: the harness runs a small
cell on the CPU with the program broken underneath and ``correct`` comes
out false, once for each fault the cell can have; and the faults planted
in the reference put in the program's place, which give the render cells'
depth and bg their upper readings, fail the check too.  (One card: no
exchange between chips to leave out.)"""
import time

import pytest
import torch

from benchlib import cells, check, faults


def _run(cell, tmp_path):
    run = cells.run_train if cell.mode == "train" else cells.run_render
    return run(cell, 424242, 0.2, False, torch.device("cpu"), time.perf_counter(),
               str(tmp_path))


@pytest.mark.parametrize("name", ["indoor-train", "garden-train"])
def test_a_step_that_leaves_the_state_unchanged(small, tmp_path, name):
    with faults.unchanged_state():
        res = _run(small(name), tmp_path)
    assert res.numbers["step_gap"] == pytest.approx(1.0)
    assert not check.judge(res.numbers, small(name).limits)


@pytest.mark.parametrize("name", ["indoor-train", "garden-train"])
def test_half_the_batch_left_out(small, tmp_path, name):
    with faults.half_batch():
        res = _run(small(name), tmp_path)
    assert not check.judge(res.numbers, small(name).limits), res.numbers


@pytest.mark.parametrize("name", ["indoor-render", "garden-render"])
def test_an_answer_altered_where_it_is_produced(small, tmp_path, monkeypatch, name):
    from egonerf_torch.ops import volrend

    plain = volrend.composite_plain

    def altered(*args, **kw):
        outs = plain(*args, **kw)
        return (outs[0] * 0.99,) + tuple(outs[1:])

    monkeypatch.setattr(volrend, "composite_plain", altered)
    res = _run(small(name), tmp_path)
    assert max(res.numbers.values()) > 1e-3
    assert not check.judge(res.numbers, small(name).limits)


@pytest.mark.parametrize("name, fault, number", [
    ("indoor-render", "depth-no-background", "depth_gap"),
    ("garden-render", "depth-no-background", "depth_gap"),
    ("garden-render", "envmap-nearest", "bg_gap")])
def test_reference_faults_fail_the_check(small, tmp_path, name, fault, number):
    from control import control_numbers

    cell = small(name)
    nums = control_numbers(cell, 424242, torch.device("cpu"), str(tmp_path), fault)
    assert nums[number] > cell.limits[number], nums
    assert not check.judge(nums, cell.limits)
