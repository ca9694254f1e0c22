"""Fixtures of the benchmark's own tests: the benchmark's folder and the
repository's root on the path, the ``card`` marker for tests that need a
CUDA device (they skip without one, decided inside the fixture), and small
cells that the CPU runs through the harness with the program's plain
versions."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 and the kernels exist on the card only")
    return torch.device("cuda", 0)


def small_cell(name: str):
    """The cell ``name`` at a size the CPU holds: an 8,000-voxel grid, 16 +
    16 samples, 256 rays a step or chunk, 40x20 frames (the loaders'
    downsample), a 16-texel envmap; every other key as the cell has it."""
    from benchlib.spec import load_cell

    c = load_cell(name)
    o = c.config["overrides"]
    full_w = c.config["scene"]["width"]
    o.update(N_voxel_init=8000, N_voxel_final=8000, n_coarse=16, n_fine=16, batch_size=256,
             eval_chunk=256, downsample_train=full_w / 40, downsample_test=full_w / 40)
    if o.get("use_envmap"):
        o["envmap_res_H"] = 16 * full_w / 40
    c.config["scene"].update(width=40, height=20)
    c.traffic.update(warmup_steps=1, trace_steps=2, trace_views=1, check_rays=512, max_views=4,
                     control_views=2)
    return c


@pytest.fixture
def small():
    return small_cell
