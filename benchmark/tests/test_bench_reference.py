"""The plain reference against the program's plain path at a size the
CPU holds: its pieces (grid, chart, draws, rays) and a whole run of each
cell through the harness, whose check then reads within the cell's
limits.  These tests import both; the reference imports nothing of the
program."""
import time

import numpy as np
import pytest
import torch

from benchlib import cells, check, scene
from benchref import egonerf as ref
from benchref.philox import sorted_uniform

CELLS = ["indoor-train", "garden-train", "indoor-render", "garden-render"]


def test_grid_and_chart_match_the_program():
    from egonerf_torch.coords import make_coordinates
    from egonerf_torch.ops.chart import chart_fwd_plain

    aabb = scene.scene_aabb(scene.trajectory("omniblender", 5, 3)[1:], 15.0)
    coords = make_coordinates("yinyang", aabb, exp_r=True, N_voxel=27_000_000, r0=0.03,
                              interval_th=True)
    assert coords.resolution == ref.grid_size(27_000_000)
    g = torch.Generator().manual_seed(0)
    o = torch.rand(64, 3, generator=g) - 0.5
    d = torch.nn.functional.normalize(torch.randn(64, 3, generator=g), dim=-1)
    z = torch.rand(64, 33, generator=g) * 15.0
    want = chart_fwd_plain(o, d, z, coords)
    got = ref.Chart(aabb, coords.resolution[0], 0.03, "cpu")(o, d, z)
    assert torch.equal(got[:, 3], want[:, 3])
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


def test_draws_match_the_program():
    from egonerf_torch.ops.merge import sorted_uniform_plain

    for seed, step in ((7, 0), (2 ** 31 - 1, 5)):
        assert torch.equal(sorted_uniform(33, 128, seed, step, "cpu"),
                           sorted_uniform_plain(33, 128, seed, step, "cpu"))


@pytest.mark.parametrize("layout, loader", [("omniblender", "omniblender"),
                                            ("ricoh", "egocentric")])
def test_scene_rays_match_the_loader(tmp_path, layout, loader):
    from egonerf_torch.data.datasets import dataset_class

    scn = scene.write_scene(str(tmp_path), layout, 4, 1, 20, 40, seed=9)
    full = 2000 if layout == "omniblender" else 1920
    ds = dataset_class(loader)(data_dir=str(tmp_path), split="train", downsample=full / 40,
                              near_far=(0.1, 15.0))
    dirs = scene.ray_directions_360(20, 40).reshape(-1, 3)
    rays = np.concatenate([np.concatenate(scene.rays_of(dirs, p), -1)
                           for p in scn.train_poses])
    assert np.abs(ds.all_rays - rays).max() < 1e-5
    assert np.array_equal(ds.all_rgbs, scn.train_pixels().reshape(-1, 3) / np.float32(255))
    assert np.abs(ds.scene_bbox - scene.scene_aabb(scn.train_poses, 15.0)).max() < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small, tmp_path, name):
    cell = small(name)
    run = cells.run_train if cell.mode == "train" else cells.run_render
    res = run(cell, 2 ** 31 + 12345, 0.3, False, torch.device("cpu"), time.perf_counter(),
              str(tmp_path))
    assert res.attempted >= 1 and res.metrics["setup_s"] > 0
    assert set(res.numbers) == set(cell.limits)
    assert check.judge(res.numbers, cell.limits), res.numbers


@pytest.mark.parametrize("name", ["indoor-train", "indoor-render"])
def test_the_float64_witness_runs_beside_the_check(small, tmp_path, name):
    """The witness's float64 reference follows the float32 one (the same
    draws and tables), beside the check's own numbers."""
    from witness import witness

    rep = witness(small(name), 2 ** 31 + 77, torch.device("cpu"), str(tmp_path))
    for pair in ("program_vs_f64", "f32_vs_f64", "tf32_vs_f64"):
        assert all(0 <= v < 1e-3 for v in rep[pair].values()), (pair, rep[pair])
    assert max(rep["f32_vs_f64"].values()) > 0
    assert set(rep["check"]) <= set(rep["program_vs_f32"])
