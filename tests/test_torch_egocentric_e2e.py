"""The captured-data path of the port on a synthesised Ricoh-style capture:
the port's capture writer against JAX's (pose files byte for byte, PNG
pixels equal), and the port's trainer on the capture with the
theta-importance sampler (``dataset_name = egocentric``, roi [0.05, 0.95,
0, 1]) against JAX's trainer: the same datasets bit for bit, the same host
ids under ``device_sampling = False``, and an MSE that falls."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from egonerf_torch.data.samplers import DeviceThetaSampler, HostRaySampler
from egonerf_torch.ops import sampler
from egonerf_torch.tools.make_egocentric_capture import make_capture
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer
from egonerf_tpu.tools.make_egocentric_capture import make_capture as jax_make_capture

H, W = 60, 120  # on-disk equirect size; downsample maps 1920x960 onto it
DOWNSAMPLE = 1920 / W
ROI = [0.05, 0.95, 0.0, 1.0]
POSE_FILES = (("output_dir", "colmap", "images.txt"),
              ("openvslam", "frame_trajectory_with_file_name.txt"), ("train.txt",),
              ("test.txt",))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    port = str(tmp_path_factory.mktemp("port_capture"))
    jax = str(tmp_path_factory.mktemp("jax_capture"))
    poses = make_capture(port, n_frames=6, height=H, n_test=2, seed=3)
    jax_poses = jax_make_capture(jax, n_frames=6, height=H, n_test=2, seed=3)
    return port, jax, poses, jax_poses


def test_capture_writer_equals_jax(captures):
    port, jax, poses, jax_poses = captures
    np.testing.assert_array_equal(poses, jax_poses)
    for parts in POSE_FILES:
        with open(os.path.join(port, *parts), "rb") as a, open(os.path.join(jax, *parts),
                                                               "rb") as b:
            assert a.read() == b.read(), parts
    names = sorted(os.listdir(os.path.join(jax, "imgs")))
    assert names == sorted(os.listdir(os.path.join(port, "imgs"))) and len(names) == 6
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(port, "imgs", name))),
                                      np.asarray(Image.open(os.path.join(jax, "imgs", name))))


def _cfg(datadir, tmp_path, **over):
    base = dict(
        dataset_name="egocentric", datadir=datadir, model_name="EgoNeRF",
        coordinates_name="yinyang", exp_sampling=True, interval_th=True, r0="0.05",
        resampling=True, use_coarse_sample=True, downsample_train=DOWNSAMPLE,
        downsample_test=DOWNSAMPLE, roi=str(ROI), localization_method="colmap",
        sampling_method="theta_importance", theta_importance_lambda=4.0, n_coarse=16,
        n_fine=16, batch_size=256, n_iters=40, N_voxel_init=24 ** 3, N_voxel_final=24 ** 3,
        n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
        shadingMode="MLP_Fea", fea2denseAct="softplus", density_shift="-8", featureC=32,
        view_pe=2, fea_pe=2, lr_init=0.02, lr_basis=1e-3, sparsity_lambda=0,
        near_far="[0.05, 9.0]", progress_refresh_rate=5, basedir=str(tmp_path),
        expname="ricoh_e2e", N_vis=0, i_weights=10 ** 7, eval_chunk=512)
    base.update(over)
    return base


def _jax_trainer(cfg_dict):
    from egonerf_tpu.train.config import load_config as jax_load_config
    from egonerf_tpu.train.trainer import Trainer as JaxTrainer

    return JaxTrainer(jax_load_config(overrides=cfg_dict))


def test_trainer_builds_jax_datasets_and_host_ids(captures, tmp_path):
    """``device_sampling = False``: the port's trainer holds JAX's datasets
    bit for bit and its host sampler draws JAX's ids for the same seed (and
    so the same training rows)."""
    port, _, _, _ = captures
    cfg = _cfg(port, tmp_path, device_sampling=False)
    ours = Trainer(load_config(overrides=cfg), device="cpu")
    theirs = _jax_trainer(dict(cfg, basedir=str(tmp_path / "jax")))
    for mine, ref in ((ours.train_dataset, theirs.train_dataset),
                      (ours.test_dataset, theirs.test_dataset)):
        assert type(mine).__name__ == type(ref).__name__ == "EgocentricVideoDataset"
        for name in ("all_rays", "all_rgbs", "poses", "scene_bbox"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
        assert (mine.img_wh, mine.img_wh_origin, mine.near_far) == (
            ref.img_wh, ref.img_wh_origin, ref.near_far)
    assert ours.train_dataset.img_wh == (W, int(ROI[1] * H) - int(ROI[0] * H))
    assert isinstance(ours.sampler, HostRaySampler)
    host = ours.sampler.sampler
    assert (host.w, host.h, host.img_len) == (theirs.sampler.w, theirs.sampler.h,
                                              theirs.sampler.img_len)
    np.testing.assert_array_equal(host.weight, theirs.sampler.weight)
    flat = np.concatenate([theirs.train_dataset.all_rays, theirs.train_dataset.all_rgbs], 1)
    for _ in range(5):
        want = theirs.sampler.nextids()
        np.testing.assert_array_equal(ours.sampler.next_batch().numpy(), flat[want])


def test_trainer_on_the_capture_lowers_the_mse(captures, tmp_path):
    """The device path (K14's plain version on the CPU) through 40 steps:
    the MSE falls, and the eval renders the two held-out frames."""
    port, _, _, _ = captures
    trainer = Trainer(load_config(overrides=_cfg(port, tmp_path)), device="cpu")
    assert isinstance(trainer.sampler, DeviceThetaSampler)
    launches = sampler.theta_ids.launches
    psnrs = trainer.train()
    assert sampler.theta_ids.launches == launches  # CPU tensors: the plain version
    with open(os.path.join(trainer.logdir, "metrics.jsonl")) as f:
        mses = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/mse"]
    assert len(mses) == 8
    assert np.mean(mses[-2:]) < 0.95 * mses[0], mses
    assert len(trainer._evaluate(None)) == 2 and psnrs
