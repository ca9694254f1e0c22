"""The training loop (counterpart of ``egonerf_tpu/train/trainer.py``:
``Trainer`` and ``render_test``), cut to what the port carries.

One step draws a batch of ray ids on the card from the resident (N, 9)
buffer, runs ``EgoNeRF.forward`` in training mode (K5's sorted uniforms,
K3 and K4 on the detached coarse grid, the fine field through K1/K2, the
shader through torch autograd, the composite through K6/K6b), takes the
MSE, and steps Adam.  Nothing synchronises the host per step: the MSE is
read with ``.item()`` only every ``progress_refresh_rate`` steps.  Events
(``vis_list``, ``i_weights``, the end) fire as in JAX.

What the JAX trainer does besides, the port does not carry yet and refuses
by name (ROADMAP.md §1): the envmap and its pretrain; the TV, L1, Ortho,
entropy, sparsity and depth losses; grid upsampling and the alpha mask
(their sentinel schedules beyond ``n_iters`` are accepted); the
empty-space cull, the theta-importance sampler, ray filtering, the device
mesh and the profiler hook.
"""
from __future__ import annotations

import datetime
import json
import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..coords import coords_from_spec, make_coordinates
from ..data.datasets import dataset_class
from ..data.samplers import DeviceRaySampler
from ..models import StepKey, build_model, model_meta, params_from_jax
from ..render.metrics import mse2psnr
from ..render.renderer import Renderer, evaluation
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .config import Config, export_config
from .optim import Optimizer

_ROADMAP = "is not ported yet (ROADMAP.md §1)"


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for every option of the JAX trainer
    that the port does not carry yet."""
    refused = []
    if cfg.use_envmap or cfg.iter_pretrain_envmap > 0:
        refused.append("the envmap and its pretrain")
    for name in ("TV_weight_density", "TV_weight_app", "L1_weight_initial", "L1_weight_rest",
                 "Ortho_weight", "entropy_weight", "sparsity_lambda"):
        if getattr(cfg, name) > 0:
            refused.append(f"{name} > 0")
    if cfg.use_depth:
        refused.append("depth supervision")
    for name in ("upsamp_list", "update_AlphaMask_list"):
        early = [v for v in (getattr(cfg, name) or []) if v < cfg.n_iters]
        if early:
            refused.append(f"{name} entries {early} below n_iters")
    if cfg.train_keep or cfg.eval_keep:
        refused.append("the empty-space cull (train_keep, eval_keep)")
    if cfg.sampling_method != "simple":
        refused.append(f"sampling_method {cfg.sampling_method!r}")
    if cfg.filter_ray:
        refused.append("filter_ray")
    if cfg.mesh_shape and int(np.prod(cfg.mesh_shape)) > 1:
        refused.append("a multi-device mesh")
    if cfg.profile_dir:
        refused.append("the profiler hook (profile_dir)")
    if cfg.coarse_sigma_grid_update_rule == "samp":
        refused.append("the 'samp' coarse-grid rule")
    if not cfg.exp_sampling:
        refused.append("linear ray sampling (exp_sampling off)")
    if cfg.ndc_ray:
        refused.append("NDC rays")
    if cfg.render_path or cfg.export_mesh:
        refused.append("render_path and export_mesh")
    if refused:
        raise NotImplementedError("; ".join(refused) + f": {_ROADMAP}")


class MetricsLogger:
    """JSONL scalar log, ``metrics.jsonl`` in the log folder (written every
    ``progress_refresh_rate`` steps, so each line opens the file)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")

    def scalar(self, tag: str, value: float, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")


def _load_model(cfg: Config, path: str, aabb, near_far, device):
    """(model, header) of a checkpoint written by either package."""
    flat, header = load_checkpoint(path)
    coords = coords_from_spec(header["coords_spec"])
    model = build_model(cfg, aabb, coords.resolution, coords, near_far,
                        meta=header.get("model_meta"), device=device)
    model.load_state_dict(params_from_jax(flat, device=device))
    return model, header


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = dev = resolve_device(device)

        # -- datasets ---------------------------------------------------
        ds_cls = dataset_class(cfg.dataset_name)
        common = dict(data_dir=cfg.datadir, near_far=cfg.near_far, roi=cfg.roi,
                      localization_method=cfg.localization_method,
                      use_gt_depth=cfg.use_gt_depth)
        self.train_dataset = ds_cls(split="train", is_stack=False,
                                    downsample=cfg.downsample_train, **common)
        self.test_dataset = ds_cls(split="test", is_stack=True,
                                   downsample=cfg.downsample_test, skip=cfg.test_skip, **common)
        self.near_far = self.train_dataset.near_far
        self.white_bg = self.train_dataset.white_bg
        aabb = self.train_dataset.scene_bbox

        # -- logdir -----------------------------------------------------
        stamp = datetime.datetime.now().strftime("-%Y%m%d-%H%M%S") if cfg.add_timestamp else ""
        self.logdir = os.path.join(cfg.basedir, cfg.expname + stamp)
        os.makedirs(os.path.join(self.logdir, "imgs_vis"), exist_ok=True)
        export_config(cfg, self.logdir)
        self.log = MetricsLogger(self.logdir)

        # -- model: auto-resume from the newest checkpoint ---------------
        self.start_step = 0
        ckpt_path = cfg.ckpt or latest_checkpoint(self.logdir)
        if ckpt_path:
            print(f"resuming from {ckpt_path}")
            self.model, header = _load_model(cfg, ckpt_path, aabb, self.near_far, dev)
            self.coords = self.model.coordinates
            self.start_step = int(header["global_step"])
        else:
            self.coords = make_coordinates(cfg.coordinates_name, aabb, exp_r=cfg.exp_sampling,
                                           N_voxel=cfg.N_voxel_init, r0=cfg.r0,
                                           interval_th=cfg.interval_th)
            self.model = build_model(cfg, aabb, self.coords.resolution, self.coords,
                                     self.near_far, device=dev)
            self.model.init_params(torch.Generator(device=dev).manual_seed(cfg.seed))
        self.params = self.model.params()

        # -- optimizer: the decay counts from the resume point ------------
        decay_iters = cfg.lr_decay_iters if cfg.lr_decay_iters > 0 else cfg.n_iters
        self.optimizer = Optimizer(self.params, cfg.lr_init, cfg.lr_basis, cfg.lr_envmap,
                                   cfg.lr_decay_target_ratio, decay_iters)
        self.optimizer.fast_forward(self.start_step)

        # -- device-resident training rays and the step's generator -------
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
        self.sampler = DeviceRaySampler(self.train_dataset.all_rays,
                                        self.train_dataset.all_rgbs, cfg.batch_size,
                                        self.generator)
        self.renderer = Renderer.from_config(self.model, cfg, self.white_bg)

    # ------------------------------------------------------------------
    def train_step(self, iteration: int) -> torch.Tensor:
        """One optimizer step at ``iteration``; returns the batch MSE as a
        device scalar (reading it synchronises the host)."""
        cfg = self.cfg
        row = self.sampler.next_batch()
        out = self.model.forward(
            self.params, row[:, :6], key=StepKey(self.generator, cfg.seed, iteration),
            is_train=True, n_coarse=cfg.n_coarse, n_fine=cfg.n_fine,
            exp_sampling=cfg.exp_sampling,
            resampling=cfg.resampling and iteration > cfg.iter_ignore_resampling,
            use_coarse_sample=cfg.use_coarse_sample, white_bg=self.white_bg)
        mse = torch.mean((out["rgb"] - row[:, 6:9]) ** 2)
        self.optimizer.zero_grad()
        mse.backward()
        self.optimizer.step()
        return mse.detach()

    def _evaluate(self, save_path, prefix="", n_vis=-1) -> list:
        return evaluation(self.test_dataset, self.model, self.params, self.renderer,
                          save_path=save_path, n_vis=n_vis, prefix=prefix)

    def train(self) -> list:
        cfg = self.cfg
        vis_list = set(cfg.vis_list or [])
        psnrs_test = [0.0]
        t_start, rays_done = time.time(), 0
        iteration = self.start_step
        while iteration < cfg.n_iters:
            mse = self.train_step(iteration)
            rays_done += cfg.batch_size
            if iteration % cfg.progress_refresh_rate == 0:
                mse_v = mse.item()
                psnr = mse2psnr(max(mse_v, 1e-12))
                self.log.scalar("train/PSNR", psnr, iteration)
                self.log.scalar("train/mse", mse_v, iteration)
                elapsed = time.time() - t_start
                print(f"iter {iteration:06d} psnr {psnr:.2f} test {np.mean(psnrs_test):.2f} "
                      f"mse {mse_v:.6f} rays/s {rays_done / max(elapsed, 1e-9):,.0f}")

            if (iteration + 1) in vis_list and cfg.N_vis != 0:
                psnrs_test = self._evaluate(os.path.join(self.logdir, "imgs_vis"),
                                            prefix=f"{iteration:06d}_", n_vis=cfg.N_vis)
                if psnrs_test:
                    self.log.scalar("test/psnr", float(np.mean(psnrs_test)), iteration)
                t_start, rays_done = time.time(), 0

            if cfg.i_weights > 0 and iteration % cfg.i_weights == 0 and iteration != 0:
                self.save(os.path.join(self.logdir, f"{cfg.expname}_{iteration:06d}.npz"),
                          iteration)
            iteration += 1

        self.save(os.path.join(self.logdir, f"{cfg.expname}.npz"), cfg.n_iters)
        if cfg.render_train:
            train_stacked = type(self.train_dataset)(
                data_dir=cfg.datadir, split="train", is_stack=True,
                downsample=cfg.downsample_train, near_far=cfg.near_far, roi=cfg.roi,
                localization_method=cfg.localization_method)
            psnrs_train = evaluation(train_stacked, self.model, self.params, self.renderer,
                                     save_path=os.path.join(self.logdir, "imgs_train_all"))
            print(f"======> {cfg.expname} train all psnr: {np.mean(psnrs_train)} <====")
        if cfg.render_test:
            psnrs_test = self._evaluate(os.path.join(self.logdir, "imgs_test_all"))
            print(f"======> {cfg.expname} test all psnr: {np.mean(psnrs_test)} <====")
        return psnrs_test

    def save(self, path: str, global_step: int) -> None:
        save_checkpoint(path, self.params, global_step=global_step,
                        coords_spec=self.coords.to_spec(),
                        model_meta=model_meta(self.cfg, self.model))
        print(f"saved checkpoint {path}")


def render_test(cfg: Config, device="cuda"):
    """Evaluation entry: restore the newest (or the given) checkpoint and
    render the whole test set; returns the PSNR of each view and writes
    ``evaluation/mean.txt`` in the log folder."""
    if cfg.metric_only:
        raise NotImplementedError(f"metric_only {_ROADMAP}")
    dev = resolve_device(device)
    test_dataset = dataset_class(cfg.dataset_name)(
        data_dir=cfg.datadir, split="test", is_stack=True, downsample=1,
        near_far=cfg.near_far, roi=cfg.roi, localization_method=cfg.localization_method,
        skip=1)
    logdir = os.path.join(cfg.basedir, cfg.expname)
    ckpt_path = cfg.ckpt or latest_checkpoint(logdir)
    if not ckpt_path or not os.path.exists(ckpt_path):
        print("the ckpt path does not exist!")
        return None
    model, _ = _load_model(cfg, ckpt_path, test_dataset.scene_bbox, test_dataset.near_far, dev)
    renderer = Renderer.from_config(model, cfg, test_dataset.white_bg)
    psnrs = evaluation(test_dataset, model, model.params(), renderer,
                       save_path=os.path.join(logdir, "evaluation"))
    print(f"======> {cfg.expname} test psnr: {np.mean(psnrs)} <====")
    return psnrs
