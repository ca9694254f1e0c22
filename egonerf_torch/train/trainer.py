"""The training loop (counterpart of ``egonerf_tpu/train/trainer.py``:
``Trainer`` and ``render_test``), cut to what the port carries.

One step draws a batch of ray ids from the resident (N, 9) buffer (N, 10
with the ground-truth depths under ``use_depth``): on the
card (uniformly, or under ``sampling_method = theta_importance`` the image
and column uniformly and the row by the cos-latitude weights, drawn, picked
and gathered by K14f in one launch), or on the host by JAX's
``SimpleSampler`` or ``ThetaImportanceSampler`` under ``device_sampling =
False``.  It runs the model's forward in training mode (EgoNeRF: the
coarse chart K7, K3 and K4 on the detached coarse grid with K5's sorted
uniforms drawn in K4's prologue and the fine chart in its epilogue, the
fine field through K1/K2; the TensoRF family: jittered uniform steps, or
NDC steps over [near, far] under ``ndc_ray`` (the training forward only,
as in JAX), K9's mask gate, K1/K2 on the single grid of TensorVMSplit and
TensorVM (relu-free), K17/K17b on TensorCP's lines; all: the shader
through torch autograd,
the composite through K6/K6b; under ``train_keep`` EgoNeRF's empty-space
cull, K4c (K4 with the cull score, drawing as K4) and K13, with a full
step every ``train_keep_full_every``), takes
the MSE plus, in JAX's order, the sparsity term (the density at random
points, ``sparsity_density``: K3's training instantiation, K2 behind it,
the points drawn from the step's generator after the forward's draws),
Ortho, L1, TV, the ray entropy of the forward's alphas (K6's and K6b's
training instantiations, asked for only while the term is on) and the
depth term (masked where the ground truth is 0; the forward's depth
carries no gradient, as JAX stops it), at JAX's schedules, and steps
Adam.  Nothing synchronises the host per step: the MSE is read with
``.item()`` only every ``progress_refresh_rate`` steps.  Events fire
after a step as in JAX: ``vis_list``, ``i_weights``, the alpha-mask bake
(``update_AlphaMask_list``; its first switches the L1 weight) and the grid
upsample (``upsamp_list``), then the end, with ``render_train``,
``render_path`` (``imgs_path_all``) and ``render_test``.  With the envmap a
fresh run first fits the envmap alone (``pretrain_envmap``, JAX
``trainer.py:612-645``).  Under ``filter_ray`` the TensoRF family drops the
training rays that miss the aabb when the sampler is installed, and the
resident buffer holds the kept ones (JAX ``trainer.py:512-520``).

With ``export_mesh`` the end of training writes the density's iso-surface
as ``{expname}.ply`` (``render/export.py``), as JAX does.  With
``profile_dir`` a ``torch.profiler`` window traces ``PROFILE_TRACE_ITERS``
steps from the 16th after the start step and writes its trace and
``traced_steps.json`` there (JAX ``trainer.py:594-601,660-671,759-762``).

In a ``torch.distributed`` process group the trainer is data parallel
(``parallel/mesh.py``, JAX's 1-D data mesh): every rank builds the global
batch, runs its shard of the rays with the global batch's draws, and one
all-reduce averages the gradients; the evaluation splits each view's chunks
over the ranks, and only the lead rank writes files.  Where JAX accepts an
option and ignores it or fails with it, the port refuses it and says so
(ROADMAP.md §3): the cull and ``filter_ray`` off their models,
``filter_ray`` with ``use_depth`` or ``theta_importance``; the refusals of
what the reference never implemented (``metric_only``, the ``samp``
coarse-grid rule) are JAX's own.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..coords import coords_from_spec, make_coordinates
from ..data.datasets import dataset_class
from ..data.samplers import (DeviceRaySampler, DeviceThetaSampler, HostRaySampler,
                             SimpleSampler, ThetaImportanceSampler, host_sampling)
from ..models import StepKey, build_model, load_params, model_meta, stored_grid_size
from ..models.alphamask import mask_from_volumes
from ..ops.volrend import ray_entropy
from ..parallel.mesh import check_batch, grads_of, make_mesh
from ..render.metrics import mse2psnr
from ..render.export import export_density_mesh
from ..render.renderer import Renderer, evaluation, evaluation_path
from .checkpoint import (latest_checkpoint, load_alpha_masks, load_checkpoint, mask_volumes,
                         save_checkpoint)
from .config import Config, export_config
from .optim import Optimizer

# the steps the profiler hook traces (JAX trainer.py:49-51)
PROFILE_TRACE_ITERS = 24
# JAX's refusals of what the reference never implemented (JAX
# trainer.py:104-107, 856-858)
SAMP_REFUSAL = ("'samp' coarse-grid updates are not implemented (reference parity: "
                "train.py:139-140); the 'conv' rule runs every step inside the train step")
METRIC_ONLY_REFUSAL = ("metric_only re-scoring of existing renders is not implemented "
                       "(reference parity: train.py:25-26)")


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for the options that JAX refuses
    itself (its message) and for those that JAX accepts and ignores (the
    reason given).  ``steps_per_call`` is accepted: in JAX it
    only fuses that many steps into one compiled call, and the port runs
    each step eagerly, so it changes no result.  ``device_sampling =
    False`` selects JAX's host samplers (``data/samplers.py``).  A
    ``sampling_method`` other than ``simple`` and ``theta_importance``
    raises JAX's ``ValueError``, as does ``filter_ray`` where JAX's
    trainer fails with it: under ``use_depth`` (it filters the rays and
    the colours, not the depths, so the resident buffer cannot be built,
    or the host sampler pairs rays with other rays' depths) and under
    ``theta_importance`` (the sampler's ids index the unfiltered frames)."""
    if cfg.sampling_method not in ("simple", "theta_importance"):
        raise ValueError(f"sampling method {cfg.sampling_method} not supported")
    if cfg.filter_ray and cfg.model_name != "EgoNeRF":
        if cfg.use_depth:
            raise ValueError("filter_ray with use_depth: the JAX trainer filters the rays and "
                             "colours but not the depths, and fails or pairs rays with the "
                             "wrong depths (ROADMAP.md §3)")
        if cfg.sampling_method == "theta_importance":
            raise ValueError("filter_ray with theta_importance: the JAX trainer's sampler ids "
                             "index the unfiltered frames, which the filter compacts "
                             "(ROADMAP.md §3)")
    if cfg.coarse_sigma_grid_update_rule == "samp":
        raise NotImplementedError(SAMP_REFUSAL)
    refused = []
    if cfg.model_name != "EgoNeRF" and (cfg.train_keep or cfg.eval_keep):
        # JAX's TensoRF forward swallows the options and renders unculled;
        # the port says so instead of accepting and ignoring them
        refused.append(f"the empty-space cull (train_keep, eval_keep) on {cfg.model_name}, "
                       "which the JAX package accepts and ignores (ROADMAP.md §3)")
    if cfg.filter_ray and cfg.model_name == "EgoNeRF":
        # JAX's trainer filters only a model with filtering_rays
        refused.append("filter_ray on EgoNeRF, which the JAX package accepts and ignores (the "
                       "model has no filtering_rays; ROADMAP.md §3)")
    if cfg.ndc_ray and cfg.model_name == "EgoNeRF":
        refused.append("NDC rays are not supported by the egocentric model (JAX "
                       "egonerf_tpu/models/egonerf.py:363-366; reference: models/EgoNeRF.py:504)")
    if refused:
        raise NotImplementedError("; ".join(refused))


class MetricsLogger:
    """JSONL scalar log, ``metrics.jsonl`` in the log folder (written every
    ``progress_refresh_rate`` steps, so each line opens the file).
    ``enabled=False`` (the ranks other than the lead) makes every call a
    no-op, as in JAX."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(logdir, "metrics.jsonl")
        if enabled:
            os.makedirs(logdir, exist_ok=True)

    def scalar(self, tag: str, value: float, step: int):
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")


def check_depths(cfg: Config, train_dataset) -> None:
    """JAX's ``ValueError`` (``trainer.py:124-129,556-558``) where
    ``use_depth`` is on and the loader gives no depths (only the synthetic
    loader gives them)."""
    if cfg.use_depth and train_dataset.all_depths is None:
        raise ValueError(f"use_depth=True but dataset '{cfg.dataset_name}' provides no depths")


def initial_l1_weight(cfg: Config, start_step: int) -> float:
    """The L1 weight at ``start_step``: the switch from the initial to the
    rest weight fires at the first alpha-mask update, so a run resumed past
    it starts on the rest weight (JAX ``trainer.py:89-97``)."""
    lst = cfg.update_AlphaMask_list or []
    return cfg.L1_weight_rest if lst and start_step > lst[0] else cfg.L1_weight_initial


def _load_model(cfg: Config, path: str, aabb, near_far, device):
    """(model, header) of a checkpoint written by either package, its alpha
    mask reinstalled."""
    flat, header = load_checkpoint(path)
    coords = coords_from_spec(header["coords_spec"])
    model = build_model(cfg, aabb, stored_grid_size(flat), coords, near_far,
                        meta=header.get("model_meta"), device=device)
    load_params(model, coords, flat)
    masks = load_alpha_masks(path)
    if masks:
        model.alpha_mask = mask_from_volumes([masks[k] for k in sorted(masks)], model.device)
    return model, header


class Trainer:
    """The training loop on ``device``.  In a ``torch.distributed`` process
    group (``group``, or the default group once one is initialized) it is
    data parallel over the group's ranks, one device a rank; without one it
    runs alone."""

    def __init__(self, cfg: Config, device="cuda", group=None):
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = make_mesh(cfg.mesh_shape, group)
        check_batch(cfg.batch_size, self.mesh)
        self.lead = self.mesh is None or self.mesh.rank == 0
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
        check_depths(cfg, self.train_dataset)
        self.near_far = self.train_dataset.near_far
        self.white_bg = self.train_dataset.white_bg
        aabb = self.train_dataset.scene_bbox

        # -- logdir -----------------------------------------------------
        stamp = datetime.datetime.now().strftime("-%Y%m%d-%H%M%S") if cfg.add_timestamp else ""
        self.logdir = os.path.join(cfg.basedir, cfg.expname + stamp)
        if self.lead:
            os.makedirs(os.path.join(self.logdir, "imgs_vis"), exist_ok=True)
            export_config(cfg, self.logdir)
        self.log = MetricsLogger(self.logdir, enabled=self.lead)

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
            # the model's grid is N_to_reso's, which the directional balanced
            # chart's set_resolution halves for itself (JAX trainer.py:172-179)
            reso = (self.coords.resolution if self.coords.resolution is not None
                    else self.coords.N_to_reso(cfg.N_voxel_init))
            if self.coords.resolution is None:
                self.coords.set_resolution(reso)
            self.model = build_model(cfg, aabb, reso, self.coords, self.near_far, device=dev)
            self.model.init_params(torch.Generator(device=dev).manual_seed(cfg.seed))
        self.params = self.model.params()
        if self.mesh is not None:
            # every rank starts from the lead's parameters (JAX replicate_tree)
            self.mesh.broadcast_(list(self.params.values()))
        self.reso_cur = list(self.coords.resolution)

        # -- optimizer at the main loop's envmap lr (the pretrain builds its
        # own and rebuilds this one after); the decay counts from the resume
        # point ----------------------------------------------------------
        self.optimizer = self._build_optimizer(cfg.lr_envmap)
        self.optimizer.fast_forward(self.start_step)

        # -- the voxel upsample schedule, log-linear, realigned on resume
        # (JAX trainer.py:200-210) ---------------------------------------
        ups = cfg.upsamp_list or []
        self.upsamp_list = [u for u in ups if u < cfg.n_iters]
        self.n_voxel_list = np.round(np.exp(np.linspace(
            np.log(cfg.N_voxel_init), np.log(cfg.N_voxel_final), len(ups) + 1))).astype(
                np.int64).tolist()[1:]
        for u in ups:
            if u < self.start_step and self.n_voxel_list:
                self.n_voxel_list.pop(0)
        # the TV weights decay by lr_factor a step, counted from the resume
        # point (JAX trainer.py:217-221)
        decay_iters = cfg.lr_decay_iters if cfg.lr_decay_iters > 0 else cfg.n_iters
        self.lr_factor = cfg.lr_decay_target_ratio ** (1.0 / decay_iters)
        self._sched_start = self.start_step
        self.l1_weight = initial_l1_weight(cfg, self.start_step)

        # -- device-resident training rays and the step's generator -------
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
        self._install_sampler()
        self.renderer = Renderer.from_config(self.model, cfg, self.white_bg, mesh=self.mesh)

    def _out(self, path: str) -> Optional[str]:
        """``path`` on the lead rank, where files are written; None on the
        others."""
        return path if self.lead else None

    def _build_optimizer(self, lr_envmap: float, decay: bool = True,
                         lr_scale: float = 1.0) -> Optimizer:
        cfg = self.cfg
        decay_iters = cfg.lr_decay_iters if cfg.lr_decay_iters > 0 else cfg.n_iters
        return Optimizer(self.params, cfg.lr_init * lr_scale, cfg.lr_basis * lr_scale,
                         lr_envmap * lr_scale, cfg.lr_decay_target_ratio if decay else 1.0,
                         decay_iters)

    def _install_sampler(self) -> None:
        """JAX's sampler (``_install_train_data``, ``trainer.py:497-537``):
        ``SimpleSampler``, or ``ThetaImportanceSampler`` over the full
        pre-crop frame (``img_wh_origin`` where the dataset crops by its
        roi) and the roi; its ids on the host under ``device_sampling =
        False`` or a ray buffer of 6 GiB or more, else drawn on the card.
        Under ``filter_ray`` the dataset's rays and colours are first cut to
        those that touch the aabb (``filtering_rays(..., bbox_only=True)``),
        as JAX's trainer does before it sizes the sampler."""
        cfg, ds = self.cfg, self.train_dataset
        if cfg.filter_ray:
            ds.all_rays, ds.all_rgbs = self.model.filtering_rays(
                self.params, ds.all_rays, ds.all_rgbs, bbox_only=True)[:2]
        n_rays = ds.all_rays.shape[0]
        if cfg.sampling_method == "simple":
            host = SimpleSampler(n_rays, cfg.batch_size, seed=cfg.seed)
        else:
            full_wh = getattr(ds, "img_wh_origin", ds.img_wh)
            host = ThetaImportanceSampler(cfg.theta_importance_lambda, n_rays, full_wh,
                                          cfg.batch_size, ds.roi, seed=cfg.seed)
        # the depth column (JAX trainer.py:479-481, 540-542)
        depths = ds.all_depths if cfg.use_depth else None
        if host_sampling(n_rays, cfg.device_sampling):
            self.sampler = HostRaySampler(ds.all_rays, ds.all_rgbs, host, self.device, depths)
        elif cfg.sampling_method == "simple":
            self.sampler = DeviceRaySampler(ds.all_rays, ds.all_rgbs, cfg.batch_size,
                                            self.generator, depths)
        else:
            self.sampler = DeviceThetaSampler(ds.all_rays, ds.all_rgbs, host, cfg.batch_size,
                                              self.device, seed=cfg.seed, all_depths=depths)

    def set_datasets(self, train_dataset, test_dataset) -> None:
        """Swap datasets after construction (JAX ``trainer.py:548-563``):
        the resident training rays and the sampler follow.  The scene
        geometry taken at construction (aabb, near/far, white_bg and the
        model built from them) stays: swap datasets of the same scene
        setup.  A depthless loader under ``use_depth`` raises JAX's
        ``ValueError``."""
        check_depths(self.cfg, train_dataset)
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self._install_sampler()

    # ------------------------------------------------------------------
    def tv_weights(self, iteration: int):
        """(density, app) TV weights at ``iteration``: decayed by lr_factor
        once a step from the resume point up to ``iter_ignore_TV`` - 1, in
        float32 as JAX's step computes them; 0 from ``iter_ignore_TV`` on."""
        cfg = self.cfg
        if iteration >= cfg.iter_ignore_TV:
            return 0.0, 0.0
        n_dec = max(min(iteration, cfg.iter_ignore_TV - 1) - self._sched_start + 1, 0)
        f = float(np.float32(self.lr_factor) ** np.float32(n_dec))
        return cfg.TV_weight_density * f, cfg.TV_weight_app * f

    def entropy_on(self, iteration: int) -> bool:
        """Whether the entropy term is in the loss at ``iteration`` (JAX's
        ``entropy_on``: after ``iter_ignore_entropy``, with a positive
        weight)."""
        return self.cfg.entropy_weight > 0 and iteration > self.cfg.iter_ignore_entropy

    def entropy_weight_at(self, iteration: int) -> float:
        """The entropy weight at ``iteration``, in float32 as JAX's
        ``dyn_of`` computes it (``trainer.py:276-280``): decayed by
        lr_factor once a step counted from max(resume point,
        ``iter_ignore_entropy`` + 1); 0 while the term is off."""
        cfg = self.cfg
        if not self.entropy_on(iteration):
            return 0.0
        n_dec = max(iteration - max(self._sched_start, cfg.iter_ignore_entropy + 1) + 1, 0)
        f = np.float32(self.lr_factor) ** np.float32(n_dec)
        return float(np.float32(cfg.entropy_weight) * f)

    def depth_weight_at(self, iteration: int) -> float:
        """The depth weight at ``iteration``, in float32 as JAX's ``dyn_of``
        computes it (``trainer.py:281-289``): depth_lambda *
        depth_rate^(iteration // depth_step_size), 0 after
        ``depth_end_iter``."""
        cfg = self.cfg
        if cfg.depth_end_iter is not None and iteration > cfg.depth_end_iter:
            return 0.0
        f = np.float32(cfg.depth_rate) ** np.float32(iteration // cfg.depth_step_size)
        return float(np.float32(cfg.depth_lambda) * f)

    def loss(self, out, rgbs: torch.Tensor, iteration: int,
             depth_gt: Optional[torch.Tensor] = None,
             sparsity_points: Optional[torch.Tensor] = None,
             depth_count: Optional[torch.Tensor] = None, shards: int = 1):
        """(total loss, MSE) of a forward's ``out`` against the batch's
        ``rgbs``: the MSE plus, in JAX's order, the sparsity term (its
        points drawn from the step's generator, or ``sparsity_points``),
        Ortho, L1 (at the current weight), TV (at :meth:`tv_weights`), the
        entropy of ``out["alpha"]`` (at :meth:`entropy_weight_at`) and,
        under ``use_depth``, the depth term against ``depth_gt`` (the
        batch's depth column; at :meth:`depth_weight_at`, masked where the
        ground truth is 0, no gradient), each where JAX takes it.  On a
        shard of a global batch split ``shards`` ways the depth term's
        denominator is ``depth_count``, the global batch's count of nonzero
        depths, and the term is scaled by ``shards``, so that the mean of the
        ranks' losses is the global batch's (the other terms are means over
        the rays, or the same on every rank)."""
        cfg, model, p = self.cfg, self.model, self.params
        mse = torch.mean((out["rgb"] - rgbs) ** 2)
        total = mse
        if cfg.sparsity_lambda > 0:
            sp = model.sparsity_density(p, self.generator, cfg.N_sparsity_points,
                                        points=sparsity_points)
            loss_sp = 1.0 - torch.mean(torch.exp(-cfg.sparsity_length * sp))
            total = total + cfg.sparsity_lambda * loss_sp
        if cfg.Ortho_weight > 0:
            total = total + cfg.Ortho_weight * model.vector_comp_diffs(p)
        if self.l1_weight > 0:
            total = total + self.l1_weight * model.density_l1(p)
        tv_d, tv_a = self.tv_weights(iteration)
        if tv_d > 0:
            total = total + tv_d * model.tv_loss_density(p)
        if tv_a > 0:
            total = total + tv_a * model.tv_loss_app(p)
        if self.entropy_on(iteration):
            total = total + self.entropy_weight_at(iteration) * ray_entropy(out["alpha"])
        if cfg.use_depth:
            mask = (depth_gt != 0).to(depth_gt.dtype)
            count = torch.sum(mask) if depth_count is None else depth_count
            dloss = shards * torch.sum(mask * (out["depth"] - depth_gt) ** 2) / (count + 1e-8)
            total = total + self.depth_weight_at(iteration) * dloss
        return total, mse

    def train_step(self, iteration: int) -> torch.Tensor:
        """One optimizer step at ``iteration``; returns the batch MSE as a
        device scalar (reading it synchronises the host).  On a data mesh
        the rank runs its shard of the global batch with the global batch's
        draws (``StepKey``'s offset), and one all-reduce averages the
        gradients and the MSE."""
        cfg = self.cfg
        row = self.sampler.next_batch()
        key = StepKey(self.generator, cfg.seed, iteration)
        depth_count, shards = None, 1
        if self.mesh is not None:
            lo, hi = self.mesh.shard(row.shape[0])
            key = key._replace(ray0=lo, n_global=row.shape[0])
            if cfg.use_depth:
                depth_count = torch.sum((row[:, 9] != 0).to(row.dtype))
            shards = self.mesh.world
            row = row[lo:hi]
        # the cull, and every train_keep_full_every-th step unculled (JAX's
        # lax.cond, trainer.py:339-352)
        keep = cfg.train_keep
        if keep and cfg.train_keep_full_every and iteration % cfg.train_keep_full_every == 0:
            keep = 0
        cull = dict(train_keep=keep, train_cull_tau=cfg.train_cull_tau) if keep else {}
        out = self.model.forward(
            self.params, row[:, :6], key=key, is_train=True, n_coarse=cfg.n_coarse,
            n_fine=cfg.n_fine, exp_sampling=cfg.exp_sampling,
            resampling=cfg.resampling and iteration > cfg.iter_ignore_resampling,
            use_coarse_sample=cfg.use_coarse_sample, white_bg=self.white_bg,
            ndc_ray=bool(cfg.ndc_ray), with_alpha=self.entropy_on(iteration), **cull)
        total, mse = self.loss(out, row[:, 6:9], iteration,
                               row[:, 9] if cfg.use_depth else None,
                               depth_count=depth_count, shards=shards)
        self.optimizer.zero_grad()
        total.backward()
        mse = self._average(mse)
        self.optimizer.step()
        return mse

    def _average(self, mse: torch.Tensor) -> torch.Tensor:
        """The step's MSE, detached; on a data mesh it and the gradients
        are averaged over the ranks by one all-reduce (JAX's ``psum``)."""
        mse = mse.detach()
        if self.mesh is not None:
            self.mesh.mean_(grads_of(self.params) + [mse])
        return mse

    def pretrain_step(self) -> torch.Tensor:
        """One envmap pretrain step: the MSE of the envmap's radiance alone
        (``pretrain_envmap`` forward: K8, K8b) on a batch; returns it as a
        device scalar."""
        row = self.sampler.next_batch()
        if self.mesh is not None:
            lo, hi = self.mesh.shard(row.shape[0])
            row = row[lo:hi]
        out = self.model.forward(self.params, row[:, :6], pretrain_envmap=True)
        mse = torch.mean((out["env"] - row[:, 6:9]) ** 2)
        self.optimizer.zero_grad()
        mse.backward()
        mse = self._average(mse)
        self.optimizer.step()
        return mse

    def pretrain_envmap(self) -> None:
        """Fit the envmap alone to the training images before volume
        training (JAX ``trainer.py:612-645``); resumed runs skip it.  Adam
        runs at ``lr_envmap_pretrain`` with no decay (only the envmap has a
        gradient, so only it moves), then is rebuilt at ``lr_envmap`` with
        fresh moments and the decay counted from 0."""
        cfg = self.cfg
        if not (cfg.use_envmap and cfg.iter_pretrain_envmap > 0) or self.start_step > 0:
            return
        print(f"pretraining envmap for {cfg.iter_pretrain_envmap} iters")
        self.optimizer = self._build_optimizer(cfg.lr_envmap_pretrain, decay=False)
        for it in range(1, cfg.iter_pretrain_envmap + 1):
            mse = self.pretrain_step()
            if it % 200 == 0:
                print(f"  envmap pretrain {it}: mse {mse.item():.5f}")
        evaluation(self.test_dataset, self.model, self.params, self.renderer,
                   save_path=self._out(os.path.join(self.logdir, "imgs_vis")), envmap_only=True)
        self.optimizer = self._build_optimizer(cfg.lr_envmap)

    def _evaluate(self, save_path, prefix="", n_vis=-1, compute_extra_metrics=True) -> list:
        return evaluation(self.test_dataset, self.model, self.params, self.renderer,
                          save_path=self._out(save_path), n_vis=n_vis, prefix=prefix,
                          compute_extra_metrics=compute_extra_metrics)

    def _start_profile(self):
        """Open the profiler's window (the host's ops, and the device's on a
        card); only the lead rank traces."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, traced_steps: int) -> None:
        """Close the window once the device has run its steps, and write its
        trace (``trace.json``, torch's Chrome trace format) and
        ``traced_steps.json`` with the steps it holds into ``profile_dir``
        (JAX ``trainer.py:594-601``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.cfg.profile_dir
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        with open(os.path.join(out, "traced_steps.json"), "w") as f:
            json.dump({"steps": int(traced_steps)}, f)
        print(f"profiler trace written to {out}")

    def train(self) -> list:
        cfg = self.cfg
        self.pretrain_envmap()
        vis_list = set(cfg.vis_list or [])
        psnrs_test = [0.0]
        t_start, rays_done = time.time(), 0
        # the profiler's window: idle, tracing, done (JAX trainer.py:660-671);
        # it opens 16 steps after the start step and holds
        # PROFILE_TRACE_ITERS steps, counted in steps (one a loop)
        prof, prof_start, prof_done = None, 0, not (cfg.profile_dir and self.lead)
        iteration = self.start_step
        while iteration < cfg.n_iters:
            if not prof_done:
                if prof is None and iteration >= self.start_step + 16:
                    prof, prof_start = self._start_profile(), iteration
                elif prof is not None and iteration >= prof_start + PROFILE_TRACE_ITERS:
                    self._stop_profile(prof, iteration - prof_start)
                    prof, prof_done = None, True
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
                                            prefix=f"{iteration:06d}_", n_vis=cfg.N_vis,
                                            compute_extra_metrics=False)
                if psnrs_test:
                    self.log.scalar("test/psnr", float(np.mean(psnrs_test)), iteration)
                t_start, rays_done = time.time(), 0

            if cfg.i_weights > 0 and iteration % cfg.i_weights == 0 and iteration != 0:
                self.save(os.path.join(self.logdir, f"{cfg.expname}_{iteration:06d}.npz"),
                          iteration)

            alpha_list = cfg.update_AlphaMask_list or []
            if iteration in alpha_list:
                self.update_alpha_mask()
                if iteration == alpha_list[0]:
                    self.l1_weight = cfg.L1_weight_rest
            if iteration in self.upsamp_list:
                self.upsample(iteration)
            iteration += 1

        if prof is not None:
            # the run ended inside the window: write what it traced
            self._stop_profile(prof, iteration - prof_start)
        self.save(os.path.join(self.logdir, f"{cfg.expname}.npz"), cfg.n_iters)
        if cfg.render_train:
            train_stacked = type(self.train_dataset)(
                data_dir=cfg.datadir, split="train", is_stack=True,
                downsample=cfg.downsample_train, near_far=cfg.near_far, roi=cfg.roi,
                localization_method=cfg.localization_method)
            psnrs_train = evaluation(train_stacked, self.model, self.params, self.renderer,
                                     save_path=self._out(os.path.join(self.logdir,
                                                                      "imgs_train_all")),
                                     compute_extra_metrics=False)
            print(f"======> {cfg.expname} train all psnr: {np.mean(psnrs_train)} <====")
        if cfg.render_path and hasattr(self.test_dataset, "render_path"):
            evaluation_path(self.test_dataset, self.model, self.params,
                            self.test_dataset.render_path, self.renderer,
                            save_path=self._out(os.path.join(self.logdir, "imgs_path_all")))
        if cfg.export_mesh and self.lead:
            export_density_mesh(self.model, self.params,
                                os.path.join(self.logdir, f"{cfg.expname}.ply"))
        if cfg.render_test:
            psnrs_test = self._evaluate(os.path.join(self.logdir, "imgs_test_all"))
            print(f"======> {cfg.expname} test all psnr: {np.mean(psnrs_test)} <====")
        return psnrs_test

    def update_alpha_mask(self) -> None:
        """The alpha-mask event (JAX ``trainer.py:743-752``): bake at the
        current resolution capped at 128 per axis.  The tight aabb the bake
        returns is ignored (no shrink), as in JAX; Adam is kept."""
        self.model.update_alpha_mask(self.params, [min(r, 128) for r in self.reso_cur])

    def upsample(self, iteration: int) -> None:
        """The upsample event (JAX ``trainer.py:803-819``): resample the grids
        onto the next voxel count, set the chart's resolution and the march
        step, and rebuild Adam with fresh moments and the decay from 0, at
        lr scale 1 (``lr_upsample_reset``) or the decay reached so far."""
        cfg = self.cfg
        reso = self.coords.N_to_reso(self.n_voxel_list.pop(0))
        print(f"upsampling grid to {reso} at iter {iteration}")
        self.params = self.model.upsample_params(self.params, reso)
        self.coords.set_resolution(reso)
        self.model.update_step_size(reso)
        self.reso_cur = list(reso)
        lr_scale = (1.0 if cfg.lr_upsample_reset
                    else cfg.lr_decay_target_ratio ** (iteration / cfg.n_iters))
        self.optimizer = self._build_optimizer(cfg.lr_envmap, lr_scale=lr_scale)

    def save(self, path: str, global_step: int) -> None:
        """Write a checkpoint (the lead rank alone: the parameters are the
        same on every rank)."""
        if not self.lead:
            return
        save_checkpoint(path, self.params, global_step=global_step,
                        coords_spec=self.coords.to_spec(),
                        model_meta=model_meta(self.cfg, self.model),
                        alpha_masks=mask_volumes(self.model))
        print(f"saved checkpoint {path}")


def render_test(cfg: Config, device="cuda"):
    """Evaluation entry: restore the newest (or the given) checkpoint and
    render the whole test set with every metric; returns the PSNR of each
    view and writes ``evaluation/`` in the log folder: ``mean.txt``,
    ``mean.json`` and the images of :func:`evaluation`."""
    if cfg.metric_only:
        raise NotImplementedError(METRIC_ONLY_REFUSAL)
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
