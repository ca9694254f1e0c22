"""Head-to-head convergence run: the port against the upstream PyTorch
EgoNeRF, same data / same initial weights / same ray-id sequence / same
optimizer schedule, PSNR-vs-iteration on held-out views (counterpart of
``egonerf_tpu/tools/headtohead_reference.py``).

Mirrors the reference training semantics (reference: train.py:244-385 with
all optional regularizers at their opt.py defaults of 0 -> MSE-only;
per-group Adam lrs from models/EgoNeRF.py:139-156; per-iter lr decay
train.py:328-329; envmap pretrain handoff train.py:218-242).  Both models
start from the port's initial parameters (copied into the upstream model
by ``reference_layout._copy_params_to_ref``) and consume the identical
``SimpleSampler`` id stream, so any PSNR divergence isolates the numerics
of the two implementations rather than init/data luck.  The port's half
trains through its training forward, so its kernels carry it on the card;
the upstream model runs on the same device.

Presets (JAX's):
  small       2k iters at a 64k-voxel shape
  production  the full 27e6-voxel / batch-4096 / 128+128-sample shape for
              300 iters (PSNR scored on a fixed subsample of at most
              32,768 test rays)
  envmap      the 'env' background variant (texture at infinity): envmap
              pretrain -> optimizer reset -> joint training, exercising
              the reference's pretrain handoff end to end

Usage:  python -m egonerf_torch.tools.headtohead_reference [preset] [out.json]

runs on the card and needs the upstream checkout at ``REF`` (JAX's
default path, kept): without a card, or without ``models/EgoNeRF.py``
there, it raises before any training.  It writes the table to
``build/headtohead_<preset>.json`` by default, with ``device``, the card's
name and power limit.  :func:`run` returns the table without writing it;
``reference=False`` runs the port's half alone.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from . import RUNS_DIR, device_name
from .reference_layout import REFERENCE, _copy_params_to_ref, _stub_ref_deps, on_path

REF = REFERENCE

DECAY_RATIO = 0.1
EVAL_CHUNK = 4096
LR_GRID, LR_NET = 0.02, 1e-3
# reference: opt.py:66-67
LR_ENVMAP_PRETRAIN, LR_ENVMAP = 0.02, 0.005

PRESETS = {
    "small": dict(
        n_iters=2000, batch=1024, n_coarse=48, n_fine=48, n_voxel=64_000,
        eval_every=500, d_comp=(8, 8, 8), a_comp=(16, 16, 16), app_dim=12,
        feature_c=64, pretrain=0, eval_rays=None, dataset={}),
    "production": dict(
        n_iters=300, batch=4096, n_coarse=128, n_fine=128,
        n_voxel=27_000_000, eval_every=100, d_comp=(16, 16, 16),
        a_comp=(48, 48, 48), app_dim=27, feature_c=128, pretrain=0,
        eval_rays=32768, dataset={}),
    "envmap": dict(
        n_iters=1000, batch=1024, n_coarse=48, n_fine=48, n_voxel=64_000,
        eval_every=250, d_comp=(8, 8, 8), a_comp=(16, 16, 16), app_dim=12,
        feature_c=64, pretrain=200, envmap_res_h=100, eval_rays=None,
        dataset=dict(n_train=12, n_test=2, height=200, width=400,
                     background="env")),
}

# the preset entries a caller of run() may cut
CUTS = ("n_iters", "eval_every", "pretrain")


def psnr(pred, gt):
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    return -10.0 * np.log(max(mse, 1e-12)) / np.log(10.0)


def check_reference(reference: str) -> None:
    """Raise JAX's ``ModuleNotFoundError`` for ``models`` unless
    ``reference`` holds the upstream ``models/EgoNeRF.py``."""
    if not os.path.isfile(os.path.join(reference, "models", "EgoNeRF.py")):
        raise ModuleNotFoundError(
            f"No module named 'models': no upstream checkout at {reference!r} "
            "(models/EgoNeRF.py); the head-to-head trains the upstream model",
            name="models")


def run(preset: str = "small", device="cuda", reference: bool = True, **cuts) -> dict:
    """Train the port (and with ``reference`` the upstream model) at
    ``preset``, its ``n_iters``, ``eval_every`` and ``pretrain`` cut to
    ``cuts``; returns the table and writes nothing.  Raises before any work
    without the card asked for, and with ``reference`` without the upstream
    checkout at :data:`REF`."""
    from .._device import resolve_device
    from ..coords.yinyang import YinYangSphericalCoords
    from ..data.datasets import SyntheticEgoDataset
    from ..data.samplers import SimpleSampler
    from ..models.egonerf import EgoNeRF, FieldConfig, StepKey
    from ..render.renderer import Renderer
    from ..train.optim import Optimizer

    dev = resolve_device(device)
    if reference:
        check_reference(REF)
    unknown = sorted(set(cuts) - set(CUTS))
    if unknown:
        raise TypeError(f"run() cuts only {CUTS}, not {unknown}")
    P = {**PRESETS[preset], **cuts}
    use_envmap = P["pretrain"] > 0

    train_ds = SyntheticEgoDataset(split="train", is_stack=False,
                                   **P["dataset"])
    test_ds = SyntheticEgoDataset(split="test", is_stack=True, **P["dataset"])
    test_rays = np.asarray(test_ds.all_rays[0]).reshape(-1, 6).astype(np.float32)
    test_gt = np.asarray(test_ds.all_rgbs[0]).reshape(-1, 3).astype(np.float32)
    if P["eval_rays"] and P["eval_rays"] < test_rays.shape[0]:
        # fixed subsample keeps the upstream's eval affordable at the
        # production shape; identical rays on both sides -> fair PSNR
        pick = np.random.default_rng(7).choice(
            test_rays.shape[0], P["eval_rays"], replace=False)
        test_rays, test_gt = test_rays[pick], test_gt[pick]

    aabb = train_ds.scene_bbox
    near_far = list(train_ds.near_far)
    n_iters, batch = P["n_iters"], P["batch"]
    n_coarse, n_fine = P["n_coarse"], P["n_fine"]

    # ---- the port ---------------------------------------------------------
    coords = YinYangSphericalCoords(aabb, exp_r=True, N_voxel=P["n_voxel"],
                                    r0=0.05, interval_th=True)
    cfg = FieldConfig(density_n_comp=P["d_comp"], app_n_comp=P["a_comp"],
                      app_dim=P["app_dim"], shading_mode="MLP_Fea", view_pe=2,
                      fea_pe=2, feature_c=P["feature_c"], density_shift=-8.0,
                      use_envmap=use_envmap,
                      envmap_res_h=P.get("envmap_res_h", 1000))
    ours = EgoNeRF(aabb, coords.resolution, coords, cfg, near_far=near_far, device=dev)
    params = ours.init_params(torch.Generator(device=dev).manual_seed(0))
    # Adam updates the parameters in place: the upstream model starts from
    # this host copy
    params_init = ({k: v.detach().cpu().clone() for k, v in params.items()}
                   if reference else None)
    # constant lrs through pretrain — the reference's pretrain loop never
    # decays (train.py:222-233); decay starts with the main loop
    opt = Optimizer(params, LR_GRID, LR_NET, LR_ENVMAP_PRETRAIN,
                    decay_target_ratio=1.0 if P["pretrain"] else DECAY_RATIO,
                    decay_iters=n_iters)

    # identical ray-id stream for both models (pretrain consumes the
    # stream first, exactly like the reference loop train.py:222-229)
    sampler = SimpleSampler(train_ds.all_rays.shape[0], batch, seed=0)
    pre_ids = np.stack([sampler.nextids() for _ in range(P["pretrain"])]) \
        if P["pretrain"] else np.zeros((0, batch), np.int64)
    ids_all = np.stack([sampler.nextids() for _ in range(n_iters)])
    all_rays = np.asarray(train_ds.all_rays, np.float32)
    all_rgbs = np.asarray(train_ds.all_rgbs, np.float32)
    rays_dev = torch.as_tensor(all_rays, device=dev)
    rgbs_dev = torch.as_tensor(all_rgbs, device=dev)

    fwd_kw = dict(n_coarse=n_coarse, n_fine=n_fine, exp_sampling=True,
                  resampling=True, use_coarse_sample=True)
    # the step's draws (JAX's PRNGKey(2)): the coarse jitter from a device
    # generator, K4's sorted uniforms keyed by (2, step)
    generator = torch.Generator(device=dev).manual_seed(2)

    def batch_of(ids):
        ids = torch.as_tensor(ids, device=dev)
        return rays_dev[ids], rgbs_dev[ids]

    def step(it, rays, rgbs):
        out = ours.forward(params, rays, key=StepKey(generator, 2, it), is_train=True,
                           **fwd_kw)
        loss = torch.mean((out["rgb"] - rgbs) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    def pretrain_step(rays, rgbs):
        out = ours.forward(params, rays, key=None, is_train=True,
                           pretrain_envmap=True, **fwd_kw)
        loss = torch.mean((out["env"] - rgbs) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    renderer = Renderer(ours, chunk=EVAL_CHUNK, **fwd_kw)

    def eval_ours():
        rgb = renderer.render_rays(params, test_rays)["rgb"]
        return psnr(rgb.cpu().numpy(), test_gt)

    t0 = time.time()
    for it in range(P["pretrain"]):
        loss = pretrain_step(*batch_of(pre_ids[it]))
    if P["pretrain"]:
        # reference: train.py:241-242 — fresh Adam, envmap lr drops to
        # lr_envmap; decay schedule restarts with the main loop
        opt = Optimizer(params, LR_GRID, LR_NET, LR_ENVMAP,
                        decay_target_ratio=DECAY_RATIO, decay_iters=n_iters)
        print(f"[ours ] envmap pretrain done ({time.time()-t0:.0f}s, "
              f"final mse {float(loss):.5f})", flush=True)

    ours_curve = {}
    t0 = time.time()
    for it in range(n_iters):
        step(it, *batch_of(ids_all[it]))
        if (it + 1) % P["eval_every"] == 0:
            ours_curve[it + 1] = eval_ours()
            print(f"[ours ] iter {it+1}: test PSNR {ours_curve[it+1]:.2f} "
                  f"({time.time()-t0:.0f}s)", flush=True)

    ref_curve = {}
    if reference:
        ref_curve = _reference_half(P, dev, aabb, near_far, coords, use_envmap,
                                    params_init, pre_ids, ids_all, all_rays, all_rgbs,
                                    test_rays, test_gt)

    return {
        "preset": preset,
        "iters": sorted(ours_curve),
        "ours_psnr": [round(ours_curve[k], 3) for k in sorted(ours_curve)],
        "reference_psnr": [round(ref_curve[k], 3) for k in sorted(ref_curve)],
        "config": dict(n_iters=n_iters, batch=batch, n_coarse=n_coarse,
                       n_fine=n_fine, n_voxel=P["n_voxel"],
                       pretrain=P["pretrain"], eval_rays=P["eval_rays"]),
        "device": device_name(dev),
    }


def _reference_half(P, dev, aabb, near_far, coords, use_envmap, params_init, pre_ids,
                    ids_all, all_rays, all_rgbs, test_rays, test_gt) -> dict:
    """The upstream model from ``params_init`` through the same id stream
    and schedule on ``dev``; returns its PSNR by iteration."""
    n_iters = P["n_iters"]
    _stub_ref_deps()
    with on_path(REF):
        from models.coordinates import YinYangSphericalCoords as RefCoords
        from models.EgoNeRF import EgoNeRF as RefEgoNeRF

    t_aabb = torch.tensor(np.asarray(aabb, np.float32), device=dev)
    ref_coords = RefCoords(str(dev), t_aabb, exp_r=True, N_voxel=P["n_voxel"],
                           r0=0.05, interval_th=True)
    ref = RefEgoNeRF(
        t_aabb, coords.resolution, str(dev), ref_coords,
        density_n_comp=list(P["d_comp"]), appearance_n_comp=list(P["a_comp"]),
        app_dim=P["app_dim"], near_far=near_far, shadingMode="MLP_Fea",
        density_shift=-8, distance_scale=25, pos_pe=6, view_pe=2, fea_pe=2,
        featureC=P["feature_c"], fea2denseAct="softplus",
        coarse_sigma_grid_update_rule="conv", use_envmap=use_envmap,
        envmap_res_H=P.get("envmap_res_h", 1000)).to(dev)
    _copy_params_to_ref(ref, params_init)

    ref_kw = dict(is_train=True, ndc_ray=False, n_coarse=P["n_coarse"],
                  n_fine=P["n_fine"], exp_sampling=True, resampling=True,
                  use_coarse_sample=True, interval_th=True)

    def on_dev(a):
        return torch.tensor(a, device=dev)

    opt = torch.optim.Adam(
        ref.get_optparam_groups(LR_GRID, LR_NET, LR_ENVMAP_PRETRAIN),
        betas=(0.9, 0.99))
    lr_factor = DECAY_RATIO ** (1.0 / n_iters)

    t0 = time.time()
    for it in range(P["pretrain"]):  # reference: train.py:222-233
        ids = pre_ids[it]
        env_map = ref(on_dev(all_rays[ids]), pretrain_envmap=True, **ref_kw)
        loss = torch.mean((env_map - on_dev(all_rgbs[ids])) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    if P["pretrain"]:  # reference: train.py:241-242
        opt = torch.optim.Adam(ref.get_optparam_groups(LR_GRID, LR_NET,
                                                       LR_ENVMAP),
                               betas=(0.9, 0.99))
        print(f"[torch] envmap pretrain done ({time.time()-t0:.0f}s, "
              f"final mse {loss.item():.5f})", flush=True)

    def eval_ref():
        preds = []
        with torch.no_grad():
            for c0 in range(0, test_rays.shape[0], EVAL_CHUNK):
                rgb, *_ = ref(on_dev(test_rays[c0:c0 + EVAL_CHUNK]),
                              **{**ref_kw, "is_train": False})
                preds.append(rgb.cpu().numpy())
        return psnr(np.concatenate(preds), test_gt)

    ref_curve = {}
    t0 = time.time()
    for it in range(n_iters):
        ids = ids_all[it]
        rgb, *_ = ref(on_dev(all_rays[ids]), **ref_kw)
        loss = torch.mean((rgb - on_dev(all_rgbs[ids])) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        for group in opt.param_groups:  # reference: train.py:328-329
            group["lr"] = group["lr"] * lr_factor
        ref.update_coarse_sigma_grid()
        if (it + 1) % P["eval_every"] == 0:
            ref_curve[it + 1] = eval_ref()
            print(f"[torch] iter {it+1}: test PSNR {ref_curve[it+1]:.2f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    return ref_curve


def main(preset: str = "small", out_path: str = ""):
    out_path = out_path or os.path.join(RUNS_DIR, f"headtohead_{preset}.json")
    table = run(preset)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(table))


if __name__ == "__main__":
    main(*sys.argv[1:])
