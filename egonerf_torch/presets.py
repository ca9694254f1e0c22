"""The production model shape as the port's own constants, and the
production training overrides (counterpart of
``egonerf_tpu/presets.py::production_overrides``, whose values these
mirror).

N_voxel 27e6 on the yin-yang chart gives the grid [150, 172, 516];
n_lamb 16/48 per decomposition; MLP_Fea with featureC 128 and view/feature
PE 2; exponential sampling with interval_th and r0 0.03; 128 coarse + 128
fine samples; eval chunks of 4096 rays; near/far [0.01, 15].

The outdoor (envmap) configurations change a few fields of that shape:
:func:`outdoor_overrides` reads them from ``OUTDOOR_CONFIG``'s include
chain.  The TensoRF family's shapes are :func:`tensorf_overrides` (the
JAX ``tensorf`` quality preset) and :func:`tensorf_mask_overrides` (the
JAX ``tensorf_bench`` recipe, with the alpha mask).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .coords.yinyang import YinYangSphericalCoords
from .models.egonerf import EgoNeRF, FieldConfig
from .train.config import load_config

N_VOXEL = 27_000_000
R0 = 0.03
NEAR_FAR = (0.01, 15.0)
EVAL_CHUNK = 4096

FIELD = FieldConfig(density_n_comp=(16, 16, 16), app_n_comp=(48, 48, 48), app_dim=27,
                    shading_mode="MLP_Fea", view_pe=2, fea_pe=2, feature_c=128,
                    density_shift=-8.0, fea2dense_act="softplus")

RENDER = dict(n_coarse=128, n_fine=128, exp_sampling=True, resampling=True,
              use_coarse_sample=True, white_bg=True, eval_keep=0)


def production_overrides(**deltas) -> dict:
    """Config overrides of the production training shape: batch 4096 rays,
    128 + 128 samples, N_voxel 27e6 on the yin-yang chart, n_lamb 16/48,
    MLP_Fea featureC 128, MSE only, Adam at lr_init 0.02.  ``deltas`` win."""
    base = dict(
        dataset_name="synthetic", model_name="EgoNeRF",
        coordinates_name="yinyang", exp_sampling=True, interval_th=True,
        r0="0.03", resampling=True, use_coarse_sample=True,
        n_coarse=128, n_fine=128, batch_size=4096,
        N_voxel_init=N_VOXEL, N_voxel_final=N_VOXEL,
        n_lamb_sigma="[16,16,16]", n_lamb_sh="[48,48,48]",
        data_dim_color=27, shadingMode="MLP_Fea", fea2denseAct="softplus",
        density_shift="-8", view_pe=2, fea_pe=2, featureC=128,
        lr_init=0.02, sparsity_lambda=0, near_far="[0.01, 15.0]",
        i_weights=10**9, seed=0, train_keep=0, train_keep_full_every=0,
        train_cull_tau=0.0)
    base.update(deltas)
    return base


# the OmniBlender outdoor scene whose shape the envmap path runs at, and the
# fields of its include chain (with ``common.txt``) that differ from the
# production shape above
OUTDOOR_CONFIG = (Path(__file__).resolve().parent.parent / "configs" / "egonerf"
                  / "omniblender" / "bistro_square.txt")
OUTDOOR_FIELDS = ("near_far", "use_envmap", "envmap_res_H", "iter_pretrain_envmap", "r0")


def outdoor_overrides(**deltas) -> dict:
    """:func:`production_overrides` with the outdoor fields of
    ``configs/egonerf/omniblender/bistro_square.txt`` as the port's
    ``load_config`` reads them through its include chain: near/far
    [0.1, 300], the envmap at ``envmap_res_H`` 1000 with 10000 pretrain
    steps, r0 0.05 (``common.txt``).  The data stay the procedural scene.
    ``deltas`` win."""
    cfg = load_config(str(OUTDOOR_CONFIG))
    return production_overrides(**{**{k: getattr(cfg, k) for k in OUTDOOR_FIELDS}, **deltas})


def scene_aabb(camera_centers: np.ndarray, far: float = NEAR_FAR[1]) -> np.ndarray:
    """The scene box of a capture, as the JAX datasets' ``get_scene_bbox``
    gives it: the trajectory's centre, padded by its half extent plus far."""
    cam = np.asarray(camera_centers, np.float32).reshape(-1, 3)
    center = cam.mean(0)
    radius = np.linalg.norm(cam.max(0) - cam.min(0)) / 2.0
    return np.stack([center - radius - far, center + radius + far]).astype(np.float32)


def production_model(aabb=None, device="cuda") -> EgoNeRF:
    """The production EgoNeRF with zero weights (draw them with
    ``init_params`` or load a checkpoint).  ``aabb`` defaults to one camera
    at the origin: +-15 around it."""
    aabb = scene_aabb(np.zeros(3)) if aabb is None else aabb
    coords = YinYangSphericalCoords(aabb, exp_r=True, N_voxel=N_VOXEL, r0=R0,
                                    interval_th=True)
    return EgoNeRF(aabb, coords.resolution, coords, FIELD, near_far=NEAR_FAR,
                   device=device)


# the TensorVMSplit shape shared by the JAX ``tensorf`` quality preset
# (egonerf_tpu/tools/quality_run.py:106-117) and ``tensorf_bench``
# (egonerf_tpu/tools/tensorf_bench.py:56-67): the xyz chart, uniform steps
# from the aabb entry, 256 samples a ray, no resampling, L1 8e-5 -> 4e-5
TENSORF_SHAPE = dict(
    model_name="TensorVMSplit", coordinates_name="xyz", exp_sampling=False,
    interval_th=False, resampling=False, use_coarse_sample=False, n_coarse=256,
    near_far="[0.05, 8.5]", L1_weight_initial=8e-5, L1_weight_rest=4e-5)
# their procedural scenes: 12 + 2 views at 1000x500 (quality), 8 + 1 at
# 800x400 (bench)
TENSORF_QUALITY_SCENE = dict(n_train=12, n_test=2, height=500, width=1000)
TENSORF_BENCH_SCENE = dict(n_train=8, n_test=1, height=400, width=800)


def tensorf_overrides(**deltas) -> dict:
    """The JAX ``tensorf`` quality preset: TensorVMSplit on the xyz chart,
    6000 steps of batch 4096 with 256 samples a ray, N_voxel 2,097,152 ->
    16,777,216 (128^3 -> 256^3 on a cube) upsampled at 1000, 2000, 3000,
    L1 8e-5 (no alpha mask, so the weight never switches), no TV, one
    evaluation at the end.  ``deltas`` win."""
    return production_overrides(**{**TENSORF_SHAPE, **dict(
        n_iters=6000, N_voxel_init=2_097_152, N_voxel_final=16_777_216,
        upsamp_list="[1000,2000,3000]", TV_weight_density=0.0, TV_weight_app=0.0,
        N_vis=-1, vis_list="[6000]", progress_refresh_rate=500, render_test=True,
        i_weights=2000), **deltas})


# the published TensorCP width (the TensoRF README's CP command: n_lamb_sigma
# [96], n_lamb_sh [288], N_voxel_final 125,000,000 = 500^3, L1 1e-5), kept
# at TENSORF_SHAPE's 256 samples a ray where upstream marches about
# n_samples_auto
TENSORCP_WIDTH = dict(model_name="TensorCP", n_lamb_sigma="[96]", n_lamb_sh="[288]",
                      N_voxel_init=125_000_000, N_voxel_final=125_000_000,
                      L1_weight_initial=1e-5, L1_weight_rest=1e-5)


def tensorcp_overrides(**deltas) -> dict:
    """TensorCP at its published width (CP-384: 96 density and 288
    appearance components, a fixed 500^3 grid, L1 1e-5) on the
    ``tensorf_bench`` recipe of :func:`tensorf_mask_overrides`.
    ``deltas`` win."""
    return tensorf_mask_overrides(**{**TENSORCP_WIDTH, **deltas})


def tensorf_mask_overrides(**deltas) -> dict:
    """The JAX ``tensorf_bench`` recipe: the TensorVMSplit shape at a fixed
    256^3 grid (N_voxel 16,777,216), 1200 steps with the alpha mask baked
    at 1000 (at 128^3, the cap of the bake), where the L1 weight switches to
    4e-5.  ``deltas`` win."""
    return production_overrides(**{**TENSORF_SHAPE, **dict(
        n_iters=1200, N_voxel_init=16_777_216, N_voxel_final=16_777_216,
        update_AlphaMask_list="[1000]", progress_refresh_rate=400, N_vis=0,
        vis_list="[1000000000]", i_weights=10**9), **deltas})
