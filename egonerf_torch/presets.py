"""The production model shape as the port's own constants, and the
production training overrides (counterpart of
``egonerf_tpu/presets.py::production_overrides``, whose values these
mirror).

N_voxel 27e6 on the yin-yang chart gives the grid [150, 172, 516];
n_lamb 16/48 per decomposition; MLP_Fea with featureC 128 and view/feature
PE 2; exponential sampling with interval_th and r0 0.03; 128 coarse + 128
fine samples; eval chunks of 4096 rays; near/far [0.01, 15].
"""
from __future__ import annotations

import numpy as np

from .coords.yinyang import YinYangSphericalCoords
from .models.egonerf import EgoNeRF, FieldConfig

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
