"""Models of the port: EgoNeRF with MLP_Fea shading and the envmap, its
construction from a training config (counterpart of
``egonerf_tpu/models/__init__.py``), and the converter for JAX checkpoints.
The TensoRF family waits (ROADMAP.md §1)."""
from __future__ import annotations

import dataclasses

from .convert import load_jax_checkpoint, params_from_jax, params_to_jax
from .egonerf import EgoNeRF, FieldConfig, LookupTables, StepKey, feature2density
from .shading import MLPFea


def _field_config(cfg, meta=None) -> FieldConfig:
    if meta:
        return FieldConfig.from_meta(meta)
    return FieldConfig(
        density_n_comp=tuple(cfg.n_lamb_sigma), app_n_comp=tuple(cfg.n_lamb_sh),
        app_dim=cfg.data_dim_color, shading_mode=cfg.shadingMode, view_pe=cfg.view_pe,
        fea_pe=cfg.fea_pe, feature_c=cfg.featureC, density_shift=cfg.density_shift,
        distance_scale=cfg.distance_scale, fea2dense_act=cfg.fea2denseAct,
        use_envmap=cfg.use_envmap,
        envmap_res_h=int(cfg.envmap_res_H / cfg.downsample_train),
        compute_dtype=cfg.compute_dtype)


def build_model(cfg, aabb, grid_size, coordinates, near_far, meta=None,
                device="cuda") -> EgoNeRF:
    """The model of a training config, or of a checkpoint's ``model_meta``
    (whose family wins over the config's)."""
    name = (meta or {}).get("model_name") or cfg.model_name
    if name != "EgoNeRF":
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP.md §1)")
    return EgoNeRF(aabb, grid_size, coordinates, _field_config(cfg, meta),
                   near_far=near_far, device=device)


def model_meta(cfg, model: EgoNeRF) -> dict:
    """The checkpoint's ``model_meta`` as the JAX package writes it: every
    field of its ``FieldConfig`` (those the port does not read yet come
    from ``cfg``) and the model name."""
    meta = dataclasses.asdict(model.cfg)
    meta["density_n_comp"] = list(meta["density_n_comp"])
    meta["app_n_comp"] = list(meta["app_n_comp"])
    meta.update(pos_pe=cfg.pos_pe, ray_march_weight_thres=cfg.rm_weight_mask_thre,
                alpha_mask_thres=cfg.alpha_mask_thre, step_ratio=cfg.step_ratio)
    meta["model_name"] = type(model).__name__
    return meta
