"""Models of the port: EgoNeRF with the envmap, the TensoRF family
(TensorVMSplit, TensorVM, TensorCP), each with any of JAX's five shading
modes, their construction from a training config (counterpart of
``egonerf_tpu/models/__init__.py``), and the converter for JAX
checkpoints."""
from __future__ import annotations

import dataclasses

from .convert import (load_jax_checkpoint, load_params, params_from_jax, params_to_jax,
                      stored_grid_size)
from .egonerf import EgoNeRF, FieldConfig, LookupTables, StepKey, feature2density
from .shading import MLPFea, make_shader
from .tensorf import TensorCP, TensorVM, TensorVMSplit

MODELS = {"EgoNeRF": EgoNeRF, "TensorVMSplit": TensorVMSplit, "TensorVM": TensorVM,
          "TensorCP": TensorCP}


def _field_config(cfg, meta=None) -> FieldConfig:
    if meta:
        return FieldConfig.from_meta(meta)
    return FieldConfig(
        density_n_comp=tuple(cfg.n_lamb_sigma), app_n_comp=tuple(cfg.n_lamb_sh),
        app_dim=cfg.data_dim_color, shading_mode=cfg.shadingMode, pos_pe=cfg.pos_pe,
        view_pe=cfg.view_pe, fea_pe=cfg.fea_pe, feature_c=cfg.featureC,
        density_shift=cfg.density_shift, distance_scale=cfg.distance_scale,
        fea2dense_act=cfg.fea2denseAct, ray_march_weight_thres=cfg.rm_weight_mask_thre,
        alpha_mask_thres=cfg.alpha_mask_thre, step_ratio=cfg.step_ratio,
        use_envmap=cfg.use_envmap,
        envmap_res_h=int(cfg.envmap_res_H / cfg.downsample_train),
        compute_dtype=cfg.compute_dtype)


def model_class(name: str):
    """The port's class of a model family; JAX's ``ValueError`` for a name
    that no family has."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name}")
    return MODELS[name]


def build_model(cfg, aabb, grid_size, coordinates, near_far, meta=None, device="cuda"):
    """The model of a training config, or of a checkpoint's ``model_meta``
    (whose family and fields win over the config's, with JAX's notice when
    the two names differ)."""
    name = (meta or {}).get("model_name") or cfg.model_name
    if (meta or {}).get("model_name") and name != cfg.model_name:
        print(f"build_model: checkpoint stores model_name={name!r}; the "
              f"config's {cfg.model_name!r} is ignored (a checkpoint's "
              f"family always wins)")
    return model_class(name)(aabb, grid_size, coordinates, _field_config(cfg, meta),
                             near_far=near_far, device=device)


def model_meta(cfg, model) -> dict:
    """The checkpoint's ``model_meta`` as the JAX package writes it: every
    field of the model's own ``FieldConfig`` and the model name (``cfg`` is
    unused, as in JAX: a resumed checkpoint keeps the values it was made
    with)."""
    meta = dataclasses.asdict(model.cfg)
    meta["density_n_comp"] = list(meta["density_n_comp"])
    meta["app_n_comp"] = list(meta["app_n_comp"])
    meta["model_name"] = type(model).__name__
    return meta
