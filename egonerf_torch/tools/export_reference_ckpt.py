"""Export one of the port's ``.npz`` checkpoints (the JAX package's format)
as an upstream PyTorch EgoNeRF ``.th``: the inverse of
:mod:`import_reference_ckpt` (counterpart of
``egonerf_tpu/tools/export_reference_ckpt.py``), so that a model trained
in the port renders and can be inspected with the upstream repository.

Loads the checkpoint into the port's model of its family, builds the
upstream model from the stored chart spec and model meta, copies every
tensor with the upstream layout (``reference_layout._copy_params_to_ref``
for EgoNeRF), reinstalls the alpha masks and writes through the upstream
model's own ``save``, so the file is what the upstream ``train.py
--evaluation 1`` reads.

Usage:
    python -m egonerf_torch.tools.export_reference_ckpt ckpt.npz out.th \\
        [--reference=DIR] [--near_far=a,b] [--family=TensorVM]

``export`` loads the checkpoint on the card (``device="cuda"``) and raises
without one; ``device="cpu"`` exports on the host.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..coords import coords_from_spec
from ..models import _field_config, load_params, model_class, stored_grid_size
from ..train.checkpoint import load_alpha_masks, load_checkpoint
from .reference_layout import REFERENCE, _copy_params_to_ref, _stub_ref_deps, on_path

#: the port's chart name -> the upstream coordinates class (the inverse of
#: the import tool's map)
_REF_COORD_CLASS = {
    "xyz": "CartesianCoords",
    "sphere": "SphericalCoords",
    "balanced_sphere": "BalancedSphericalCoords",
    "directional_sphere": "DirectionalSphericalCoords",
    "directional_balanced_sphere": "DirectionalBalancedSphericalCoords",
    "euler_sphere": "EulerSphericalCoords",
    "cylinder": "CylindricalCoords",
    "generic_sphere": "GenericSphericalCoords",
}
_FAMILIES = ("TensorVMSplit", "TensorVM", "TensorCP")


def _export_tensorf(family, spec, cfg, params, masks, out_path, near_far,
                    reference, global_step) -> None:
    """Build the matching upstream TensoRF-family model, copy every tensor
    of ``params`` (the port's ``state_dict`` names) in the upstream layout
    and write through the upstream ``save``."""
    _stub_ref_deps()
    with on_path(reference):
        import models.coordinates as ref_coords_mod
        from models import tensoRF as ref_tensorf
        from models.tensorBase import AlphaGridMask

    aabb = np.asarray(spec["aabb"], np.float32)
    t_aabb = torch.tensor(aabb)
    coord_cls = getattr(ref_coords_mod, _REF_COORD_CLASS[spec["name"]])
    if spec["name"] == "generic_sphere":
        ref_coords = coord_cls(
            "cpu", t_aabb, exp_r=bool(spec.get("exp_r")),
            N_voxel=int(np.prod(spec["resolution"])), r0=spec.get("r0"),
            interval_th=bool(spec.get("interval_th")))
    else:
        ref_coords = coord_cls("cpu", t_aabb)
    reso = [int(g) for g in spec["resolution"]]
    # the fused TensorVM stores scalar component counts, TensorCP a 1-list
    n_den, n_app = list(cfg.density_n_comp), list(cfg.app_n_comp)
    if family == "TensorVM":
        n_den, n_app = n_den[0], n_app[0]
    elif family == "TensorCP":
        n_den, n_app = n_den[:1], n_app[:1]
    ref = getattr(ref_tensorf, family)(
        t_aabb, reso, "cpu", ref_coords,
        density_n_comp=n_den, appearance_n_comp=n_app, app_dim=cfg.app_dim,
        near_far=list(near_far), shadingMode=cfg.shading_mode,
        density_shift=cfg.density_shift, distance_scale=cfg.distance_scale,
        pos_pe=cfg.pos_pe, view_pe=cfg.view_pe, fea_pe=cfg.fea_pe,
        featureC=cfg.feature_c, fea2denseAct=cfg.fea2dense_act,
        step_ratio=cfg.step_ratio, alphaMask_thres=cfg.alpha_mask_thres,
        rayMarch_weight_thres=cfg.ray_march_weight_thres,
        use_envmap=cfg.use_envmap, envmap_res_H=cfg.envmap_res_h)
    if family in ("TensorVM", "TensorCP"):
        # the upstream constructors of these two set neither the mode tables
        # nor the parameters
        ref.matMode = [[0, 1], [0, 2], [1, 2]]
        ref.vecMode = [2, 1, 0]
        ref.init_svd_volume(reso[0], "cpu")

    def host(name):
        return params[name].detach().cpu()

    with torch.no_grad():
        if family == "TensorCP":
            for i in range(3):
                ref.density_line[i].copy_(host(f"density_lines.{i}")[0].T[None, :, :, None])
                ref.app_line[i].copy_(host(f"app_lines.{i}")[0].T[None, :, :, None])
        elif family == "TensorVM":
            for i in range(3):
                plane = torch.cat([host(f"app_planes.{i}")[0].permute(2, 0, 1),
                                   host(f"density_planes.{i}")[0].permute(2, 0, 1)])
                line = torch.cat([host(f"app_lines.{i}")[0].T,
                                  host(f"density_lines.{i}")[0].T])
                ref.plane_coef[i].copy_(plane)
                ref.line_coef[i].copy_(line[:, :, None])
        else:  # TensorVMSplit
            for i in range(3):
                for name in ("density", "app"):
                    getattr(ref, f"{name}_plane")[i].copy_(
                        host(f"{name}_planes.{i}")[0].permute(2, 0, 1)[None])
                    getattr(ref, f"{name}_line")[i].copy_(
                        host(f"{name}_lines.{i}")[0].T[None, :, :, None])
        ref.basis_mat.weight.copy_(host("basis").T)
        if hasattr(ref.renderModule, "mlp"):
            for idx, key in zip((0, 2, 4), ("l1", "l2", "l3")):
                ref.renderModule.mlp[idx].weight.copy_(host(f"shader.{key}.weight"))
                ref.renderModule.mlp[idx].bias.copy_(host(f"shader.{key}.bias"))
        if cfg.use_envmap and "envmap" in params:
            ref.envmap.emission.copy_(host("envmap").permute(2, 0, 1))
    if masks:
        vol = torch.from_numpy(masks["alpha_0"].astype(np.float32))
        ref.alphaMask = AlphaGridMask("cpu", vol)
    ref.save(out_path, global_step=global_step)


def _load_model(family, aabb, coords, cfg, flat, near_far, dev):
    """The port's model of ``family`` at the checkpoint's stored grid with
    its parameters; returns them by ``state_dict`` name."""
    model = model_class(family)(aabb, stored_grid_size(flat), coords, cfg,
                                near_far=near_far, device=dev)
    load_params(model, coords, flat)
    return model.params()


def export(ckpt_path: str, out_path: str, reference: str = REFERENCE, near_far=None,
           family: str = None, device="cuda") -> dict:
    dev = resolve_device(device)
    if not os.path.isdir(reference):
        raise SystemExit(
            f"reference checkout not found at {reference!r} — exporting "
            "instantiates the upstream model classes")
    flat, header = load_checkpoint(ckpt_path)
    masks = load_alpha_masks(ckpt_path)
    spec, meta = header["coords_spec"], header["model_meta"]
    cfg = _field_config(None, meta=meta)
    global_step = int(header.get("global_step", 0))
    coords = coords_from_spec(spec)
    aabb = np.asarray(spec["aabb"], np.float32)
    if spec["name"] != "yinyang":
        near_far = near_far or [0.05, float(np.max(np.abs(aabb)))]
        family = family or meta.get("model_name")
        if family not in _FAMILIES:
            # a checkpoint without model_name: CP has no planes, but VM and
            # VMSplit share the per-axis layout while their density math
            # differs (VMSplit rectifies each axis, VM sums them raw), so the
            # tool does not guess between them
            if not any(k.startswith("density_planes") for k in flat):
                family = "TensorCP"
            else:
                raise SystemExit(
                    "legacy checkpoint lacks model_name and VM/VMSplit "
                    "share a parameter layout with different density math "
                    "— pass --family=TensorVMSplit or --family=TensorVM")
        params = _load_model(family, aabb, coords, cfg, flat, near_far, dev)
        _export_tensorf(family, spec, cfg, params, masks, out_path, near_far,
                        reference, global_step)
        return {"out": out_path, "global_step": global_step,
                "family": family, "resolution": list(spec["resolution"]),
                "use_envmap": cfg.use_envmap, "alpha_masks": bool(masks)}

    # near_far lives in the training config, not the checkpoint header:
    # --near_far pins it (it steers the upstream ray sampling, no exported
    # tensor); the default spans the scene sphere
    near_far = near_far or [0.05, float(coords.far[0])]
    params = _load_model("EgoNeRF", aabb, coords, cfg, flat, near_far, dev)

    _stub_ref_deps()
    with on_path(reference):
        from models.coordinates import YinYangSphericalCoords as RefCoords
        from models.EgoNeRF import EgoNeRF as RefEgoNeRF
        if masks:
            from models.EgoNeRF import YinYangAlphaGridMask

    t_aabb = torch.tensor(aabb)
    n_voxel = int(np.prod(spec["resolution"])) * 2
    ref_coords = RefCoords("cpu", t_aabb, exp_r=bool(spec.get("exp_r")),
                           N_voxel=n_voxel, r0=spec.get("r0"),
                           interval_th=bool(spec.get("interval_th")))
    # the stored resolution exactly (N_voxel's rounding could differ)
    ref_coords.set_resolution(resolution=list(spec["resolution"]), r0=spec.get("r0"))
    ref = RefEgoNeRF(
        t_aabb, list(spec["resolution"]), "cpu", ref_coords,
        density_n_comp=list(cfg.density_n_comp),
        appearance_n_comp=list(cfg.app_n_comp), app_dim=cfg.app_dim,
        near_far=list(near_far), shadingMode=cfg.shading_mode,
        density_shift=cfg.density_shift, distance_scale=cfg.distance_scale,
        pos_pe=cfg.pos_pe, view_pe=cfg.view_pe, fea_pe=cfg.fea_pe,
        featureC=cfg.feature_c, fea2denseAct=cfg.fea2dense_act,
        step_ratio=cfg.step_ratio,
        alphaMask_thres=cfg.alpha_mask_thres,
        rayMarch_weight_thres=cfg.ray_march_weight_thres,
        coarse_sigma_grid_update_rule="conv",
        use_envmap=cfg.use_envmap, envmap_res_H=cfg.envmap_res_h,
    )
    _copy_params_to_ref(ref, params)
    if masks:
        vols = [torch.from_numpy(masks[k].astype(np.float32))
                for k in sorted(masks)]  # alpha_0 = yin, alpha_1 = yang
        ref.alphaMask = YinYangAlphaGridMask("cpu", vols[0], vols[1])
    ref.save(out_path, global_step=global_step)
    return {"out": out_path, "global_step": global_step,
            "resolution": list(spec["resolution"]),
            "use_envmap": cfg.use_envmap, "alpha_masks": bool(masks)}


def main(argv=None) -> None:
    """JAX's command line: two positionals, ``--reference=DIR``,
    ``--near_far=a,b`` and ``--family=NAME``; prints :func:`export`'s dict
    as one JSON line."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("-")]
    if len(args) != 2:
        raise SystemExit(__doc__)
    reference = REFERENCE
    near_far = None
    family = None
    for a in argv:
        if a.startswith("--reference="):
            reference = a.split("=", 1)[1]
        elif a.startswith("--near_far="):
            near_far = [float(v) for v in a.split("=", 1)[1].strip("[]").split(",")]
        elif a.startswith("--family="):
            family = a.split("=", 1)[1]
    print(json.dumps(export(args[0], args[1], reference, near_far, family=family)))


if __name__ == "__main__":
    main()
