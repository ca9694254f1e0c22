"""Convert an upstream PyTorch EgoNeRF ``.th`` checkpoint into the JAX
package's ``.npz`` format on the port's models and checkpoint writer
(counterpart of ``egonerf_tpu/tools/import_reference_ckpt.py``): a model
trained with the upstream repository renders in the port without
retraining.

The upstream repository pickles the live model into ``{kwargs, state_dict,
global_step}``, with ``envmap.emission``, ``envmap_res_H`` and the
bit-packed ``alphaMask_*`` entries beside them, and ``kwargs`` embeds the
live ``Coordinates`` object, so unpickling needs the upstream package
importable.  Point ``--reference`` at a checkout; the tool refuses when it
is absent.

Scope, as JAX's: EgoNeRF on the yin-yang chart, TensorVMSplit, the fused
TensorVM and TensorCP (any single-grid chart), told apart by the
state_dict's parameter names.  Per-chart ``(1, C, H, W)`` planes stack
into ``(2, H, W, C)``, lines ``(1, C, L, 1)`` into ``(2, L, C)``;
TensorVM's fused ``(3, app + den, R, R)`` plane splits into per-axis
planes (app channels first); CP lines become ``(1, L, C)``; the basis
transposes; the shader's ``nn.Linear`` layers keep their layout; the
envmap ``(3, 2h, h)`` becomes ``(2h, h, 3)``; the alpha masks unpack to
``alpha_0`` / ``alpha_1`` (yin / yang) volumes.  Every conversion moves
float32 or bool data without arithmetic, so the file holds the upstream
weights bit for bit.

Usage:
    python -m egonerf_torch.tools.import_reference_ckpt ckpt.th out.npz \\
        [--reference=DIR]

The output loads through the normal paths (``--ckpt out.npz``, or placed
in the experiment folder for auto-resume and ``--evaluation 1``).
``convert`` builds its shape template on the card (``device="cuda"``) and
raises without one; ``device="cpu"`` converts on the host.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..coords import coords_from_spec
from ..models import model_class, model_meta
from ..models.egonerf import FieldConfig
from ..train.checkpoint import save_checkpoint
from .reference_layout import REFERENCE, _stub_ref_deps, on_path


def _load_reference_ckpt(path: str, reference: str):
    if not os.path.isdir(reference):
        raise SystemExit(
            f"reference checkout not found at {reference!r} — the .th "
            "pickles the live Coordinates object, so converting needs the "
            "upstream package importable (pass --reference=/path/to/EgoNeRF)")
    _stub_ref_deps()
    with on_path(reference):
        # the pickle holds classes: torch >= 2.6 refuses them by default
        return torch.load(path, map_location="cpu", weights_only=False)


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def convert(ckpt_path: str, out_path: str, reference: str = REFERENCE,
            device="cuda") -> dict:
    dev = resolve_device(device)
    ckpt = _load_reference_ckpt(ckpt_path, reference)
    kwargs, sd = ckpt["kwargs"], ckpt["state_dict"]

    ref_coords = kwargs["coordinates"]
    cname = type(ref_coords).__name__
    # the .th stores no model-class name (the upstream render takes it from
    # the config): the family comes from the state_dict's parameter names
    if "density_plane_yin.0" in sd:
        family = "EgoNeRF"
    elif "density_plane.0" in sd and "density_line.0" in sd:
        family = "TensorVMSplit"
    elif "plane_coef" in sd and "line_coef" in sd:
        family = "TensorVM"  # fused [app, density] channel layout
    elif "density_line.0" in sd and "app_line.0" in sd:
        family = "TensorCP"
    else:
        raise SystemExit(
            "unsupported checkpoint layout: this converter covers EgoNeRF "
            "(yin-yang), TensorVMSplit, TensorVM and TensorCP — the "
            f"state_dict keys {sorted(sd)[:6]}... match none of them")
    if family == "EgoNeRF" and cname != "YinYangSphericalCoords":
        raise SystemExit(f"EgoNeRF checkpoint with coordinates {cname!r} "
                         "is not supported (yinyang only)")
    if kwargs["shadingMode"] not in ("MLP_Fea", "MLP_PE", "MLP"):
        raise SystemExit(
            f"unsupported shadingMode {kwargs['shadingMode']!r} (SH/RGB "
            "shading has no parameters to convert beyond the grids — open "
            "an issue if you need it)")

    aabb = np.asarray(kwargs["aabb"].cpu().numpy(), np.float32)
    spec = {
        "name": "yinyang" if family == "EgoNeRF" else type(ref_coords).__name__,
        "aabb": aabb.tolist(),
        "resolution": [int(g) for g in kwargs["gridSize"]],
        "exp_r": bool(getattr(ref_coords, "exp_r", False)),
        "interval_th": bool(getattr(ref_coords, "interval_th", False)),
        "r0": (float(ref_coords.r0)
               if getattr(ref_coords, "r0", None) is not None else None),
    }
    if family != "EgoNeRF":
        name_map = {"CartesianCoords": "xyz",
                    "GenericSphericalCoords": "generic_sphere",
                    "SphericalCoords": "sphere",
                    "BalancedSphericalCoords": "balanced_sphere",
                    "DirectionalSphericalCoords": "directional_sphere",
                    "DirectionalBalancedSphericalCoords":
                        "directional_balanced_sphere",
                    "EulerSphericalCoords": "euler_sphere",
                    "CylindricalCoords": "cylinder"}
        if cname not in name_map:
            raise SystemExit(f"unknown coordinates class {cname!r}")
        spec["name"] = name_map[cname]
    coords = coords_from_spec(spec)

    def _ncomp(v):
        # the fused TensorVM stores a scalar; the other families a list
        vals = [int(x) for x in np.atleast_1d(v)]
        return tuple(vals * 3) if len(vals) == 1 else tuple(vals)

    cfg = FieldConfig(
        density_n_comp=_ncomp(kwargs["density_n_comp"]),
        app_n_comp=_ncomp(kwargs["appearance_n_comp"]),
        app_dim=int(kwargs["app_dim"]),
        shading_mode=kwargs["shadingMode"],
        pos_pe=int(kwargs["pos_pe"]), view_pe=int(kwargs["view_pe"]),
        fea_pe=int(kwargs["fea_pe"]), feature_c=int(kwargs["featureC"]),
        density_shift=float(kwargs["density_shift"]),
        distance_scale=float(kwargs["distance_scale"]),
        fea2dense_act=kwargs["fea2denseAct"],
        ray_march_weight_thres=float(kwargs["rayMarch_weight_thres"]),
        alpha_mask_thres=float(kwargs["alphaMask_thres"]),
        step_ratio=float(kwargs["step_ratio"]),
        use_envmap=bool(kwargs.get("use_envmap")),
        envmap_res_h=int(ckpt.get("envmap_res_H", 1000)),
    )
    near_far = [float(v) for v in kwargs["near_far"]]
    # the port's model is the shape template: every one of its parameters is
    # taken from the .th below, none of its own values reaches the file
    model = model_class(family)(aabb, coords.resolution, coords, cfg, near_far=near_far,
                                device=dev)
    shapes = {k: tuple(int(d) for d in p.shape) for k, p in model.params().items()}
    out = {}

    def take(key, expect_shape):
        arr = _np(sd[key])
        if tuple(arr.shape) != tuple(expect_shape):
            raise SystemExit(f"{key}: reference shape {arr.shape} != "
                             f"expected {tuple(expect_shape)}")
        return arr

    if family == "TensorCP":
        # the rank-1 family has no planes
        for i in range(3):
            for name in ("density", "app"):
                _, l, c = shapes[f"{name}_lines.{i}"]
                out[f"{name}_lines.{i}"] = take(
                    f"{name}_line.{i}", (1, c, l, 1))[0, :, :, 0].T[None]
    elif family == "TensorVM":
        # one fused (3, app+den, R, R) tensor, app channels first, split into
        # the per-axis planes and lines the port stores
        na, nd = cfg.app_n_comp[0], cfg.density_n_comp[0]
        h = shapes["density_planes.0"][1]
        l = shapes["density_lines.0"][1]
        pc = take("plane_coef", (3, na + nd, h, h))
        lc = take("line_coef", (3, na + nd, l, 1))
        for i in range(3):
            out[f"app_planes.{i}"] = pc[i, :na].transpose(1, 2, 0)[None]
            out[f"density_planes.{i}"] = pc[i, na:].transpose(1, 2, 0)[None]
            out[f"app_lines.{i}"] = lc[i, :na, :, 0].T[None]
            out[f"density_lines.{i}"] = lc[i, na:, :, 0].T[None]
    else:
        for i in range(3):
            for name in ("density", "app"):
                h, w, c = shapes[f"{name}_planes.{i}"][1:]
                l = shapes[f"{name}_lines.{i}"][1]
                if family == "EgoNeRF":
                    plane = np.stack([
                        take(f"{name}_plane_yin.{i}", (1, c, h, w))[0].transpose(1, 2, 0),
                        take(f"{name}_plane_yang.{i}", (1, c, h, w))[0].transpose(1, 2, 0)])
                    line = np.stack([
                        take(f"{name}_line_yin.{i}", (1, c, l, 1))[0, :, :, 0].T,
                        take(f"{name}_line_yang.{i}", (1, c, l, 1))[0, :, :, 0].T])
                else:
                    plane = take(f"{name}_plane.{i}", (1, c, h, w))[0].transpose(1, 2, 0)[None]
                    line = take(f"{name}_line.{i}", (1, c, l, 1))[0, :, :, 0].T[None]
                out[f"{name}_planes.{i}"] = plane
                out[f"{name}_lines.{i}"] = line

    if family == "EgoNeRF":
        out["basis"] = np.stack([
            take("basis_mat_yin.weight", shapes["basis"][1:][::-1]).T,
            take("basis_mat_yang.weight", shapes["basis"][1:][::-1]).T])
    else:
        out["basis"] = take("basis_mat.weight", shapes["basis"][::-1]).T

    # the shader's nn.Linear layers: the port stores them as torch does
    for idx, key in zip((0, 2, 4), ("l1", "l2", "l3")):
        for part in ("weight", "bias"):
            out[f"shader.{key}.{part}"] = take(f"renderModule.mlp.{idx}.{part}",
                                               shapes[f"shader.{key}.{part}"])

    if cfg.use_envmap:
        em = np.asarray(ckpt["envmap.emission"], np.float32)  # (3, 2h, h)
        out["envmap"] = em.transpose(1, 2, 0)

    masks = None
    if "alphaMask_yin.shape" in ckpt:
        masks = {}
        for j, chart in enumerate(("yin", "yang")):
            shape = ckpt[f"alphaMask_{chart}.shape"]
            n = int(np.prod(shape))
            masks[f"alpha_{j}"] = (np.unpackbits(ckpt[f"alphaMask_{chart}.mask"])
                                   [:n].reshape(shape).astype(bool))
    elif "alphaMask.shape" in ckpt:  # single-grid TensoRF family
        # the upstream stores the (1, 1, D, H, W) grid_sample view; the
        # volume is its last three dimensions
        shape = tuple(ckpt["alphaMask.shape"])[-3:]
        n = int(np.prod(shape))
        masks = {"alpha_0": (np.unpackbits(ckpt["alphaMask.mask"])
                             [:n].reshape(shape).astype(bool))}

    # every parameter of the template, each from the .th (KeyError otherwise)
    params = {k: torch.from_numpy(np.ascontiguousarray(out[k])) for k in shapes}
    save_checkpoint(out_path, params,
                    global_step=int(ckpt.get("global_step", 0)),
                    coords_spec=coords.to_spec(),
                    model_meta=model_meta(None, model),
                    alpha_masks=masks)
    return {"out": out_path, "global_step": int(ckpt.get("global_step", 0)),
            "resolution": spec["resolution"],
            "use_envmap": cfg.use_envmap,
            "alpha_masks": bool(masks)}


def main(argv=None) -> None:
    """JAX's command line: two positionals and ``--reference=DIR``; prints
    :func:`convert`'s dict as one JSON line."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("-")]
    if len(args) != 2:
        raise SystemExit(__doc__)
    reference = REFERENCE
    for a in argv:
        if a.startswith("--reference="):
            reference = a.split("=", 1)[1]
    print(json.dumps(convert(args[0], args[1], reference)))


if __name__ == "__main__":
    main()
