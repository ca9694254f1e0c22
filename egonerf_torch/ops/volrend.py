"""Volume rendering: ``raw2alpha`` and the composite kernel K6 (counterpart
of ``egonerf_tpu/ops/volrend.py`` and the composite in
``egonerf_tpu/models/egonerf.py:466-493``)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import check_launch, kernel
from .._device import check_tensor

ACTIVATIONS = ("softplus", "relu")


def density_activation(feat: torch.Tensor, shift: float, act: str) -> torch.Tensor:
    """``feature2density``: softplus(feat + shift) as JAX writes it,
    max(x, 0) + log1p(exp(-|x|)), or relu(feat) (no shift)."""
    if act == "softplus":
        x = feat + shift
        return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))
    if act == "relu":
        return feat.clamp_min(0.0)
    raise ValueError(act)


def raw2alpha(sigma: torch.Tensor, dist: torch.Tensor):
    """sigma, dist (..., S) -> (alpha, weights, bg_weight): alpha =
    1 - exp(-sigma*dist), T the prefix product of (1 - alpha + 1e-10),
    weights = alpha * T exclusive, bg_weight = T over the whole ray."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    t_excl = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return alpha, alpha * t_excl, trans[..., -1:]


def composite_plain(feat, dists, z_vals, rgb, ray_dz, density_shift=-8.0,
                    distance_scale=25.0, act="softplus"):
    """Plain version of K6: see :func:`composite`."""
    sigma = density_activation(feat, density_shift, act)
    _, weight, bg_weight = raw2alpha(sigma, dists * distance_scale)
    acc = weight.sum(-1)
    rgb_map = (weight[..., None] * rgb).sum(-2).clamp(0.0, 1.0)
    depth = (weight * z_vals).sum(-1) + (1.0 - acc) * ray_dz
    return rgb_map, depth, acc, bg_weight


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 5


def composite(feat: torch.Tensor, dists: torch.Tensor, z_vals: torch.Tensor,
              rgb: torch.Tensor, ray_dz: torch.Tensor, density_shift: float = -8.0,
              distance_scale: float = 25.0, act: str = "softplus"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: per ray, sigma = feature2density(feat); alpha = 1 -
    exp(-sigma * dists * distance_scale); the exclusive transmittance;
    weights; acc = sum(weights); rgb_map = clip(sum(weights * rgb), 0, 1);
    depth = sum(weights * z) + (1 - acc) * ray_dz (the reference fills the
    background with the z component of the view direction); bg_weight = the
    transmittance over the whole ray.

    feat, dists, z_vals (R, S), rgb (R, S, 3), ray_dz (R,), all float32.
    Returns rgb_map (R, 3), depth (R,), acc (R,), bg_weight (R, 1).

    Replaces ``raw2alpha`` + ``feature2density`` + the composite of
    ``EgoNeRF.forward`` (egonerf_tpu/ops/volrend.py:11-24,
    models/egonerf.py:99-104,466-493), forward only.  Kernel:
    csrc/composite.cu.  CPU tensors take :func:`composite_plain`."""
    check_tensor("feat", feat, torch.float32, (None, None))
    r, s = feat.shape
    for name, t, shape in (("dists", dists, (r, s)), ("z_vals", z_vals, (r, s)),
                           ("rgb", rgb, (r, s, 3)), ("ray_dz", ray_dz, (r,))):
        check_tensor(name, t, torch.float32, shape, feat.device)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown density activation {act!r}")
    if s < 1 or s > 3072:  # the kernel keeps 4 warps x S alphas in 48 KB
        raise ValueError(f"composite takes 1..3072 samples per ray, got {s}")
    if feat.device.type == "cpu":
        return composite_plain(feat, dists, z_vals, rgb, ray_dz, density_shift,
                               distance_scale, act)
    dev = feat.device
    rgb_map = torch.empty(r, 3, dtype=torch.float32, device=dev)
    depth = torch.empty(r, dtype=torch.float32, device=dev)
    acc = torch.empty(r, dtype=torch.float32, device=dev)
    bg = torch.empty(r, 1, dtype=torch.float32, device=dev)
    if r:
        fn = kernel("composite", "composite_fwd", _ARGS)
        with torch.cuda.device(dev):
            err = fn(feat.data_ptr(), dists.data_ptr(), z_vals.data_ptr(),
                     rgb.data_ptr(), ray_dz.data_ptr(), r, s, float(density_shift),
                     float(distance_scale), ACTIVATIONS.index(act),
                     rgb_map.data_ptr(), depth.data_ptr(), acc.data_ptr(),
                     bg.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("composite_fwd", err)
        composite.launches += 1
    return rgb_map, depth, acc, bg


composite.launches = 0
