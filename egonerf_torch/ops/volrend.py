"""Volume rendering: ``raw2alpha``, the composite kernel K6 and its
backward K6b (counterpart of ``egonerf_tpu/ops/volrend.py`` and the
composite in ``egonerf_tpu/models/egonerf.py:466-493``)."""
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


def clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip(x, 0, 1) / dx as JAX's ``jnp.clip`` gives it: 1 inside
    (0, 1), 1/2 at exactly 0 or 1 (its max and min split ties), else 0."""
    inside = ((x > 0.0) & (x < 1.0)).to(x.dtype)
    edge = ((x == 0.0) | (x == 1.0)).to(x.dtype)
    return inside + 0.5 * edge


def composite_bwd_plain(feat, dists, rgb, d_rgb_map, density_shift=-8.0,
                        distance_scale=25.0, act="softplus"):
    """Plain version of K6b: see :func:`composite_bwd`.  torch autograd
    through the forward of :func:`composite_plain`, with the slopes the
    kernel uses: sigmoid(feat + shift) for softplus, [feat > 0] for relu,
    and JAX's clip gradient."""
    with torch.enable_grad():
        f = feat.detach().requires_grad_(True)
        c = rgb.detach().requires_grad_(True)
        slope = (torch.sigmoid(f + density_shift) if act == "softplus"
                 else (f > 0.0).to(f.dtype)).detach()
        # the forward's sigma to the bit, with d sigma / d feat = slope
        sigma = density_activation(f, density_shift, act).detach() + (f - f.detach()) * slope
        _, weight, _ = raw2alpha(sigma, dists * distance_scale)
        x = (weight[..., None] * c).sum(-2)
        d_feat, d_rgb = torch.autograd.grad(x, (f, c), d_rgb_map * clip_grad(x.detach()))
    return d_feat, d_rgb


_BWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3


def composite_bwd(feat: torch.Tensor, dists: torch.Tensor, rgb: torch.Tensor,
                  d_rgb_map: torch.Tensor, density_shift: float = -8.0,
                  distance_scale: float = 25.0, act: str = "softplus"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6b: the gradient of :func:`composite`'s rgb_map with respect to
    feat and rgb, given d_rgb_map (R, 3).  Per ray it recomputes the
    forward scan and runs the division-free reverse recurrence
    R_j = alpha_j q_j + (1 - alpha_j + 1e-10) R_{j+1}, q_j = rgb_j . g,
    g = d_rgb_map times JAX's clip gradient of the unclipped sum; then
    d alpha_j = T_j (q_j - R_{j+1}) and d rgb_j = w_j g.  depth, acc and
    bg take no gradient (JAX stops depth's; z and dists are constants).

    feat, dists (R, S), rgb (R, S, 3), d_rgb_map (R, 3), float32.  Returns
    d_feat (R, S) and d_rgb (R, S, 3).

    Replaces the autodiff of ``raw2alpha`` + ``feature2density`` + the
    composite (egonerf_tpu/ops/volrend.py:11-24,
    models/egonerf.py:466-493).  Kernel: csrc/composite.cu.  CPU tensors
    take :func:`composite_bwd_plain`."""
    check_tensor("feat", feat, torch.float32, (None, None))
    r, s = feat.shape
    for name, t, shape in (("dists", dists, (r, s)), ("rgb", rgb, (r, s, 3)),
                           ("d_rgb_map", d_rgb_map, (r, 3))):
        check_tensor(name, t, torch.float32, shape, feat.device)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown density activation {act!r}")
    if s < 1 or s > 1536:  # the kernel keeps 4 warps x 2S floats in 48 KB
        raise ValueError(f"composite_bwd takes 1..1536 samples per ray, got {s}")
    if feat.device.type == "cpu":
        return composite_bwd_plain(feat, dists, rgb, d_rgb_map, density_shift,
                                   distance_scale, act)
    dev = feat.device
    d_feat = torch.empty(r, s, dtype=torch.float32, device=dev)
    d_rgb = torch.empty(r, s, 3, dtype=torch.float32, device=dev)
    if r:
        fn = kernel("composite", "composite_bwd", _BWD_ARGS)
        with torch.cuda.device(dev):
            err = fn(feat.data_ptr(), dists.data_ptr(), rgb.data_ptr(), d_rgb_map.data_ptr(),
                     r, s, float(density_shift), float(distance_scale),
                     ACTIVATIONS.index(act), d_feat.data_ptr(), d_rgb.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("composite_bwd", err)
        composite_bwd.launches += 1
    return d_feat, d_rgb


composite_bwd.launches = 0


class _Composite(torch.autograd.Function):
    """K6 forward, K6b backward (``fwd`` and ``bwd`` are an ``Ops`` pair,
    so the plain versions run through the same Function)."""

    @staticmethod
    def forward(ctx, feat, dists, z_vals, rgb, ray_dz, density_shift, distance_scale, act,
                fwd, bwd):
        outs = fwd(feat, dists, z_vals, rgb, ray_dz, density_shift, distance_scale, act)
        ctx.save_for_backward(feat, dists, rgb)
        ctx.args = (density_shift, distance_scale, act, bwd)
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    def backward(ctx, d_rgb_map, *_):
        feat, dists, rgb = ctx.saved_tensors
        shift, scale, act, bwd = ctx.args
        d_feat, d_rgb = bwd(feat, dists, rgb, d_rgb_map.contiguous(), shift, scale, act)
        return d_feat, None, None, d_rgb, None, None, None, None, None, None


def composite_train(feat, dists, z_vals, rgb, ray_dz, density_shift, distance_scale, act,
                    fwd=composite, bwd=composite_bwd):
    """:func:`composite` with a gradient: rgb_map is differentiable in feat
    and rgb through ``bwd`` (K6b); depth, acc and bg are not."""
    return _Composite.apply(feat, dists, z_vals, rgb, ray_dz, density_shift, distance_scale,
                            act, fwd, bwd)
