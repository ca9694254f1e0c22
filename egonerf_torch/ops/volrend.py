"""Volume rendering: ``raw2alpha``, the composite kernel K6 and its
backward K6b (counterpart of ``egonerf_tpu/ops/volrend.py`` and the
composites of ``egonerf_tpu/models/egonerf.py:466-493`` and
``models/tensorf.py:226-258``), with the envmap's background blend where
the caller gives its radiance or, K6e, the envmap's table and the view
directions (K8's lookup inside the composite), and TensoRF's two sample
gates where the caller gives them: ``valid`` (sigma 0 outside the box and
the alpha mask) and ``rgb_thres`` (rgb 0 where the weight is not above
it).  For the entropy loss, :func:`ray_entropy` (JAX's arithmetic in plain
torch), K6's training instantiation writes each sample's alpha
(``with_alpha``) and K6b's takes its cotangent (``d_alpha``)."""
from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from .._build import check_launch, kernel
from .._device import check_rows, check_tensor
from .envmap import INV_2PI, envmap_bwd, envmap_fwd_plain

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


def ray_entropy(alpha: torch.Tensor) -> torch.Tensor:
    """The InfoNeRF ray entropy of (R, S) alphas (JAX
    ``egonerf_tpu/ops/volrend.py:27-32``): prob = alpha / (sum alpha +
    1e-10) per ray, -sum prob log2(prob + 1e-10), averaged over the rays."""
    prob = alpha / (alpha.sum(-1, keepdim=True) + 1e-10)
    return (-(prob * torch.log2(prob + 1e-10)).sum(-1)).mean()


# The per-ray kernels (K4, K6, K6b) keep a ray on one warp: lane l owns the
# contiguous chunk [l per, (l + 1) per) of its samples, per = ceil(n / 32),
# and the products and sums across lanes are the scans and the butterfly of
# csrc/warp_scan.cuh.  The plain versions take them in that order, so that a
# decision on a weight (K4's fine samples, TensoRF's rgb gate) is the
# kernels' to the bit.
WARP = 32


def _lane_chunks(x: torch.Tensor, identity: float) -> torch.Tensor:
    """(R, n) -> (R, 32, per): each lane's chunk, padded with ``identity``."""
    per = -(-x.shape[1] // WARP)
    x = torch.nn.functional.pad(x, (0, WARP * per - x.shape[1]), value=identity)
    return x.reshape(x.shape[0], WARP, per)


def _chunk_fold(chunks: torch.Tensor, op) -> torch.Tensor:
    """(R, 32, per) -> (R, 32): each lane's chunk folded left to right."""
    acc = chunks[..., 0]
    for j in range(1, chunks.shape[-1]):
        acc = op(acc, chunks[..., j])
    return acc


def _warp_inclusive_scan(v: torch.Tensor, op) -> torch.Tensor:
    """(R, 32): Hillis-Steele over the offsets 1, 2, 4, 8, 16."""
    for off in (1, 2, 4, 8, 16):
        v = torch.cat([v[:, :off], op(v[:, off:], v[:, :-off])], dim=1)
    return v


def _warp_exclusive_scan(v: torch.Tensor, op, identity: float) -> torch.Tensor:
    """(R, 32): ``warp_exclusive_prod`` / ``_sum``: the inclusive scan
    shifted by one lane."""
    v = _warp_inclusive_scan(v, op)
    return torch.cat([torch.full_like(v[:, :1], identity), v[:, :-1]], dim=1)


def _warp_transmittance(alpha: torch.Tensor):
    """raw2alpha's weights alpha * exclusive transmittance (R, S) and the
    transmittance over the whole ray (R, 1), in the kernels' order."""
    s = alpha.shape[1]
    f = _lane_chunks(1.0 - alpha + 1e-10, 1.0)
    al = _lane_chunks(alpha, 0.0)
    incl = _warp_inclusive_scan(_chunk_fold(f, torch.mul), torch.mul)
    t = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    w = []
    for j in range(f.shape[-1]):
        w.append(al[..., j] * t)
        t = t * f[..., j]
    return torch.stack(w, dim=-1).reshape(alpha.shape[0], -1)[:, :s], incl[:, -1:]


def _warp_weights(alpha: torch.Tensor) -> torch.Tensor:
    """raw2alpha's weights alpha * exclusive transmittance, in K4's order."""
    return _warp_transmittance(alpha)[0]


def _alpha(feat, dists, density_shift, distance_scale, act, valid=None):
    """alpha = 1 - exp(-sigma * dists * distance_scale) with sigma =
    feature2density(feat), 0 where ``valid`` is False."""
    sigma = density_activation(feat, density_shift, act)
    if valid is not None:
        sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
    return 1.0 - torch.exp(-sigma * (dists * distance_scale))


def _gate(weight: torch.Tensor, rgb: torch.Tensor, rgb_thres: Optional[float]):
    """rgb where weight > rgb_thres, else 0 (no gate for None)."""
    if rgb_thres is None:
        return rgb
    return torch.where((weight > rgb_thres)[..., None], rgb, torch.zeros_like(rgb))


def composite_plain(feat, dists, z_vals, rgb, ray_dz, density_shift=-8.0,
                    distance_scale=25.0, act="softplus", env=None, valid=None, rgb_thres=None,
                    envmap=None, viewdirs=None, with_alpha=False):
    """Plain version of K6 and K6e: see :func:`composite`.  The
    transmittance is taken in K6's order, so the rgb gate decides as K6
    does; K6e's radiance is K8's plain version."""
    if envmap is not None:
        env = envmap_fwd_plain(envmap, viewdirs)
        outs = composite_plain(feat, dists, z_vals, rgb, ray_dz, density_shift, distance_scale,
                               act, env, valid, rgb_thres, with_alpha=with_alpha)
        return outs[:5] + (env,) + outs[5:]
    alpha = _alpha(feat, dists, density_shift, distance_scale, act, valid)
    weight, bg_weight = _warp_transmittance(alpha)
    rgb = _gate(weight, rgb, rgb_thres)
    acc = weight.sum(-1)
    x = (weight[..., None] * rgb).sum(-2)
    depth = (weight * z_vals).sum(-1) + (1.0 - acc) * ray_dz
    if env is None:
        outs = (x.clamp(0.0, 1.0), depth, acc, bg_weight)
    else:
        bg_map = bg_weight * env
        outs = ((x + bg_map).clamp(0.0, 1.0), depth, acc, bg_weight, bg_map)
    return outs + (alpha,) if with_alpha else outs


_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float] + \
    [ctypes.c_void_p] * 6
# composite_fwd_alpha: alpha_out before the stream
_ALPHA_ARGS = _ARGS[:-1] + [ctypes.c_void_p] * 2


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_gates(valid, rgb_thres, r, s, device):
    """The gates as the kernels take them: ``valid`` as bytes (or None) and
    the threshold, -inf for no gate (every weight passes)."""
    if valid is not None:
        check_tensor("valid", valid, torch.bool, (r, s), device)
    return -math.inf if rgb_thres is None else float(rgb_thres)


def composite(feat: torch.Tensor, dists: torch.Tensor, z_vals: torch.Tensor,
              rgb: torch.Tensor, ray_dz: torch.Tensor, density_shift: float = -8.0,
              distance_scale: float = 25.0, act: str = "softplus",
              env: Optional[torch.Tensor] = None, valid: Optional[torch.Tensor] = None,
              rgb_thres: Optional[float] = None, envmap: Optional[torch.Tensor] = None,
              viewdirs: Optional[torch.Tensor] = None,
              with_alpha: bool = False) -> Tuple[torch.Tensor, ...]:
    """K6: per ray, sigma = feature2density(feat), 0 where ``valid`` is
    False; alpha = 1 -
    exp(-sigma * dists * distance_scale); the exclusive transmittance;
    weights; acc = sum(weights); rgb_map = clip(sum(weights * rgb), 0, 1);
    depth = sum(weights * z) + (1 - acc) * ray_dz (the reference fills the
    background with the z component of the view direction); bg_weight = the
    transmittance over the whole ray.  With the envmap radiance ``env`` the
    background is a last sample of alpha 1: bg_map = bg_weight * env and
    rgb_map = clip(sum(weights * rgb) + bg_map, 0, 1), the clip after the
    blend.  With ``rgb_thres`` a sample's rgb counts only where its weight
    is above it (TensoRF's ``ray_march_weight_thres``); acc and depth keep
    every weight.

    K6e: with the envmap's ``envmap`` table (2h, h, 3) and ``viewdirs``
    (R, 3; any row stride, the (R, 6) rays' columns 3:6) in place of
    ``env``, the kernel computes env as K8 does (:func:`envmap.envmap_fwd`,
    the same bits) and blends it as above; no gates with it.

    feat, dists, z_vals (R, S), rgb (R, S, 3), ray_dz (R,), env (R, 3) or
    None, all float32; valid (R, S) bool or None.  Returns rgb_map (R, 3),
    depth (R,), acc (R,), bg_weight (R, 1), and bg_map (R, 3) with ``env``;
    with ``envmap`` also env (R, 3) after bg_map; with ``with_alpha`` (the
    training instantiation, for the entropy loss) last each sample's alpha
    (R, S), 0 where ``valid`` is False.

    Replaces ``raw2alpha`` + ``feature2density`` + the composite of
    ``EgoNeRF.forward`` with its envmap blend and of ``TensorBase.forward``
    with its gates (egonerf_tpu/ops/volrend.py:11-24,
    models/egonerf.py:99-104,466-493, models/tensorf.py:226-258), forward
    only; K6e also ``envmap_radiance`` (egonerf_tpu/models/envmap.py:39-43).
    Kernel: csrc/composite.cu (+ csrc/envmap.cuh).  A launch counts in
    ``composite.launches``, with ``env`` in ``composite.env_form.launches``
    and with ``envmap`` in ``composite.envmap_form.launches`` instead; with
    ``with_alpha`` also in ``composite.alpha_form.launches``.  CPU tensors
    take :func:`composite_plain`."""
    check_tensor("feat", feat, torch.float32, (None, None))
    r, s = feat.shape
    for name, t, shape in (("dists", dists, (r, s)), ("z_vals", z_vals, (r, s)),
                           ("rgb", rgb, (r, s, 3)), ("ray_dz", ray_dz, (r,))):
        check_tensor(name, t, torch.float32, shape, feat.device)
    if env is not None:
        check_tensor("env", env, torch.float32, (r, 3), feat.device)
    h = 0
    if envmap is not None:
        if env is not None or valid is not None or rgb_thres is not None:
            raise ValueError("composite: the envmap form takes no env and no gates")
        check_tensor("envmap", envmap, torch.float32, (None, None, 3), feat.device)
        h = envmap.shape[1]
        if h < 2 or envmap.shape[0] != 2 * h:
            raise ValueError(f"envmap: expected shape (2h, h, 3) with h >= 2, got "
                             f"{tuple(envmap.shape)}")
        check_rows("viewdirs", viewdirs, r, 3, feat.device)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown density activation {act!r}")
    if s < 1 or s > 3072:  # the kernel keeps 4 warps x S alphas in 48 KB
        raise ValueError(f"composite takes 1..3072 samples per ray, got {s}")
    thres = _check_gates(valid, rgb_thres, r, s, feat.device)
    if feat.device.type == "cpu":
        return composite_plain(feat, dists, z_vals, rgb, ray_dz, density_shift,
                               distance_scale, act, env, valid, rgb_thres, envmap, viewdirs,
                               with_alpha)
    dev = feat.device
    rgb_map = torch.empty(r, 3, dtype=torch.float32, device=dev)
    depth = torch.empty(r, dtype=torch.float32, device=dev)
    acc = torch.empty(r, dtype=torch.float32, device=dev)
    bg = torch.empty(r, 1, dtype=torch.float32, device=dev)
    blend = env is not None or envmap is not None
    bg_map = torch.empty(r, 3, dtype=torch.float32, device=dev) if blend else None
    env_out = None if envmap is None else torch.empty(r, 3, dtype=torch.float32, device=dev)
    alpha = torch.empty(r, s, dtype=torch.float32, device=dev) if with_alpha else None
    if r:
        name = "composite_fwd_alpha" if with_alpha else "composite_fwd"
        fn = kernel("composite", name, _ALPHA_ARGS if with_alpha else _ARGS)
        with torch.cuda.device(dev):
            err = fn(feat.data_ptr(), dists.data_ptr(), z_vals.data_ptr(),
                     rgb.data_ptr(), ray_dz.data_ptr(), _ptr(env), _ptr(valid), _ptr(viewdirs),
                     0 if viewdirs is None else viewdirs.stride(0), _ptr(envmap), h, INV_2PI,
                     _ptr(env_out), r, s, float(density_shift), float(distance_scale),
                     ACTIVATIONS.index(act), thres, rgb_map.data_ptr(), depth.data_ptr(),
                     acc.data_ptr(), bg.data_ptr(), _ptr(bg_map),
                     *((alpha.data_ptr(),) if with_alpha else ()),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch(name, err)
        (composite if not blend else composite.envmap_form if envmap is not None
         else composite.env_form).launches += 1
        if with_alpha:
            composite.alpha_form.launches += 1
    outs = (rgb_map, depth, acc, bg)
    if envmap is not None:
        outs += (bg_map, env_out)
    elif env is not None:
        outs += (bg_map,)
    return outs + (alpha,) if with_alpha else outs


# K6's launches, and those of its two background forms apart: K6 with a
# given env and K6e; the training instantiation's (alpha out) also apart,
# in whichever form
composite.launches = 0
composite.env_form = SimpleNamespace(launches=0)
composite.envmap_form = SimpleNamespace(launches=0)
composite.alpha_form = SimpleNamespace(launches=0)


def clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip(x, 0, 1) / dx as JAX's ``jnp.clip`` gives it: 1 inside
    (0, 1), 1/2 at exactly 0 or 1 (its max and min split ties), else 0."""
    inside = ((x > 0.0) & (x < 1.0)).to(x.dtype)
    edge = ((x == 0.0) | (x == 1.0)).to(x.dtype)
    return inside + 0.5 * edge


def composite_bwd_plain(feat, dists, rgb, d_rgb_map, density_shift=-8.0,
                        distance_scale=25.0, act="softplus", env=None, valid=None,
                        rgb_thres=None, d_alpha=None):
    """Plain version of K6b: see :func:`composite_bwd`.  torch autograd
    through the forward of :func:`composite_plain`, with the slopes the
    kernel uses: sigmoid(feat + shift) for softplus, [feat > 0] for relu,
    and JAX's clip gradient; the rgb gate is a constant mask; ``d_alpha``
    the cotangent of the alphas themselves."""
    with torch.enable_grad():
        f = feat.detach().requires_grad_(True)
        c = rgb.detach().requires_grad_(True)
        slope = (torch.sigmoid(f + density_shift) if act == "softplus"
                 else (f > 0.0).to(f.dtype)).detach()
        # the forward's sigma to the bit, with d sigma / d feat = slope
        sigma = density_activation(f, density_shift, act).detach() + (f - f.detach()) * slope
        if valid is not None:
            sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
        alpha = 1.0 - torch.exp(-sigma * (dists * distance_scale))
        weight, bg_weight = _warp_transmittance(alpha)
        x = (weight[..., None] * _gate(weight.detach(), c, rgb_thres)).sum(-2)
        leaves = (f, c)
        if env is not None:
            e = env.detach().requires_grad_(True)
            x = x + bg_weight * e
            leaves += (e,)
        outs, cots = [x], [d_rgb_map * clip_grad(x.detach())]
        if d_alpha is not None:
            outs.append(alpha)
            cots.append(d_alpha)
        return torch.autograd.grad(outs, leaves, cots)


_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_int, ctypes.c_float] + \
    [ctypes.c_void_p] * 4
# composite_bwd_alpha: d_alpha after valid
_BWD_ALPHA_ARGS = _BWD_ARGS[:6] + [ctypes.c_void_p] + _BWD_ARGS[6:]

_GEOMETRY_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def bwd_geometry(s: int, gated: bool = False, device=None,
                 d_alpha: bool = False) -> Tuple[int, int]:
    """K6b's launch geometry on a CUDA ``device`` (the current one by
    default) for rays of ``s`` samples, as :func:`composite_bwd`'s entry
    chooses it (``gated``: its gated instantiation; ``d_alpha``: its
    training one): (warps a block, the block's dynamic shared bytes)."""
    warps, smem = ctypes.c_int(), ctypes.c_int()
    fn = kernel("composite",
                "composite_bwd_alpha_geometry" if d_alpha else "composite_bwd_geometry",
                _GEOMETRY_ARGS)
    with torch.cuda.device(device):
        err = fn(s, int(gated), ctypes.addressof(warps), ctypes.addressof(smem))
    check_launch("composite_bwd_geometry", err)
    return warps.value, smem.value


def composite_bwd(feat: torch.Tensor, dists: torch.Tensor, rgb: torch.Tensor,
                  d_rgb_map: torch.Tensor, density_shift: float = -8.0,
                  distance_scale: float = 25.0, act: str = "softplus",
                  env: Optional[torch.Tensor] = None, valid: Optional[torch.Tensor] = None,
                  rgb_thres: Optional[float] = None,
                  d_alpha: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """K6b: the gradient of :func:`composite`'s rgb_map with respect to
    feat and rgb (and ``env``, where given), given d_rgb_map (R, 3).  Per
    ray it recomputes the forward scan and runs the division-free reverse
    recurrence R_j = alpha_j q_j + (1 - alpha_j + 1e-10) R_{j+1},
    q_j = rgb_j . g, from R_{S+1} = env . g (0 without the envmap: JAX's
    background is a last sample of alpha 1), g = d_rgb_map times JAX's clip
    gradient of the blended sum; then d alpha_j = T_j (q_j - R_{j+1}),
    d rgb_j = w_j g and d env = bg_weight g.  A sample the rgb gate drops
    has q_j = 0 and d rgb_j = 0 (the gate recomputes K6's weight with K6's
    arithmetic, so both decide alike); d feat_j = 0 where ``valid`` is
    False.  With ``d_alpha`` (R, S), the cotangent of the training
    instantiation's alphas (the entropy loss's), the training instantiation
    adds it into d alpha_j before the chain to d feat_j.  depth, acc and bg
    take no gradient (JAX stops depth's; z and dists are constants), so
    the depth loss has no cotangent here.

    feat, dists (R, S), rgb (R, S, 3), d_rgb_map (R, 3), env (R, 3) or
    None, d_alpha (R, S) or None, float32; valid (R, S) bool or None.
    Returns d_feat (R, S) and d_rgb (R, S, 3), and d_env (R, 3) with
    ``env``.

    Replaces the autodiff of ``raw2alpha`` + ``feature2density`` + the
    composite with its envmap blend or its gates
    (egonerf_tpu/ops/volrend.py:11-24, models/egonerf.py:466-493,
    models/tensorf.py:226-258), and of ``ray_entropy`` into the alphas
    (``ops/volrend.py:27-32``).  Kernel: csrc/composite.cu.  A launch counts
    in ``composite_bwd.launches``, with ``d_alpha`` also in
    ``composite_bwd.alpha_form.launches``.  CPU tensors take
    :func:`composite_bwd_plain`."""
    check_tensor("feat", feat, torch.float32, (None, None))
    r, s = feat.shape
    for name, t, shape in (("dists", dists, (r, s)), ("rgb", rgb, (r, s, 3)),
                           ("d_rgb_map", d_rgb_map, (r, 3))):
        check_tensor(name, t, torch.float32, shape, feat.device)
    if d_alpha is not None:
        check_tensor("d_alpha", d_alpha, torch.float32, (r, s), feat.device)
    if env is not None:
        check_tensor("env", env, torch.float32, (r, 3), feat.device)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown density activation {act!r}")
    if s < 1 or s > 1536:  # a ray's staged rows within the 48 KB of a one-warp block
        raise ValueError(f"composite_bwd takes 1..1536 samples per ray, got {s}")
    thres = _check_gates(valid, rgb_thres, r, s, feat.device)
    if feat.device.type == "cpu":
        return composite_bwd_plain(feat, dists, rgb, d_rgb_map, density_shift,
                                   distance_scale, act, env, valid, rgb_thres, d_alpha)
    dev = feat.device
    d_feat = torch.empty(r, s, dtype=torch.float32, device=dev)
    d_rgb = torch.empty(r, s, 3, dtype=torch.float32, device=dev)
    d_env = None if env is None else torch.empty(r, 3, dtype=torch.float32, device=dev)
    if r:
        name = "composite_bwd" if d_alpha is None else "composite_bwd_alpha"
        fn = kernel("composite", name, _BWD_ARGS if d_alpha is None else _BWD_ALPHA_ARGS)
        with torch.cuda.device(dev):
            err = fn(feat.data_ptr(), dists.data_ptr(), rgb.data_ptr(), d_rgb_map.data_ptr(),
                     _ptr(env), _ptr(valid), *(() if d_alpha is None else (d_alpha.data_ptr(),)),
                     r, s, float(density_shift), float(distance_scale),
                     ACTIVATIONS.index(act), thres, d_feat.data_ptr(), d_rgb.data_ptr(),
                     _ptr(d_env), torch.cuda.current_stream(dev).cuda_stream)
        check_launch(name, err)
        composite_bwd.launches += 1
        if d_alpha is not None:
            composite_bwd.alpha_form.launches += 1
    return (d_feat, d_rgb) if env is None else (d_feat, d_rgb, d_env)


composite_bwd.launches = 0
composite_bwd.alpha_form = SimpleNamespace(launches=0)


class _Composite(torch.autograd.Function):
    """K6 forward, K6b backward (``fwd`` and ``bwd`` are an ``Ops`` pair,
    so the plain versions run through the same Function).  In the envmap
    form (K6e) the table takes its gradient from K6b's d env through
    ``env_bwd`` (K8b), given K6e's env.  With ``with_alpha`` the training
    instantiations run: alpha, the last output, is differentiable too, and
    its cotangent goes to K6b as ``d_alpha``."""

    @staticmethod
    def forward(ctx, feat, dists, z_vals, rgb, ray_dz, env, valid, envmap, viewdirs,
                density_shift, distance_scale, act, rgb_thres, fwd, bwd, env_bwd, with_alpha):
        kw = {"with_alpha": True} if with_alpha else {}
        outs = fwd(feat, dists, z_vals, rgb, ray_dz, density_shift, distance_scale, act, env,
                   valid, rgb_thres, envmap, viewdirs, **kw)
        if envmap is not None:
            env = outs[5]
        ctx.save_for_backward(feat, dists, rgb, env, valid, viewdirs)
        ctx.args = (density_shift, distance_scale, act, rgb_thres, bwd, env_bwd,
                    None if envmap is None else envmap.shape[1], with_alpha)
        ctx.mark_non_differentiable(*outs[1:len(outs) - int(with_alpha)])
        return outs

    @staticmethod
    def backward(ctx, d_rgb_map, *rest):
        feat, dists, rgb, env, valid, viewdirs = ctx.saved_tensors
        shift, scale, act, rgb_thres, bwd, env_bwd, h, with_alpha = ctx.args
        kw = {"d_alpha": rest[-1].contiguous()} if with_alpha else {}
        grads = bwd(feat, dists, rgb, d_rgb_map.contiguous(), shift, scale, act, env, valid,
                    rgb_thres, **kw)
        d_env = grads[2] if env is not None else None
        d_table = None
        if h is not None:
            d_table, d_env = env_bwd(viewdirs, env, d_env, h), None
        return (grads[0], None, None, grads[1], None, d_env, None, d_table) + (None,) * 9


def composite_train(feat, dists, z_vals, rgb, ray_dz, density_shift, distance_scale, act,
                    fwd=composite, bwd=composite_bwd, env=None, valid=None, rgb_thres=None,
                    envmap=None, viewdirs=None, env_bwd=envmap_bwd, with_alpha=False):
    """:func:`composite` with a gradient: rgb_map is differentiable in feat
    and rgb (and ``env``, or the ``envmap`` table through ``env_bwd``, K8b)
    through ``bwd`` (K6b); depth, acc, bg, bg_map and K6e's env are not.
    With ``with_alpha`` the alphas (R, S) come last, differentiable in feat
    (K6b's ``d_alpha``)."""
    return _Composite.apply(feat, dists, z_vals, rgb, ray_dz, env, valid, envmap, viewdirs,
                            density_shift, distance_scale, act, rgb_thres, fwd, bwd, env_bwd,
                            with_alpha)
