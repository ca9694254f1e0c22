"""Hierarchical inverse-CDF resampling: plain ``sample_pdf`` and kernel K4.

Counterpart of ``egonerf_tpu/ops/pdf.py``.  K4 fuses, per ray, the coarse
weights (``raw2alpha`` on the coarse density), the pdf and cdf over the
interior weights, the inverse-CDF draw, the merge with the coarse depths
(``ops/merge.py``) and the ``dists`` diff of ``EgoNeRF.forward``;
:func:`resample_chart` also writes the chart of the merged depths (K7's
function) from the same launch, :func:`resample_weights` the coarse
weights instead, and :func:`resample_score` (K4c, the empty-space cull's
coarse pass) each merged sample's cull score, K12's function on those
weights.

``u`` comes from one of three sources: given, drawn from a ``draw`` key
``(seed, step)``, or neither (eval's linspace).  With the key, the
training instantiations of K4 and K4c draw K5's sorted uniforms
(``ops/merge.py::sorted_uniform``) in a prologue, bit for bit what K5
writes, so the training step launches no K5; the plain versions take
:func:`~egonerf_torch.ops.merge.sorted_uniform_plain` for the key.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from .._build import check_launch, kernel
from .._device import check_tensor
from ..coords.yinyang import YinYangSphericalCoords
from .chart import CHART_ARGS, _recip, chart_args, chart_fwd_plain, check_rays
from .cull import coarse_importance_plain
from .merge import check_ray0, merge_sorted, sorted_uniform_plain
from .philox import MASK
from .volrend import (ACTIVATIONS, _chunk_fold, _lane_chunks, _warp_exclusive_scan,
                      _warp_weights, density_activation, raw2alpha)


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA computes it, bit for bit:
    i * float32(1 / (n-1)) (XLA turns the division by a constant into a
    product with its reciprocal), then 1.  The reciprocal goes in as a
    Python scalar (exactly the float32 value): a tensor made from a host
    value would copy from pageable memory, which waits for the stream."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    recip = float(np.float32(1.0) / np.float32(n - 1))
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([step, torch.ones(1, dtype=torch.float32, device=device)])


def _warp_cdf(weights: torch.Tensor) -> torch.Tensor:
    """K4 keeps a ray on one warp, as K6 does (``volrend._lane_chunks``).
    The cdf of ``weights`` + 1e-5 with its leading 0, in K4's order: the
    total by a butterfly of the lanes' chunk sums, the cumulative sum by
    an exclusive scan of them."""
    m = weights.shape[1]
    x = weights + 1e-5
    total = _chunk_fold(_lane_chunks(x, 0.0), torch.add)
    for half in (16, 8, 4, 2, 1):
        total = total[:, :half] + total[:, half:2 * half]
    pdf = _lane_chunks(x / total, 0.0)
    c = _warp_exclusive_scan(_chunk_fold(pdf, torch.add), torch.add, 0.0)
    cdf = []
    for j in range(pdf.shape[-1]):
        c = c + pdf[..., j]
        cdf.append(c)
    cdf = torch.stack(cdf, dim=-1).reshape(x.shape[0], -1)[:, :m]
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw ``n_samples`` depths per ray from the piecewise-constant pdf.

    bins (N, B) bin edges, weights (N, B-1) unnormalized mass per bin; ``u``
    (N, n_samples) uniforms, or None for the eval-mode linspace.  The pdf
    is weights + 1e-5 over their sum, its cdf summed in K4's order.  The
    bracket is ``searchsorted(cdf, u, right)``; u >= cdf[-1] clamps to the
    last edge, and a bracket narrower than 1e-5 divides by 1."""
    cdf = _warp_cdf(weights)
    n, b = cdf.shape
    if u is None:
        u = linspace01(n_samples, cdf.device).expand(n, n_samples)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp_min(0)
    above = torch.where(inds < b, inds, below)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bins_lo = torch.gather(bins, 1, below)
    bins_hi = torch.gather(bins, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bins_lo + t * (bins_hi - bins_lo)


def _dists(z: torch.Tensor) -> torch.Tensor:
    d = z[:, 1:] - z[:, :-1]
    return torch.cat([d, d[:, -1:]], dim=-1)


def _drawn_u(c_feat, n_fine, u, draw, ray0=0):
    """The plain versions' u: ``u`` as given, K5's plain draws for the
    ``draw`` key (seed, step) at the ray offset ``ray0``, or None (eval's
    linspace); both raises."""
    if draw is None:
        if ray0:
            raise ValueError("resample: a ray offset needs a draw key")
        return u
    if u is not None:
        raise ValueError("resample: pass u or a draw key, not both")
    return sorted_uniform_plain(c_feat.shape[0], n_fine, draw[0], draw[1], c_feat.device,
                                check_ray0(ray0))


def resample_weights_plain(c_feat, coarse_z, coarse_dists, n_fine, u=None,
                           use_coarse_sample=True, density_shift=-8.0,
                           distance_scale=25.0, act="softplus"):
    """Plain version of K4 with the coarse weights: see
    :func:`resample_weights`.  raw2alpha's weights and :func:`sample_pdf`
    with their products and sums in K4's order."""
    sigma = density_activation(c_feat, density_shift, act)
    alpha, _, _ = raw2alpha(sigma, coarse_dists * distance_scale)
    weights = _warp_weights(alpha)
    z_mid = 0.5 * (coarse_z[:, 1:] + coarse_z[:, :-1])
    fine_z = sample_pdf(z_mid, weights[:, 1:-1], n_fine, u)
    z_vals = merge_sorted(coarse_z, fine_z) if use_coarse_sample else fine_z
    return z_vals, _dists(z_vals), weights.contiguous()


def resample_score_plain(c_feat, coarse_z, coarse_dists, n_fine, u=None,
                         use_coarse_sample=True, density_shift=-8.0, distance_scale=25.0,
                         act="softplus", draw=None, ray0=0):
    """Plain version of K4c: see :func:`resample_score`.
    :func:`resample_weights_plain`, then K12's plain version on its merged
    depths and weights."""
    u = _drawn_u(c_feat, n_fine, u, draw, ray0)
    z_vals, dists, weights = resample_weights_plain(c_feat, coarse_z, coarse_dists, n_fine, u,
                                                    use_coarse_sample, density_shift,
                                                    distance_scale, act)
    return z_vals, dists, coarse_importance_plain(z_vals, coarse_z, weights)


def resample_plain(c_feat, coarse_z, coarse_dists, n_fine, u=None,
                   use_coarse_sample=True, density_shift=-8.0,
                   distance_scale=25.0, act="softplus"):
    """Plain version of K4: see :func:`resample`."""
    return resample_weights_plain(c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample,
                                  density_shift, distance_scale, act)[:2]


def resample_chart_plain(c_feat, coarse_z, coarse_dists, n_fine, u=None,
                         use_coarse_sample=True, density_shift=-8.0, distance_scale=25.0,
                         act="softplus", rays_o=None, viewdirs=None, coords=None, draw=None,
                         ray0=0):
    """Plain version of K4 with its chart epilogue: :func:`resample_plain`,
    then :func:`~egonerf_torch.ops.chart.chart_fwd_plain` of the depths."""
    u = _drawn_u(c_feat, n_fine, u, draw, ray0)
    z_vals, dists = resample_plain(c_feat, coarse_z, coarse_dists, n_fine, u,
                                   use_coarse_sample, density_shift, distance_scale, act)
    return z_vals, dists, chart_fwd_plain(rays_o, viewdirs, z_vals, coords)


_BASE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * 4
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2)
_ARGS = _BASE_ARGS + [ctypes.c_void_p]
_WEIGHTS_ARGS = _BASE_ARGS + [ctypes.c_void_p] * 2
_CHART_ARGS = _BASE_ARGS + [ctypes.c_void_p, ctypes.c_longlong] * 2 + CHART_ARGS + \
    [ctypes.c_void_p] * 2


def _draw_args(argtypes: list) -> list:
    """The argument types of an entry's training instantiation
    (``*_draw_fwd``): the key's two words and the ray offset in place of u,
    its stride and eval's step."""
    return argtypes[:3] + [ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong] + argtypes[6:]


SMEM_BYTES = 232448  # the shared memory a block may opt into on sm_90
# K4c keeps a lane's runs of ceil(S / 32) coarse samples and ceil(F / 32)
# draws in registers, 16 at most: S and T up to K13's limit
MAX_SCORE_SAMPLES = 512


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _check(c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample, act, n_grid=0,
           draw=None, ray0=0):
    """The arguments' shapes, and the shapes the kernel takes: 4 warps x
    (3S - 1 + F + T) floats and the radial grid in a block's shared memory,
    and with a ``draw`` key each warp's F + 1 draws (rows 16-byte aligned).
    Returns (R, T)."""
    check_tensor("c_feat", c_feat, torch.float32, (None, None))
    r, s = c_feat.shape
    check_tensor("coarse_z", coarse_z, torch.float32, (r, s), c_feat.device)
    check_tensor("coarse_dists", coarse_dists, torch.float32, (r, s), c_feat.device)
    if u is not None:
        check_tensor("u", u, torch.float32, (r, n_fine), c_feat.device)
        if draw is not None:
            raise ValueError("resample: pass u or a draw key, not both")
    if draw is not None and (len(draw) != 2 or not all(isinstance(k, int) for k in draw)):
        raise TypeError(f"resample: a draw key is two ints (seed, step), got {draw!r}")
    if check_ray0(ray0) and draw is None:
        raise ValueError("resample: a ray offset needs a draw key")
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown density activation {act!r}")
    n_out = s + n_fine if use_coarse_sample else n_fine
    per_warp = 3 * s - 1 + n_fine + n_out
    smem = 4 * (n_grid + 4 * per_warp if draw is None else
                _round4(n_grid) + 4 * (_round4(n_fine + 1) + _round4(per_warp)))
    if s < 3 or n_fine < 1 or n_out < 2 or smem > SMEM_BYTES:
        raise ValueError(f"resample cannot take {s} coarse and {n_fine} fine samples")
    return r, n_out


def _launch(name, argtypes, c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample,
            density_shift, distance_scale, act, n_out, *chart, counters=None, draw=None,
            ray0=0):
    """K4's launch on the card: z_vals and dists, (R, n_out) each, and the
    arguments ``chart`` passed through after them; with a ``draw`` key the
    entry's training instantiation (``name`` with ``_draw_fwd``), which
    draws u for rays ``ray0``, ``ray0`` + 1, ...  A launch counts in each
    of ``counters`` (default: K4's ``resample``)."""
    r, s = c_feat.shape
    dev = c_feat.device
    z_vals = torch.empty(r, n_out, dtype=torch.float32, device=dev)
    dists = torch.empty(r, n_out, dtype=torch.float32, device=dev)
    if r:
        if draw is None:
            # eval's u = linspace01(n_fine) is formed in the kernel from its step
            src = (None if u is None else u.data_ptr(), n_fine,
                   _recip(n_fine - 1) if n_fine > 1 else 0.0)
        else:
            name, argtypes = name.replace("_fwd", "_draw_fwd"), _draw_args(argtypes)
            src = (draw[0] & MASK, draw[1] & MASK, ray0)
        fn = kernel("resample", name, argtypes)
        with torch.cuda.device(dev):
            err = fn(c_feat.data_ptr(), coarse_z.data_ptr(), coarse_dists.data_ptr(),
                     *src, r, s, n_fine, int(bool(use_coarse_sample)), float(density_shift),
                     float(distance_scale), ACTIVATIONS.index(act), z_vals.data_ptr(),
                     dists.data_ptr(), *chart, torch.cuda.current_stream(dev).cuda_stream)
        check_launch(name, err)
        for fn in counters or (resample,):
            fn.launches += 1
    return z_vals, dists


def resample(c_feat: torch.Tensor, coarse_z: torch.Tensor, coarse_dists: torch.Tensor,
             n_fine: int, u: Optional[torch.Tensor] = None,
             use_coarse_sample: bool = True, density_shift: float = -8.0,
             distance_scale: float = 25.0, act: str = "softplus"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: per ray, the coarse weights from feature2density(c_feat) and the
    exclusive transmittance; the pdf over the interior weights [1:-1]
    (+1e-5) and its cdf; ``n_fine`` inverse-CDF draws at ``u`` over the
    coarse midpoints; the merge with the sorted coarse depths (skipped when
    ``use_coarse_sample`` is False); the dists with the last one repeated.

    c_feat, coarse_z, coarse_dists (R, S) float32 with coarse_z sorted;
    u (R, n_fine) uniforms (K5's are sorted; the kernel takes any) or None
    for the eval linspace.  Returns z_vals and dists, (R, S + n_fine) or
    (R, n_fine).  A shape beyond the kernel's shared memory raises.

    Replaces ``sample_pdf`` + ``merge_sorted`` + the coarse ``raw2alpha``
    and the dists diff (egonerf_tpu/ops/pdf.py:14-77, ops/merge.py:39-71,
    ops/volrend.py:11-24, models/egonerf.py:392-411).  Kernel:
    csrc/resample.cu.  CPU tensors take :func:`resample_plain`.
    ``resample.launches`` counts K4's launches, with or without the chart
    epilogue of :func:`resample_chart`, and as :func:`resample_weights`."""
    _, n_out = _check(c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample, act)
    if c_feat.device.type == "cpu":
        return resample_plain(c_feat, coarse_z, coarse_dists, n_fine, u,
                              use_coarse_sample, density_shift, distance_scale, act)
    return _launch("resample_fwd", _ARGS, c_feat, coarse_z, coarse_dists, n_fine, u,
                   use_coarse_sample, density_shift, distance_scale, act, n_out)


def resample_chart(c_feat: torch.Tensor, coarse_z: torch.Tensor, coarse_dists: torch.Tensor,
                   n_fine: int, u: Optional[torch.Tensor] = None,
                   use_coarse_sample: bool = True, density_shift: float = -8.0,
                   distance_scale: float = 25.0, act: str = "softplus",
                   rays_o: Optional[torch.Tensor] = None,
                   viewdirs: Optional[torch.Tensor] = None,
                   coords: Optional[YinYangSphericalCoords] = None,
                   draw: Optional[Tuple[int, int]] = None, ray0: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 with the chart epilogue: :func:`resample`, and from the same
    launch the normalized [r, theta, phi, flag] coords of ``rays_o +
    viewdirs * z`` for every merged depth, in ``coords``' full-resolution
    normalization: what :func:`~egonerf_torch.ops.chart.chart_fwd` gives
    on the returned z_vals, bit for bit (both kernels take the chart from
    csrc/chart.cuh).

    rays_o, viewdirs (R, 3) float32 with unit column stride (any row
    stride).  ``draw``, a key (seed, step) of Python ints in place of
    ``u``: the training instantiation draws K5's sorted uniforms for it in
    its prologue (``sorted_uniform(R, n_fine, seed, step)``, the same bits)
    and counts in ``resample_chart.draw_form.launches`` too; ``ray0``, with
    a key, draws row i as ray ``ray0`` + i (the shard of a global batch
    that starts there draws the global batch's u).  Returns
    z_vals, dists (R, T) and coords (R * T, 4), rows ray-major.

    Replaces the EgoNeRF forward's resampling and the fine chart after it
    (egonerf_tpu/models/egonerf.py:389-406), and in training K5
    (egonerf_tpu/ops/merge.py:25-36).  Kernel: csrc/resample.cu
    (``resample_chart_fwd``; ``resample_chart_draw_fwd`` with a key).  CPU
    tensors take :func:`resample_chart_plain`."""
    if not isinstance(coords, YinYangSphericalCoords):
        raise TypeError("chart takes the yin-yang chart")
    grid = coords.ref_grid if coords.exp_r and coords.interval_th else ()
    r, n_out = _check(c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample, act,
                      len(grid), draw, ray0)
    dev = c_feat.device
    if check_rays(rays_o, viewdirs) != (r, dev):
        raise ValueError("rays_o, viewdirs: expected one ray per row of c_feat, on its device")
    if dev.type == "cpu":
        return resample_chart_plain(c_feat, coarse_z, coarse_dists, n_fine, u,
                                    use_coarse_sample, density_shift, distance_scale, act,
                                    rays_o, viewdirs, coords, draw, ray0)
    norm = torch.empty(r * n_out, 4, dtype=torch.float32, device=dev)
    chart = chart_args(coords, None, dev)
    z_vals, dists = _launch("resample_chart_fwd", _CHART_ARGS, c_feat, coarse_z, coarse_dists,
                            n_fine, u, use_coarse_sample, density_shift, distance_scale, act,
                            n_out, rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(),
                            viewdirs.stride(0), *chart, norm.data_ptr(), draw=draw, ray0=ray0,
                            counters=(resample,) if draw is None else
                            (resample, resample_chart.draw_form))
    return z_vals, dists, norm


def resample_weights(c_feat: torch.Tensor, coarse_z: torch.Tensor,
                     coarse_dists: torch.Tensor, n_fine: int, u: Optional[torch.Tensor] = None,
                     use_coarse_sample: bool = True, density_shift: float = -8.0,
                     distance_scale: float = 25.0, act: str = "softplus"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 with the coarse weights: :func:`resample`'s z_vals and dists,
    and from the same launch the (R, S) weights alpha * exclusive
    transmittance of the coarse samples that the pdf is drawn from, in
    K4's order.  No chart: under the empty-space cull the chart is taken of
    the kept depths.  The cull's oracle scorer takes its depths; the
    coarse scorer takes :func:`resample_score`, which keeps the weights.

    Replaces the EgoNeRF forward's resampling and its coarse weights
    (egonerf_tpu/models/egonerf.py:389-411).
    Kernel: csrc/resample.cu (``resample_weights_fwd``).  CPU tensors take
    :func:`resample_weights_plain`.  A launch counts in ``resample.launches``
    (K4) and in ``resample_weights.launches``."""
    r, n_out = _check(c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample, act)
    if c_feat.device.type == "cpu":
        return resample_weights_plain(c_feat, coarse_z, coarse_dists, n_fine, u,
                                      use_coarse_sample, density_shift, distance_scale, act)
    weights = torch.empty(r, c_feat.shape[1], dtype=torch.float32, device=c_feat.device)
    z_vals, dists = _launch("resample_weights_fwd", _WEIGHTS_ARGS, c_feat, coarse_z,
                            coarse_dists, n_fine, u, use_coarse_sample, density_shift,
                            distance_scale, act, n_out, weights.data_ptr(),
                            counters=(resample, resample_weights))
    return z_vals, dists, weights


def resample_score(c_feat: torch.Tensor, coarse_z: torch.Tensor,
                   coarse_dists: torch.Tensor, n_fine: int, u: Optional[torch.Tensor] = None,
                   use_coarse_sample: bool = True, density_shift: float = -8.0,
                   distance_scale: float = 25.0, act: str = "softplus",
                   draw: Optional[Tuple[int, int]] = None, ray0: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4c, the empty-space cull's coarse pass: :func:`resample`'s z_vals
    and dists, and from the same launch each merged sample's score (R, T):
    K12's function (:func:`~egonerf_torch.ops.cull.coarse_importance`) on
    the coarse weights of :func:`resample_weights`, which never leave the
    kernel.  The z_vals and dists are K4's bit for bit, the
    score K12's plain version's on them.

    The arguments are :func:`resample`'s, with up to ``MAX_SCORE_SAMPLES``
    coarse and merged samples a ray (K13 takes no more), and ``draw`` and
    ``ray0`` as in :func:`resample_chart` (its launches also in
    ``resample_score.draw_form.launches``).

    Replaces the EgoNeRF forward's resampling, its coarse weights and their
    ``coarse_importance`` (egonerf_tpu/models/egonerf.py:389-411, 445;
    egonerf_tpu/ops/cull.py:30-54), and in training K5.  Kernel:
    csrc/resample.cu (``resample_score_fwd``; ``resample_score_draw_fwd``
    with a key).  CPU tensors take :func:`resample_score_plain`.
    ``resample_score.launches`` counts its launches (K4's counter does not)."""
    r, n_out = _check(c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample, act,
                      draw=draw, ray0=ray0)
    if max(c_feat.shape[1], n_out) > MAX_SCORE_SAMPLES:
        raise ValueError(f"resample_score takes up to {MAX_SCORE_SAMPLES} coarse and merged "
                         f"samples a ray, got {c_feat.shape[1]} and {n_out}")
    if c_feat.device.type == "cpu":
        return resample_score_plain(c_feat, coarse_z, coarse_dists, n_fine, u,
                                    use_coarse_sample, density_shift, distance_scale, act, draw,
                                    ray0)
    score = torch.empty(r, n_out, dtype=torch.float32, device=c_feat.device)
    z_vals, dists = _launch("resample_score_fwd", _WEIGHTS_ARGS, c_feat, coarse_z,
                            coarse_dists, n_fine, u, use_coarse_sample, density_shift,
                            distance_scale, act, n_out, score.data_ptr(), draw=draw, ray0=ray0,
                            counters=(resample_score,) if draw is None else
                            (resample_score, resample_score.draw_form))
    return z_vals, dists, score


resample.launches = 0
resample_weights.launches = 0
resample_score.launches = 0
# the training instantiations' launches (also counted in K4's and K4c's)
resample_chart.draw_form = SimpleNamespace(launches=0)
resample_score.draw_form = SimpleNamespace(launches=0)
