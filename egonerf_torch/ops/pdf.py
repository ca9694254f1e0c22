"""Hierarchical inverse-CDF resampling: plain ``sample_pdf`` and kernel K4.

Counterpart of ``egonerf_tpu/ops/pdf.py``.  K4 fuses, per ray, the coarse
weights (``raw2alpha`` on the coarse density), the pdf and cdf over the
interior weights, the inverse-CDF draw, the merge with the coarse depths
(``ops/merge.py``) and the ``dists`` diff of ``EgoNeRF.forward``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .._build import check_launch, kernel
from .._device import check_tensor
from .merge import merge_sorted
from .volrend import ACTIVATIONS, density_activation, raw2alpha


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


# K4 keeps a ray on one warp: lane l owns the contiguous chunk [l per,
# (l + 1) per) of its samples, per = ceil(n / 32), and the products and sums
# across lanes are the scans and the butterfly of csrc/warp_scan.cuh.  The
# plain version takes them in that order, so its depths are K4's to the bit
# and the fine samples of the two paths do not part on the card.
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


def _warp_exclusive_scan(v: torch.Tensor, op, identity: float) -> torch.Tensor:
    """(R, 32): ``warp_exclusive_prod`` / ``_sum``: Hillis-Steele over the
    offsets 1, 2, 4, 8, 16, then a shift by one lane."""
    for off in (1, 2, 4, 8, 16):
        v = torch.cat([v[:, :off], op(v[:, off:], v[:, :-off])], dim=1)
    return torch.cat([torch.full_like(v[:, :1], identity), v[:, :-1]], dim=1)


def _warp_weights(alpha: torch.Tensor) -> torch.Tensor:
    """raw2alpha's weights alpha * exclusive transmittance, in K4's order."""
    s = alpha.shape[1]
    f = _lane_chunks(1.0 - alpha + 1e-10, 1.0)
    al = _lane_chunks(alpha, 0.0)
    t = _warp_exclusive_scan(_chunk_fold(f, torch.mul), torch.mul, 1.0)
    w = []
    for j in range(f.shape[-1]):
        w.append(al[..., j] * t)
        t = t * f[..., j]
    return torch.stack(w, dim=-1).reshape(alpha.shape[0], -1)[:, :s]


def _warp_cdf(weights: torch.Tensor) -> torch.Tensor:
    """The cdf of ``weights`` + 1e-5 with its leading 0, in K4's order: the
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


def resample_plain(c_feat, coarse_z, coarse_dists, n_fine, u=None,
                   use_coarse_sample=True, density_shift=-8.0,
                   distance_scale=25.0, act="softplus"):
    """Plain version of K4: see :func:`resample`.  raw2alpha's weights and
    :func:`sample_pdf` with their products and sums in K4's order."""
    sigma = density_activation(c_feat, density_shift, act)
    alpha, _, _ = raw2alpha(sigma, coarse_dists * distance_scale)
    z_mid = 0.5 * (coarse_z[:, 1:] + coarse_z[:, :-1])
    fine_z = sample_pdf(z_mid, _warp_weights(alpha)[:, 1:-1], n_fine, u)
    z_vals = merge_sorted(coarse_z, fine_z) if use_coarse_sample else fine_z
    return z_vals, _dists(z_vals)


_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
         + [ctypes.c_float, ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3)


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
    u (R, n_fine) sorted uniforms or None for the eval linspace.  Returns
    z_vals and dists, (R, S + n_fine) or (R, n_fine).

    Replaces ``sample_pdf`` + ``merge_sorted`` + the coarse ``raw2alpha``
    and the dists diff (egonerf_tpu/ops/pdf.py:14-77, ops/merge.py:39-71,
    ops/volrend.py:11-24, models/egonerf.py:392-411).  Kernel:
    csrc/resample.cu.  CPU tensors take :func:`resample_plain`."""
    check_tensor("c_feat", c_feat, torch.float32, (None, None))
    r, s = c_feat.shape
    check_tensor("coarse_z", coarse_z, torch.float32, (r, s), c_feat.device)
    check_tensor("coarse_dists", coarse_dists, torch.float32, (r, s), c_feat.device)
    if u is not None:
        check_tensor("u", u, torch.float32, (r, n_fine), c_feat.device)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown density activation {act!r}")
    n_out = s + n_fine if use_coarse_sample else n_fine
    # the kernel keeps 4 warps x (4S - 2 + F + n_out) floats in 48 KB
    if s < 3 or n_fine < 1 or n_out < 2 or 4 * s - 2 + n_fine + n_out > 3072:
        raise ValueError(f"resample cannot take {s} coarse and {n_fine} fine samples")
    if c_feat.device.type == "cpu":
        return resample_plain(c_feat, coarse_z, coarse_dists, n_fine, u,
                              use_coarse_sample, density_shift, distance_scale, act)
    dev = c_feat.device
    z_vals = torch.empty(r, n_out, dtype=torch.float32, device=dev)
    dists = torch.empty(r, n_out, dtype=torch.float32, device=dev)
    if r:
        u_ptr = linspace01(n_fine, dev) if u is None else u
        fn = kernel("resample", "resample_fwd", _ARGS)
        with torch.cuda.device(dev):
            err = fn(c_feat.data_ptr(), coarse_z.data_ptr(), coarse_dists.data_ptr(),
                     u_ptr.data_ptr(), 0 if u is None else n_fine, r, s, n_fine,
                     int(bool(use_coarse_sample)), float(density_shift),
                     float(distance_scale), ACTIVATIONS.index(act),
                     z_vals.data_ptr(), dists.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("resample_fwd", err)
        resample.launches += 1
    return z_vals, dists


resample.launches = 0
