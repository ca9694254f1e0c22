"""The empty-space cull of the merged samples (counterpart of
``egonerf_tpu/ops/cull.py``): the coarse pass scores every merged sample
(K12, :func:`coarse_importance`; the forward takes the same score from
K4c, ``pdf.resample_score``, which computes it in K4's epilogue), training
may perturb the scores (:func:`train_tiebreak`, :func:`gumbel_perturb`),
and the K highest of each ray reach the fine field (K13,
:func:`select_top_k`).  JAX shaped both kernels for the TPU as
gather-free ops (a broadcast-compare reduction, a one-hot matmul); here
each is one warp a ray (``csrc/cull.cu``).

The perturbations take their uniforms ``u`` explicitly, as
``jax.random.uniform`` would draw them (the forward draws them from the
step's generator); both are elementwise torch ops, as they are jnp ops in
JAX.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import check_launch, kernel
from .._device import check_tensor

# K12 stages 2 x C floats a warp in shared memory; K13 keeps a lane's
# ceil(S / 32) keys in registers (csrc/cull.cu)
MAX_COARSE = 768
MAX_TOP_K_SAMPLES = 512


def dilate(w: torch.Tensor) -> torch.Tensor:
    """Each weight raised to the max of itself and its two neighbours along
    the last axis, the edges repeated (JAX's one-interval dilation)."""
    right = torch.cat([w[..., 1:], w[..., -1:]], dim=-1)
    left = torch.cat([w[..., :1], w[..., :-1]], dim=-1)
    return torch.maximum(w, torch.maximum(right, left))


def coarse_importance_plain(z_vals: torch.Tensor, coarse_z: torch.Tensor,
                            coarse_weight: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: see :func:`coarse_importance`.  JAX's
    broadcast compare over (N, S, C) and its sum over C."""
    w = dilate(coarse_weight)
    lower = coarse_z
    upper = torch.cat([coarse_z[..., 1:], torch.full_like(coarse_z[..., :1], float("inf"))],
                      dim=-1)
    ind = ((z_vals[..., :, None] >= lower[..., None, :])
           & (z_vals[..., :, None] < upper[..., None, :]))
    return torch.where(ind, w[..., None, :], 0.0).sum(-1)


def select_top_k_plain(z_vals: torch.Tensor, dists: torch.Tensor, score: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K13: see :func:`select_top_k`.  A stable descending
    sort gives ``lax.top_k``'s order (ties to the lower index)."""
    if k >= z_vals.shape[-1]:
        return z_vals, dists
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]
    idx = torch.sort(idx, dim=-1).values
    return torch.gather(z_vals, -1, idx), torch.gather(dists, -1, idx)


def train_tiebreak(score: torch.Tensor, u: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Scores below ``eps`` become ``eps * u`` (per-step noise in [0, eps));
    the rest are shifted by ``eps``, so every score the reference would
    shade keeps strict priority and the survivors among the empty samples
    rotate each step (JAX ``train_tiebreak``; ``u`` its uniform draw)."""
    return torch.where(score < eps, eps * u, score + eps)


def gumbel_perturb(score: torch.Tensor, u: torch.Tensor, tau: float,
                   floor: float = 1e-6) -> torch.Tensor:
    """Gumbel-top-K scores ``log(score + floor) + tau * G``, G standard
    Gumbel from the uniform ``u``: the K largest are a draw without
    replacement proportional to ``(score + floor)^(1/tau)`` (JAX
    ``gumbel_perturb``)."""
    g = -torch.log(-torch.log(u + 1e-12) + 1e-12)
    return torch.log(score + floor) + tau * g


def _check_rows(names, ts, shape, device) -> None:
    for name, t in zip(names, ts):
        check_tensor(name, t, torch.float32, shape, device)


_SCORE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
_TOP_K_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3


def coarse_importance(z_vals: torch.Tensor, coarse_z: torch.Tensor,
                      coarse_weight: torch.Tensor) -> torch.Tensor:
    """K12: each merged sample's score, the coarse weight (dilated by one
    interval: the max of itself and its two neighbours, edges repeated) of
    the coarse interval [coarse_z[c], coarse_z[c+1]) holding it, the last
    interval open to +inf; 0 below coarse_z[0].

    z_vals (R, S), coarse_z and coarse_weight (R, C) float32, both depth
    lists sorted per ray (the sampler's are).  Returns (R, S) float32.

    Replaces ``coarse_importance`` (egonerf_tpu/ops/cull.py:30-54).  Kernel:
    csrc/cull.cu.  CPU tensors take :func:`coarse_importance_plain`."""
    check_tensor("z_vals", z_vals, torch.float32, (None, None))
    r, s = z_vals.shape
    _check_rows(("coarse_z", "coarse_weight"), (coarse_z, coarse_weight),
                (r, None), z_vals.device)
    c = coarse_z.shape[1]
    if coarse_weight.shape[1] != c:
        raise ValueError("coarse_weight: expected one weight per coarse depth")
    if s < 1 or c < 1 or c > MAX_COARSE:
        raise ValueError(f"coarse_importance takes 1..{MAX_COARSE} coarse samples, got {c}")
    if z_vals.device.type == "cpu":
        return coarse_importance_plain(z_vals, coarse_z, coarse_weight)
    dev = z_vals.device
    score = torch.empty(r, s, dtype=torch.float32, device=dev)
    if r:
        fn = kernel("cull", "cull_score", _SCORE_ARGS)
        with torch.cuda.device(dev):
            err = fn(z_vals.data_ptr(), coarse_z.data_ptr(), coarse_weight.data_ptr(), r, s, c,
                     score.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("cull_score", err)
        coarse_importance.launches += 1
    return score


def select_top_k(z_vals: torch.Tensor, dists: torch.Tensor, score: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13: the ``k`` highest-score samples of each ray in depth order, each
    with its z and its ORIGINAL dist (the gap to the next merged sample, so
    the composite treats dropped intervals as empty space).  Ties go to the
    lower index, as ``lax.top_k``'s.  Identity (no launch) when k >= S.

    z_vals, dists, score (R, S) float32, scores not NaN.  Returns z_vals and
    dists (R, k).

    Replaces ``select_top_k`` (egonerf_tpu/ops/cull.py:103-125).  Kernel:
    csrc/cull.cu.  CPU tensors take :func:`select_top_k_plain`."""
    check_tensor("z_vals", z_vals, torch.float32, (None, None))
    r, s = z_vals.shape
    _check_rows(("dists", "score"), (dists, score), (r, s), z_vals.device)
    k = int(k)
    if k < 1:
        raise ValueError(f"select_top_k keeps at least one sample, got k={k}")
    if k >= s:
        return z_vals, dists
    if s > MAX_TOP_K_SAMPLES:
        raise ValueError(f"select_top_k takes up to {MAX_TOP_K_SAMPLES} samples a ray, got {s}")
    if z_vals.device.type == "cpu":
        return select_top_k_plain(z_vals, dists, score, k)
    dev = z_vals.device
    z_out = torch.empty(r, k, dtype=torch.float32, device=dev)
    d_out = torch.empty(r, k, dtype=torch.float32, device=dev)
    if r:
        fn = kernel("cull", "top_k", _TOP_K_ARGS)
        with torch.cuda.device(dev):
            err = fn(z_vals.data_ptr(), dists.data_ptr(), score.data_ptr(), r, s, k,
                     z_out.data_ptr(), d_out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("top_k", err)
        select_top_k.launches += 1
    return z_out, d_out


coarse_importance.launches = 0
select_top_k.launches = 0
