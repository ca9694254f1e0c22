"""Merge of per-ray sorted depth arrays and the sorted uniform draws K5
(counterpart of ``egonerf_tpu/ops/merge.py``).

JAX merges with a bitonic network because a full sort is costly on the TPU;
its result is bit-identical to sorting the concatenation, which is the
plain version here.  The kernel path merges inside K4 (``ops/pdf.py``).

``sorted_uniform`` (K5) draws the training ``u`` that K4 inverts: per ray,
n + 1 Exp(1) draws, their cumulative sum c, and c[:-1] / c[-1].  JAX draws
the exponentials with ``jax.random``; the port draws them from
Philox4x32-10 keyed by (seed, step), in the kernel and, for the plain
version, in int64 torch arithmetic, so both draw the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import resolve_device


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) and (..., m), each sorted ascending -> (..., n+m) sorted."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values


def sorted_uniform_from_exp(e: torch.Tensor) -> torch.Tensor:
    """JAX's formula on given exponentials: (..., n+1) -> (..., n),
    c = cumsum(e); c[..., :-1] / c[..., -1:]."""
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]


# Philox4x32-10 (Salmon et al., SC'11), as csrc/sorted_uniform.cu runs it
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_STREAM = 0x4B35  # counter word 3


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64 x
    holding 32-bit values, without leaving int64: m splits into 16-bit
    halves so that every partial product stays below 2**49."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Four int64 tensors of 32-bit counter words -> the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def exp_draws(n_rays: int, m: int, seed: int, step: int, device) -> torch.Tensor:
    """(n_rays, m) float32 Exp(1) draws of K5's generator: draw j of ray r
    is word j % 4 of Philox4x32-10 at counter (j // 4, r, r >> 32, stream)
    under key (seed, step), mapped to -log((bits + 0.5) * 2**-32) in
    float64 and rounded to float32."""
    g = -(-m // 4)
    ray = torch.arange(n_rays, dtype=torch.int64, device=device)[:, None]
    c0 = torch.arange(g, dtype=torch.int64, device=device)[None, :].expand(n_rays, g)
    c1 = (ray & _MASK).expand(n_rays, g)
    c2 = (ray >> 32).expand(n_rays, g)
    c3 = torch.full_like(c0, _STREAM)
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, seed & _MASK, step & _MASK), dim=-1)
    bits = words.reshape(n_rays, 4 * g)[:, :m]
    u = (bits.to(torch.float64) + 0.5) * 2.0 ** -32
    return (-torch.log(u)).to(torch.float32)


def sorted_uniform_plain(n_rays: int, n: int, seed: int, step: int, device="cpu") -> torch.Tensor:
    """Plain version of K5: see :func:`sorted_uniform`."""
    return sorted_uniform_from_exp(exp_draws(n_rays, n + 1, seed, step, device))


_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
         ctypes.c_void_p]


def sorted_uniform(n_rays: int, n: int, seed: int, step: int, device="cuda") -> torch.Tensor:
    """K5: (n_rays, n) float32 uniforms, sorted ascending per ray, from
    n + 1 Exp(1) draws of Philox4x32-10 under key (seed, step) (each taken
    mod 2**32): c = cumsum(e); u = c[:-1] / c[-1].  ``seed`` and ``step``
    are Python ints, so nothing crosses from the host per step.

    Replaces ``sorted_uniform`` (egonerf_tpu/ops/merge.py:25-36).  Kernel:
    csrc/sorted_uniform.cu.  ``device="cpu"`` takes
    :func:`sorted_uniform_plain`."""
    dev = resolve_device(device)
    if n < 1 or n > 3071:  # the kernel keeps 4 warps x (n + 1) floats in 48 KB
        raise ValueError(f"sorted_uniform takes 1..3071 draws per ray, got {n}")
    if n_rays < 0:
        raise ValueError(f"negative ray count {n_rays}")
    if dev.type == "cpu":
        return sorted_uniform_plain(n_rays, n, seed, step, dev)
    out = torch.empty(n_rays, n, dtype=torch.float32, device=dev)
    if n_rays:
        fn = kernel("sorted_uniform", "sorted_uniform_fwd", _ARGS)
        with torch.cuda.device(dev):
            err = fn(n_rays, n, seed & _MASK, step & _MASK, out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("sorted_uniform_fwd", err)
        sorted_uniform.launches += 1
    return out


sorted_uniform.launches = 0
