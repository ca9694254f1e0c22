"""Merge of per-ray sorted depth arrays and the sorted uniform draws K5
(counterpart of ``egonerf_tpu/ops/merge.py``).

JAX merges with a bitonic network because a full sort is costly on the TPU;
its result is bit-identical to sorting the concatenation, which is the
plain version here.  The kernel path merges inside K4 (``ops/pdf.py``).

``sorted_uniform`` (K5) draws the training ``u`` that K4 inverts: per ray,
n + 1 Exp(1) draws, their cumulative sum c, and c[:-1] / c[-1].  JAX draws
the exponentials with ``jax.random``; the port draws them from
Philox4x32-10 keyed by (seed, step), in the kernel and, for the plain
version, in int64 torch arithmetic (``ops/philox.py``), so both draw the
same bits.  The training step launches no K5: the training instantiations
of K4 and K4c run the same draw as their prologue (``ops/pdf.py``'s
``draw`` key).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import resolve_device
from .philox import MASK as _MASK
from .philox import SORTED_STREAM, philox4x32_10


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) and (..., m), each sorted ascending -> (..., n+m) sorted."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values


def sorted_uniform_from_exp(e: torch.Tensor) -> torch.Tensor:
    """JAX's formula on given exponentials: (..., n+1) -> (..., n),
    c = cumsum(e); c[..., :-1] / c[..., -1:]."""
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]


def exp_draws(n_rays: int, m: int, seed: int, step: int, device, ray0: int = 0) -> torch.Tensor:
    """(n_rays, m) float32 Exp(1) draws of K5's generator: draw j of ray r
    is word j % 4 of Philox4x32-10 at counter (j // 4, r, r >> 32, stream)
    under key (seed, step), mapped to -log((bits + 0.5) * 2**-32) in
    float64 and rounded to float32.  Row i is ray r = ``ray0`` + i: a shard
    of a global batch that starts at ray ``ray0`` draws the global batch's
    rows."""
    g = -(-m // 4)
    ray = ray0 + torch.arange(n_rays, dtype=torch.int64, device=device)[:, None]
    c0 = torch.arange(g, dtype=torch.int64, device=device)[None, :].expand(n_rays, g)
    c1 = (ray & _MASK).expand(n_rays, g)
    c2 = (ray >> 32).expand(n_rays, g)
    c3 = torch.full_like(c0, SORTED_STREAM)
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, seed & _MASK, step & _MASK), dim=-1)
    bits = words.reshape(n_rays, 4 * g)[:, :m]
    u = (bits.to(torch.float64) + 0.5) * 2.0 ** -32
    return (-torch.log(u)).to(torch.float32)


def sorted_uniform_plain(n_rays: int, n: int, seed: int, step: int, device="cpu",
                         ray0: int = 0) -> torch.Tensor:
    """Plain version of K5: see :func:`sorted_uniform`."""
    return sorted_uniform_from_exp(exp_draws(n_rays, n + 1, seed, step, device, ray0))


_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p]


def check_ray0(ray0) -> int:
    """A ray offset is a nonnegative Python int."""
    if not isinstance(ray0, int) or isinstance(ray0, bool) or ray0 < 0:
        raise ValueError(f"a ray offset is a nonnegative int, got {ray0!r}")
    return ray0


def sorted_uniform(n_rays: int, n: int, seed: int, step: int, device="cuda",
                   ray0: int = 0) -> torch.Tensor:
    """K5: (n_rays, n) float32 uniforms, sorted ascending per ray, from
    n + 1 Exp(1) draws of Philox4x32-10 under key (seed, step) (each taken
    mod 2**32): c = cumsum(e); u = c[:-1] / c[-1].  ``seed`` and ``step``
    are Python ints, so nothing crosses from the host per step.  Row i
    draws as ray ``ray0`` + i (:func:`exp_draws`).

    Replaces ``sorted_uniform`` (egonerf_tpu/ops/merge.py:25-36).  Kernel:
    csrc/sorted_uniform.cu.  ``device="cpu"`` takes
    :func:`sorted_uniform_plain`."""
    dev = resolve_device(device)
    if n < 1 or n > 3071:  # the kernel keeps 4 warps x (n + 1) floats in 48 KB
        raise ValueError(f"sorted_uniform takes 1..3071 draws per ray, got {n}")
    if n_rays < 0:
        raise ValueError(f"negative ray count {n_rays}")
    check_ray0(ray0)
    if dev.type == "cpu":
        return sorted_uniform_plain(n_rays, n, seed, step, dev, ray0)
    out = torch.empty(n_rays, n, dtype=torch.float32, device=dev)
    if n_rays:
        fn = kernel("sorted_uniform", "sorted_uniform_fwd", _ARGS)
        with torch.cuda.device(dev):
            err = fn(n_rays, n, seed & _MASK, step & _MASK, ray0, out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("sorted_uniform_fwd", err)
        sorted_uniform.launches += 1
    return out


sorted_uniform.launches = 0
