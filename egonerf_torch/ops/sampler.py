"""K14: the theta-importance sampler's row draw and id composition
(counterpart of ``make_device_id_sampler``'s ``ThetaImportanceSampler``
branch, ``egonerf_tpu/data/samplers.py:87-102``).

Given a batch's image and column draws and its uniforms, the row is the
first one whose cumulative cos-latitude weight reaches ``u``
(``jnp.searchsorted(cdf, u, side="left")``: the count of ``cdf[i] < u`` on
a non-decreasing cdf), clamped to the last row where the float32 cdf ends
below ``u``; the flat id is ``img * (w * h) + row * w + col`` into the
(img, row, col) layout of the resident ray buffer.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import check_tensor


def theta_ids_plain(img, col, u, cdf, w: int, h: int) -> torch.Tensor:
    """Plain version of K14: see :func:`theta_ids`."""
    row = torch.searchsorted(cdf, u, side="left").clamp_max(h - 1)
    return img * (w * h) + row * w + col


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def theta_ids(img: torch.Tensor, col: torch.Tensor, u: torch.Tensor, cdf: torch.Tensor,
              w: int, h: int) -> torch.Tensor:
    """K14: flat ray ids ``img * (w * h) + min(lower_bound(cdf, u), h - 1) * w
    + col``, int64 (B,), where ``lower_bound`` counts the ``cdf[i] < u``.

    img, col (B,) int64 (the image and column draws); u (B,) float32 in
    [0, 1); cdf (h,) float32, non-decreasing (the row weights' float64
    cumsum cast to float32); ``w`` and ``h`` the per-image raster.

    Replaces the theta branch of ``make_device_id_sampler``
    (egonerf_tpu/data/samplers.py:87-102: ``jnp.searchsorted(...,
    method="compare_all")``, its (batch, h) broadcast-compare, and the id
    arithmetic).  Kernel: csrc/theta_sampler.cu.  CPU tensors take
    :func:`theta_ids_plain`."""
    check_tensor("cdf", cdf, torch.float32, (None,))
    dev = cdf.device
    check_tensor("u", u, torch.float32, (None,), dev)
    b = u.shape[0]
    check_tensor("img", img, torch.int64, (b,), dev)
    check_tensor("col", col, torch.int64, (b,), dev)
    w, h = int(w), int(h)
    if w < 1 or h < 1 or cdf.shape[0] != h:
        raise ValueError(f"theta_ids: expected w, h >= 1 and a cdf of h rows, got w={w}, "
                         f"h={h}, cdf of {cdf.shape[0]}")
    if dev.type == "cpu":
        return theta_ids_plain(img, col, u, cdf, w, h)
    out = torch.empty(b, dtype=torch.int64, device=dev)
    if b:
        fn = kernel("theta_sampler", "theta_ids", _ARGS)
        with torch.cuda.device(dev):
            err = fn(img.data_ptr(), col.data_ptr(), u.data_ptr(), b, cdf.data_ptr(), h, w,
                     out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("theta_ids", err)
        theta_ids.launches += 1
    return out


theta_ids.launches = 0
