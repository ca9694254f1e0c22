"""K14: the theta-importance sampler's row draw and id composition
(counterpart of ``make_device_id_sampler``'s ``ThetaImportanceSampler``
branch, ``egonerf_tpu/data/samplers.py:87-102``).

Given a batch's image and column draws and its uniforms, the row is the
first one whose cumulative cos-latitude weight reaches ``u``
(``jnp.searchsorted(cdf, u, side="left")``: the count of ``cdf[i] < u`` on
a non-decreasing cdf), clamped to the last row where the float32 cdf ends
below ``u``; the flat id is ``img * (w * h) + row * w + col`` into the
(img, row, col) layout of the resident ray buffer.

:func:`theta_batch` (K14f) is the training path's sampler: one launch
draws a batch's image, column and uniform from Philox4x32-10
(``ops/philox.py``) under key (seed, batch counter), picks the row as K14
does and gathers the ids' rows of the resident buffer.  Its stream is the
port's own: JAX's ``jax.random`` bits cannot be matched, the law is the
same (the image and the column uniform, the row by the cdf).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import check_tensor
from .philox import MASK, THETA_STREAM, philox4x32_10


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


def theta_words(n: int, seed: int, t: int, device="cpu"):
    """The Philox words of draws 0 .. n-1 of batch ``t``: block i at
    counter (i, i >> 32, 0, THETA_STREAM) under key (seed, t), each taken
    mod 2**32; four int64 (n,) tensors of 32-bit values."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return philox4x32_10(i & MASK, i >> 32, torch.zeros_like(i),
                         torch.full_like(i, THETA_STREAM), seed & MASK, t & MASK)


def theta_batch_plain(buffer, cdf, w: int, h: int, n: int, seed: int, t: int):
    """Plain version of K14f: see :func:`theta_batch`."""
    img_len = buffer.shape[0] // (w * h)
    x, y, z, _ = theta_words(n, seed, t, buffer.device)
    img = (x * img_len) >> 32
    col = (y * w) >> 32
    u = (z >> 8).to(torch.float32) * 2.0 ** -24
    ids = theta_ids_plain(img, col, u, cdf, w, h)
    return ids, buffer[ids]


_BATCH_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# the row widths K14f takes: rays | rgb, and | depth under use_depth
ROW_FLOATS = (9, 10)


def theta_batch(buffer: torch.Tensor, cdf: torch.Tensor, w: int, h: int, n: int, seed: int,
                t: int):
    """K14f: ``n`` theta-importance draws of batch ``t`` in one launch:
    (ids (n,) int64, rows (n, F) float32 = ``buffer[ids]``).

    Draw i takes the Philox4x32-10 block at counter (i, i >> 32, 0,
    THETA_STREAM) under key (seed, t) (:func:`theta_words`) and maps its
    words x, y, z to img = (x * img_len) >> 32, col = (y * w) >> 32 and
    u = (z >> 8) * 2**-24; the row and the id are :func:`theta_ids`'s.
    buffer (img_len * h * w, F) float32, contiguous, in the flat (img, row,
    col) layout, F = 9 (rays | rgb) or 10 (| depth, under ``use_depth``;
    the row width is a template parameter of the kernel); cdf (h,)
    float32, non-decreasing; ``seed``, ``t`` Python ints, so nothing
    crosses from the host per batch.

    Replaces the theta branch of ``make_device_id_sampler`` with its draws
    and the trainer's gather (egonerf_tpu/data/samplers.py:87-102).
    Kernel: csrc/theta_sampler.cu (``theta_batch_kernel``).  CPU tensors
    take :func:`theta_batch_plain`."""
    check_tensor("buffer", buffer, torch.float32, (None, None))
    if buffer.shape[1] not in ROW_FLOATS:
        raise ValueError(f"theta_batch: rows of {ROW_FLOATS} floats, got {buffer.shape[1]}")
    dev = buffer.device
    check_tensor("cdf", cdf, torch.float32, (None,), dev)
    w, h, n = int(w), int(h), int(n)
    if w < 1 or h < 1 or cdf.shape[0] != h or buffer.shape[0] % (w * h) or n < 0:
        raise ValueError(f"theta_batch: expected w, h >= 1, a cdf of h rows, a buffer of whole "
                         f"w x h images and n >= 0, got w={w}, h={h}, cdf of {cdf.shape[0]}, "
                         f"buffer of {buffer.shape[0]}, n={n}")
    img_len = buffer.shape[0] // (w * h)
    if img_len < 1 or img_len >= 2 ** 31 or w >= 2 ** 31:
        raise ValueError(f"theta_batch: {img_len} images of width {w}; the draws map 32-bit "
                         f"words to [0, 2**31)")
    if dev.type == "cpu":
        return theta_batch_plain(buffer, cdf, w, h, n, seed, t)
    ids = torch.empty(n, dtype=torch.int64, device=dev)
    rows = torch.empty(n, buffer.shape[1], dtype=torch.float32, device=dev)
    if n:
        fn = kernel("theta_sampler", "theta_batch", _BATCH_ARGS)
        with torch.cuda.device(dev):
            err = fn(buffer.data_ptr(), buffer.shape[1], cdf.data_ptr(), h, w, img_len, n,
                     seed & MASK, t & MASK,
                     ids.data_ptr(), rows.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("theta_batch", err)
        theta_batch.launches += 1
    return ids, rows


theta_batch.launches = 0
