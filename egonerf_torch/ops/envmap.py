"""The environment-map lookup K8 and its gradient K8b (counterpart of
``envmap_radiance`` in ``egonerf_tpu/models/envmap.py:20-43`` and of
``sample_plane`` in ``egonerf_tpu/ops/grid_sample.py:23-87``, which it
calls), and the autograd Function ``envmap_train`` around the pair.

The table is channel-last (2h, h, 3), indexed by (v = phi row, u = cos
theta column), as in JAX.
"""
from __future__ import annotations

import ctypes
from math import pi
from typing import List, Tuple

import numpy as np
import torch

from .._build import check_launch, kernel
from .._device import check_rows, check_tensor

# 1 / (2 pi) as a float32 product: torch on the card divides by a Python
# number through the float32 reciprocal and on the host does not; the plain
# version multiplies on both, so it gives the kernel's bits everywhere
INV_2PI = float(np.float32(1.0) / np.float32(2.0 * pi))


def direction_to_canonical(d: torch.Tensor) -> torch.Tensor:
    """(R, 3) directions -> (R, 2) (u, v) in [0, 1]: u = (cos theta + 1)/2
    with cos theta the z of the unit direction, v = (atan2(y, x) + pi)/2pi.
    The norm is written out, (x x + y y) + z z, so every device sums in the
    kernel's order."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    norm = torch.sqrt(x * x + y * y + z * z)
    u = (z / norm + 1.0) * 0.5
    v = (torch.atan2(y / norm, x / norm) + pi) * INV_2PI
    return torch.stack([u, v], dim=-1)


def _corner(coord: torch.Tensor, size: int):
    """[-1, 1] -> pixel space with align_corners: (i0, i1, frac, valid0,
    valid1), indices clipped to the table (``grid_sample.py::_corner``)."""
    p = (coord + 1.0) * 0.5 * (size - 1)
    i0f = torch.floor(p)
    t = p - i0f
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    v0 = (i0 >= 0) & (i0 <= size - 1)
    v1 = (i1 >= 0) & (i1 <= size - 1)
    return i0.clamp(0, size - 1), i1.clamp(0, size - 1), t, v0, v1


def envmap_corners(dirs: torch.Tensor, h: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The four (flat texel index, bilinear weight) pairs per ray of the
    (2h, h) table: x = u over W = h, y = v over H = 2h, zero padding."""
    uv = direction_to_canonical(dirs) * 2.0 - 1.0
    w_, h_ = h, 2 * h
    x0, x1, tx, vx0, vx1 = _corner(uv[:, 0], w_)
    y0, y1, ty, vy0, vy1 = _corner(uv[:, 1], h_)
    ax, ay = 1.0 - tx, 1.0 - ty
    return [(y0 * w_ + x0, ay * ax * (vy0 & vx0)), (y0 * w_ + x1, ay * tx * (vy0 & vx1)),
            (y1 * w_ + x0, ty * ax * (vy1 & vx0)), (y1 * w_ + x1, ty * tx * (vy1 & vx1))]


def envmap_fwd_plain(table: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: see :func:`envmap_fwd`."""
    flat = table.reshape(-1, 3)
    raw = None
    for idx, wt in envmap_corners(dirs, table.shape[1]):
        term = flat[idx] * wt[:, None]
        raw = term if raw is None else raw + term
    return torch.sigmoid(raw)


def envmap_bwd_plain(dirs: torch.Tensor, env: torch.Tensor, d_env: torch.Tensor,
                     h: int) -> torch.Tensor:
    """Plain version of K8b: see :func:`envmap_bwd`."""
    g = d_env * (env * (1.0 - env))
    grad = torch.zeros(2 * h * h, 3, dtype=torch.float32, device=dirs.device)
    for idx, wt in envmap_corners(dirs, h):
        grad.index_add_(0, idx, g * wt[:, None])
    return grad.reshape(2 * h, h, 3)


_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def envmap_fwd(table: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """K8: per ray, the unit direction's canonical (u, v) mapped to [-1, 1],
    a bilinear lookup of the (2h, h, 3) ``table`` (align_corners, zero
    padding: the seam v = 1 and the pole u = 1 read a weight-0 corner), and
    a sigmoid.

    table (2h, h, 3) float32 contiguous; dirs (R, 3) float32 of unit
    column stride (any row stride: the (R, 6) rays' slice).  Returns the
    (R, 3) environment radiance in [0, 1].

    Replaces ``envmap_radiance`` + ``sample_plane``
    (egonerf_tpu/models/envmap.py:39-43, ops/grid_sample.py:59-87).
    Kernel: csrc/envmap.cu.  CPU tensors take :func:`envmap_fwd_plain`."""
    check_tensor("table", table, torch.float32, (None, None, 3))
    h = table.shape[1]
    if h < 2 or table.shape[0] != 2 * h:
        raise ValueError(f"table: expected shape (2h, h, 3) with h >= 2, got "
                         f"{tuple(table.shape)}")
    if not isinstance(dirs, torch.Tensor) or dirs.dim() != 2:
        raise ValueError("dirs: expected an (R, 3) tensor")
    r = dirs.shape[0]
    check_rows("dirs", dirs, r, 3, table.device)
    if table.device.type == "cpu":
        return envmap_fwd_plain(table, dirs)
    dev = table.device
    out = torch.empty(r, 3, dtype=torch.float32, device=dev)
    if r:
        fn = kernel("envmap", "envmap_fwd", _ARGS)
        with torch.cuda.device(dev):
            err = fn(dirs.data_ptr(), dirs.stride(0), table.data_ptr(), h, r, INV_2PI,
                     out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("envmap_fwd", err)
        envmap_fwd.launches += 1
    return out


envmap_fwd.launches = 0

_BWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def envmap_bwd(dirs: torch.Tensor, env: torch.Tensor, d_env: torch.Tensor,
               h: int) -> torch.Tensor:
    """K8b: the gradient of :func:`envmap_fwd` in its table, given the
    forward's output ``env`` (R, 3) and its cotangent ``d_env`` (R, 3):
    d raw = d_env * (env * (1 - env)) (the sigmoid's), and each of the four
    corners adds d raw times its bilinear weight into a zeroed (2h, h, 3)
    table.  float32; the kernel adds with atomics, in an order that changes
    from run to run.

    Replaces the autodiff of ``envmap_radiance`` (the scatter-add transpose
    of ``jnp.take`` in egonerf_tpu/ops/grid_sample.py:76-87).  Kernel:
    csrc/envmap.cu.  CPU tensors take :func:`envmap_bwd_plain`."""
    if not isinstance(dirs, torch.Tensor) or dirs.dim() != 2:
        raise ValueError("dirs: expected an (R, 3) tensor")
    r, dev = dirs.shape[0], dirs.device
    check_rows("dirs", dirs, r, 3, dev)
    check_tensor("env", env, torch.float32, (r, 3), dev)
    check_tensor("d_env", d_env, torch.float32, (r, 3), dev)
    if int(h) < 2:
        raise ValueError(f"envmap_bwd: h must be >= 2, got {h}")
    h = int(h)
    if dev.type == "cpu":
        return envmap_bwd_plain(dirs, env, d_env, h)
    grad = torch.zeros(2 * h, h, 3, dtype=torch.float32, device=dev)
    if r:
        fn = kernel("envmap", "envmap_bwd", _BWD_ARGS)
        with torch.cuda.device(dev):
            err = fn(dirs.data_ptr(), dirs.stride(0), env.data_ptr(), d_env.data_ptr(), h, r,
                     INV_2PI, grad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("envmap_bwd", err)
        envmap_bwd.launches += 1
    return grad


envmap_bwd.launches = 0


class _Envmap(torch.autograd.Function):
    """K8 forward, K8b backward (``fwd`` and ``bwd`` are an ``Ops`` pair, so
    the plain versions run through the same Function).  The directions take
    no gradient, as in JAX (they are data)."""

    @staticmethod
    def forward(ctx, table, dirs, fwd, bwd):
        env = fwd(table, dirs)
        ctx.save_for_backward(dirs, env)
        ctx.args = (table.shape[1], bwd)
        return env

    @staticmethod
    def backward(ctx, d_env):
        dirs, env = ctx.saved_tensors
        h, bwd = ctx.args
        return bwd(dirs, env, d_env.contiguous(), h), None, None, None


def envmap_train(table, dirs, fwd=envmap_fwd, bwd=envmap_bwd) -> torch.Tensor:
    """:func:`envmap_fwd` with a gradient in ``table`` through ``bwd`` (K8b)."""
    return _Envmap.apply(table, dirs, fwd, bwd)
