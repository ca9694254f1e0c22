"""The chart and normalization prologue K7: per sample of a ray batch, the
point ``o + d z`` in the yin-yang chart's normalized ``[r, theta, phi,
flag]`` coords that K1 and K3 read (counterpart of ``from_cartesian`` +
``normalize_coord`` in ``egonerf_tpu/coords/yinyang.py:47-76`` and
``normalize_r_lookup`` / ``normalize_r_exp`` in
``egonerf_tpu/coords/expgrid.py:89-130``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .._build import check_launch, kernel
from .._device import check_rows
from ..coords.expgrid import exp_ratio
from ..coords.yinyang import YinYangSphericalCoords


def chart_fwd_plain(rays_o, viewdirs, z, coords: YinYangSphericalCoords,
                    downsample: Optional[int] = None) -> torch.Tensor:
    """Plain version of K7: see :func:`chart_fwd`."""
    xyz = rays_o[:, None, :] + viewdirs[:, None, :] * z[..., None]
    return coords.normalize_coord(coords.from_cartesian(xyz),
                                  downsample=downsample).reshape(-1, 4)


def _recip(x: float) -> float:
    """float32(1 / x) as torch on the card forms it where a tensor is
    divided by a Python number (a product with the float32 reciprocal)."""
    return float(np.float32(1.0) / np.float32(x))


_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 8
         + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 5
         + [ctypes.c_void_p] * 2)
MAX_GRID = 4096  # radial grid entries the kernel stages in shared memory


def chart_fwd(rays_o: torch.Tensor, viewdirs: torch.Tensor, z: torch.Tensor,
              coords: YinYangSphericalCoords, downsample: Optional[int] = None) -> torch.Tensor:
    """K7: per sample, xyz = rays_o + viewdirs * z; the yin-yang chart
    (yin test with bounds inclusive on both ends; the yang frame's
    acos(y / r), atan2(z, -x)); and ``normalize_coord`` with ``downsample``
    (the radial grid lookup under ``interval_th``, the closed-form
    exponential cells without it, where ``downsample`` coarsens the cells).

    rays_o, viewdirs (R, 3) and z (R, S) float32 with unit column stride
    (any row stride: a slice of the (R, 6) rays, a broadcast row).  Returns
    the (R * S, 4) normalized [r, theta, phi, flag] coords, rows ray-major.

    Replaces ``from_cartesian`` + ``normalize_coord`` +
    ``normalize_r_lookup`` (egonerf_tpu/coords/yinyang.py:47-76,
    coords/expgrid.py:89-130).  Kernel: csrc/chart.cu.  CPU tensors take
    :func:`chart_fwd_plain`."""
    if not isinstance(coords, YinYangSphericalCoords):
        raise TypeError("chart takes the yin-yang chart")
    if not isinstance(rays_o, torch.Tensor) or rays_o.dim() != 2:
        raise ValueError("rays_o: expected an (R, 3) tensor")
    r, dev = rays_o.shape[0], rays_o.device
    check_rows("rays_o", rays_o, r, 3, dev)
    check_rows("viewdirs", viewdirs, r, 3, dev)
    if not isinstance(z, torch.Tensor) or z.dim() != 2:
        raise ValueError("z: expected an (R, S) tensor")
    s = z.shape[1]
    check_rows("z", z, r, s, dev)
    if dev.type == "cpu":
        return chart_fwd_plain(rays_o, viewdirs, z, coords, downsample)
    out = torch.empty(r * s, 4, dtype=torch.float32, device=dev)
    if r * s == 0:
        return out
    n_r = coords.resolution[0]
    if coords.exp_r and coords.interval_th:
        mode, grid = 0, coords._const("ref_grid", dev)
        if grid.shape[0] > MAX_GRID:
            raise ValueError(f"chart takes radial grids of <= {MAX_GRID} entries")
    else:
        mode, grid = (1 if coords.exp_r else 2), out  # the grid pointer is not read
    ratio = coords.ratio or 1.0
    if mode == 1 and downsample is not None:
        n_r = n_r // downsample
        ratio = exp_ratio(coords.r0, coords.far_r, n_r)
    center, near, inv = (np.asarray(a, np.float32) for a in
                         (coords.center, coords.near, coords.inv_diff))
    fn = kernel("chart", "chart_fwd", _ARGS)
    with torch.cuda.device(dev):
        err = fn(rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                 z.data_ptr(), z.stride(0), r, s, *map(float, center), float(near[1]),
                 float(near[2]), *map(float, inv), mode, grid.data_ptr(), grid.shape[0],
                 _recip(n_r), float(np.float32(coords.r0 or 1.0)), _recip(coords.r0 or 1.0),
                 float(np.float32(ratio)), _recip(np.log(ratio)) if ratio != 1.0 else 0.0,
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch("chart_fwd", err)
    chart_fwd.launches += 1
    return out


chart_fwd.launches = 0
