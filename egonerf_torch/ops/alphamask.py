"""K9, the alpha-mask lookup: the trilinear occupancy of a baked binary
volume at normalized coords (counterpart of ``_PackedTrilinear.sample`` in
``egonerf_tpu/models/alphamask.py``, which computes
``ops/grid_sample.py::sample_volume``).

The volume stays one byte per cell, (S, D, H, W) uint8 with S = 1 (a
TensoRF mask) or 2 (EgoNeRF's yin and yang); JAX's int8 row packing answers
a TPU gather cost and is not carried over.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import check_tensor
from .vm_lookup import _axis_cells, chart_sel


def alpha_fwd_plain(coords: torch.Tensor, volume: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: see :func:`alpha_fwd`.  The eight corners in
    torch, each weight ((wz wy) wx), added in K9's order."""
    s, d, h, w = volume.shape
    sel = chart_sel(coords, s)
    x0, wx0, wx1 = _axis_cells(coords[:, 0], w)
    y0, wy0, wy1 = _axis_cells(coords[:, 1], h)
    z0, wz0, wz1 = _axis_cells(coords[:, 2], d)
    xs = ((x0, wx0), ((x0 + 1).clamp_max(w - 1), wx1))
    ys = ((y0, wy0), ((y0 + 1).clamp_max(h - 1), wy1))
    zs = ((z0, wz0), ((z0 + 1).clamp_max(d - 1), wz1))
    flat = volume.reshape(-1)
    base = sel * (d * h * w)
    acc = torch.zeros(coords.shape[0], dtype=torch.float32, device=coords.device)
    for zi, wz in zs:
        for yi, wy in ys:
            row = base + (zi * h + yi) * w
            wzy = wz * wy
            for xi, wx in xs:
                acc = acc + (wzy * wx) * flat[row + xi].float()
    return acc


_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p] + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]


def alpha_fwd(coords: torch.Tensor, volume: torch.Tensor) -> torch.Tensor:
    """K9: the trilinear sample of a binary ``volume`` at ``coords``,
    align_corners=True with zeros padding and the cells of
    ``_axis_cells``.

    coords (N, 3) [x, y, z] or (N, 4) [x, y, z, flag] float32 in [-1, 1]
    (x indexes W, y H, z D); volume (S, D, H, W) uint8 of 0 and 1, S = 1
    (the flag, if any, is ignored) or 2 (the flag selects the grid, and
    coords must carry it).  Returns (N,) float32 in [0, 1].

    Replaces ``_PackedTrilinear.sample`` (egonerf_tpu/models/alphamask.py:
    50-68) = ``sample_volume`` (ops/grid_sample.py:90-117).  Kernel:
    csrc/alphamask.cu.  CPU tensors take :func:`alpha_fwd_plain`."""
    check_tensor("volume", volume, torch.uint8, (None, None, None, None))
    s, d, h, w = volume.shape
    if s not in (1, 2):
        raise ValueError(f"expected a stack of 1 or 2 volumes, got {tuple(volume.shape)}")
    if coords.dim() != 2 or coords.shape[1] not in (3, 4) or (s == 2 and coords.shape[1] != 4):
        raise ValueError(f"coords of shape {tuple(coords.shape)} for a stack of {s} volumes")
    check_tensor("coords", coords, torch.float32, (None, coords.shape[1]), volume.device)
    if coords.device.type == "cpu":
        return alpha_fwd_plain(coords, volume)
    out = torch.empty(coords.shape[0], dtype=torch.float32, device=coords.device)
    if coords.shape[0]:
        fn = kernel("alphamask", "alphamask_fwd", _ARGS)
        dev = coords.device
        with torch.cuda.device(dev):
            err = fn(coords.data_ptr(), coords.shape[0], coords.shape[1], volume.data_ptr(),
                     s, d, h, w, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("alphamask_fwd", err)
        alpha_fwd.launches += 1
    return out


alpha_fwd.launches = 0
