"""The chart and normalization prologue K7: per sample of a ray batch, the
point ``o + d z`` in the yin-yang chart's normalized ``[r, theta, phi,
flag]`` coords that K1 and K3 read (counterpart of ``from_cartesian`` +
``normalize_coord`` in ``egonerf_tpu/coords/yinyang.py:47-76`` and
``normalize_r_lookup`` / ``normalize_r_exp`` in
``egonerf_tpu/coords/expgrid.py:89-130``); and K7s, its single-sphere form,
``generic_sphere``'s ``[r, theta, phi, 0]`` for the TensoRF models with
their samplers' in-box mask of the same points."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._build import check_launch, kernel
from .._device import check_rows
from ..coords.expgrid import exp_ratio
from ..coords.spherical import GenericSphericalCoords
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


# the chart's own arguments of chart_fwd and of K4's resample_chart_fwd
CHART_ARGS = ([ctypes.c_float] * 8 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
              + [ctypes.c_float] * 5)
_ARGS = [ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + CHART_ARGS + \
    [ctypes.c_void_p] * 2
MAX_GRID = 4096  # radial grid entries the kernels stage in shared memory


def chart_args(coords: GenericSphericalCoords, downsample: Optional[int], dev) -> list:
    """The chart's arguments as the kernels take them (``CHART_ARGS``):
    the centre, the angle bounds, the per-axis reciprocals, the radial
    mode (0 the grid lookup under ``interval_th``, 1 the closed-form
    exponential cells, 2 linear), the grid and its length, and the
    reciprocals of the radial normalization; of the yin-yang chart or of
    ``generic_sphere``."""
    if not isinstance(coords, GenericSphericalCoords):
        raise TypeError("chart takes the yin-yang or the generic_sphere chart")
    n_r = coords.resolution[0]
    if coords.exp_r and coords.interval_th:
        mode, grid = 0, coords._const("ref_grid", dev)
        if grid.shape[0] > MAX_GRID:
            raise ValueError(f"chart takes radial grids of <= {MAX_GRID} entries")
        grid_ptr, n_grid = grid.data_ptr(), grid.shape[0]
    else:
        mode, grid_ptr, n_grid = (1 if coords.exp_r else 2), None, 0
    ratio = coords.ratio or 1.0
    if mode == 1 and downsample is not None:
        n_r = n_r // downsample
        ratio = exp_ratio(coords.r0, coords.far_r, n_r)
    center, near, inv = (np.asarray(a, np.float32) for a in
                         (coords.center, coords.near, coords.inv_diff))
    return [*map(float, center), float(near[1]), float(near[2]), *map(float, inv), mode,
            grid_ptr, n_grid, _recip(n_r), float(np.float32(coords.r0 or 1.0)),
            _recip(coords.r0 or 1.0), float(np.float32(ratio)),
            _recip(np.log(ratio)) if ratio != 1.0 else 0.0]


def check_rays(rays_o, viewdirs) -> tuple:
    """(R, device) of the (R, 3) origins and directions, with unit column
    stride and any row stride."""
    if not isinstance(rays_o, torch.Tensor) or rays_o.dim() != 2:
        raise ValueError("rays_o: expected an (R, 3) tensor")
    r, dev = rays_o.shape[0], rays_o.device
    check_rows("rays_o", rays_o, r, 3, dev)
    check_rows("viewdirs", viewdirs, r, 3, dev)
    return r, dev


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
    coords/expgrid.py:89-130).  Kernel: csrc/chart.cu (the EgoNeRF forward's
    fine chart runs in K4's epilogue, ``pdf.resample_chart``).  CPU tensors
    take :func:`chart_fwd_plain`."""
    if not isinstance(coords, YinYangSphericalCoords):
        raise TypeError("chart takes the yin-yang chart")
    r, dev = check_rays(rays_o, viewdirs)
    if not isinstance(z, torch.Tensor) or z.dim() != 2:
        raise ValueError("z: expected an (R, S) tensor")
    s = z.shape[1]
    check_rows("z", z, r, s, dev)
    if dev.type == "cpu":
        return chart_fwd_plain(rays_o, viewdirs, z, coords, downsample)
    out = torch.empty(r * s, 4, dtype=torch.float32, device=dev)
    if r * s == 0:
        return out
    args = chart_args(coords, downsample, dev)
    fn = kernel("chart", "chart_fwd", _ARGS)
    with torch.cuda.device(dev):
        err = fn(rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                 z.data_ptr(), z.stride(0), r, s, *args, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch("chart_fwd", err)
    chart_fwd.launches += 1
    return out


chart_fwd.launches = 0


# the radial lookup's bucket table: at most this many buckets
MAX_BUCKETS = 4096


class RadialBuckets(NamedTuple):
    """K7s's first guess of the radial cell: a radius r falls in bucket
    ``min(trunc(float32(r * inv_w)), len(start) - 1)`` (a NaN in bucket
    0), whose ``start`` is at or below ``searchsorted(grid, r,
    right=True)``; a walk up the grid from there reaches it in at most
    ``walk`` steps."""
    start: np.ndarray
    inv_w: float
    walk: int


def radial_buckets(grid: np.ndarray) -> RadialBuckets:
    """The bucket table of the strictly increasing float32 radial ``grid``
    (its first entry 0): buckets of the smallest cell's width, at most
    ``MAX_BUCKETS`` of them, over [0, grid[-1]], the last taking every
    radius past it.  Bucket b's first radius is the least float32 r with
    float32(r * inv_w) >= b, found by stepping from b / inv_w an ulp at a
    time; its ``start`` is searchsorted of that radius (0 in bucket 0, so
    a NaN ends at index 0, where a binary search ends), since searchsorted
    and the bucket both grow with r.  ``walk`` is the most that
    searchsorted grows inside one bucket."""
    grid = np.asarray(grid, np.float32)
    if grid.ndim != 1 or grid.shape[0] < 2 or grid[0] != 0 or not np.all(np.diff(grid) > 0):
        raise ValueError("radial_buckets takes a strictly increasing grid from 0")
    last = float(grid[-1])
    n_bucket = int(min(MAX_BUCKETS, np.ceil(last / float(np.diff(grid).min())) + 1))
    inv_w = np.float32((n_bucket - 1) / last)
    b = np.arange(1, n_bucket, dtype=np.float32)
    first = (b.astype(np.float64) / float(inv_w)).astype(np.float32)
    while True:
        down = np.nextafter(first, np.float32(0))
        move = (down * inv_w >= b) & (first > 0)
        if not move.any():
            break
        first = np.where(move, down, first)
    while True:
        move = first * inv_w < b
        if not move.any():
            break
        first = np.where(move, np.nextafter(first, np.float32(np.inf)), first)
    start = np.concatenate([[0], np.searchsorted(grid, first, side="right")])
    # each bucket's last radius: the ulp below the next one's first, inf
    # for the last bucket
    last_r = np.concatenate([np.nextafter(first, np.float32(0)), [np.float32(np.inf)]])
    end = np.searchsorted(grid, last_r, side="right")
    return RadialBuckets(start.astype(np.int32), float(inv_w), int((end - start).max()))


def _bucket_table(coords: GenericSphericalCoords, dev) -> tuple:
    """(start on ``dev``, inv_w, walk) of the chart's radial grid, built
    once a grid and device (the chart clears its constants when the grid
    moves)."""
    key = ("radial_buckets", dev)
    hit = coords._consts.get(key)
    if hit is None:
        table = radial_buckets(coords.ref_grid)
        hit = coords._consts[key] = (torch.as_tensor(table.start, device=dev), table.inv_w,
                                     table.walk)
    return hit


def is_single_sphere(coords) -> bool:
    """Whether K7s takes ``coords``: ``generic_sphere``, not the yin-yang
    chart that builds on it."""
    return (isinstance(coords, GenericSphericalCoords)
            and not isinstance(coords, YinYangSphericalCoords))


def chart_sphere_fwd_plain(rays_o, viewdirs, z, coords: GenericSphericalCoords, aabb=None):
    """Plain version of K7s: see :func:`chart_sphere_fwd`."""
    xyz = rays_o[:, None, :] + viewdirs[:, None, :] * z[..., None]
    norm = F.pad(coords.normalize_coord(coords.from_cartesian(xyz)), (0, 1)).reshape(-1, 4)
    if aabb is None:
        return norm
    box = torch.as_tensor(aabb, dtype=torch.float32, device=xyz.device)
    return norm, ((xyz >= box[0]) & (xyz <= box[1])).all(dim=-1).reshape(-1)


_SPHERE_ARGS = _ARGS[:-2] + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int] + \
    [ctypes.c_void_p] * 4


def chart_sphere_fwd(rays_o: torch.Tensor, viewdirs: torch.Tensor, z: torch.Tensor,
                     coords: GenericSphericalCoords, aabb=None):
    """K7s: K7 on ``generic_sphere``'s single sphere.  Per sample, xyz =
    rays_o + viewdirs * z; r, theta = acos(z / r) (pi / 2 at r = 0) and
    phi = atan2(y, x) about the chart's centre; each mapped to [-1, 1] on
    near (0, 0, -pi) and far (max_r, pi, pi), the radius through K7's
    radial mode (0 the grid lookup under ``interval_th``, 1 the
    closed-form exponential cells, 2 linear without ``exp_r``).  With the
    (2, 3) ``aabb``, also the samplers' in-box mask of the same points:
    ``all(aabb[0] <= xyz <= aabb[1])``.

    rays_o, viewdirs (R, 3) and z (R, S) float32 with unit column stride
    (any row stride).  Returns the (R * S, 4) [r, theta, phi, 0] coords,
    rows ray-major, the TensoRF lookups' layout; with ``aabb`` the coords
    and the (R * S,) bool mask.

    Replaces ``GenericSphericalCoords.from_cartesian`` + ``normalize_coord``
    with ``normalize_r_lookup`` (egonerf_tpu/coords/spherical.py:48-53,
    119-126; coords/expgrid.py:89-130) and the samplers' ``in_box``
    (egonerf_tpu/models/tensorf.py:61-77).  Kernel: csrc/chart.cu
    (``chart_sphere_kernel``: the radial cell from :func:`radial_buckets`
    and a walk, the radial column and the mask the plain version's bit for
    bit, the angles by polynomials within 2e-7 rad of it).  CPU tensors
    take :func:`chart_sphere_fwd_plain`."""
    if not is_single_sphere(coords):
        raise TypeError("chart_sphere_fwd takes the generic_sphere chart")
    r, dev = check_rays(rays_o, viewdirs)
    if not isinstance(z, torch.Tensor) or z.dim() != 2:
        raise ValueError("z: expected an (R, S) tensor")
    s = z.shape[1]
    check_rows("z", z, r, s, dev)
    box = None
    if aabb is not None:
        box = torch.as_tensor(aabb, dtype=torch.float32, device=dev)
        if box.shape != (2, 3):
            raise ValueError(f"aabb: expected (2, 3), got {tuple(box.shape)}")
    if dev.type == "cpu":
        return chart_sphere_fwd_plain(rays_o, viewdirs, z, coords, box)
    out = torch.empty(r * s, 4, dtype=torch.float32, device=dev)
    mask = None if box is None else torch.empty(r * s, dtype=torch.bool, device=dev)
    if r * s == 0:
        return out if mask is None else (out, mask)
    args = chart_args(coords, None, dev)
    start, n_bucket, inv_w, walk = None, 0, 0.0, 0
    if args[8] == 0:  # the radial grid lookup
        table, inv_w, walk = _bucket_table(coords, dev)
        start, n_bucket = table.data_ptr(), table.shape[0]
    box = None if box is None else box.contiguous()
    fn = kernel("chart", "chart_sphere_fwd", _SPHERE_ARGS)
    with torch.cuda.device(dev):
        err = fn(rays_o.data_ptr(), rays_o.stride(0), viewdirs.data_ptr(), viewdirs.stride(0),
                 z.data_ptr(), z.stride(0), r, s, *args, start, n_bucket, inv_w, walk,
                 None if box is None else box.data_ptr(), out.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch("chart_sphere_fwd", err)
    chart_sphere_fwd.launches += 1
    return out if mask is None else (out, mask)


chart_sphere_fwd.launches = 0
