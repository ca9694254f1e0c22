"""VM-grid lookups: the plain plane and line samples, and the fused field
kernels K1 (fine density + appearance) and K3 (coarse density).

Counterpart of ``egonerf_tpu/ops/vm_lookup.py``, read for what it computes
and not for its TPU layout: no corner packing, no one-hot or hat matmuls,
no channel padding.  What carries over exactly:

* Tables are read as bf16 (the JAX forward casts in ``pack_plane`` /
  ``pack_line``); corner weights and sums are float32.
* Cell semantics of ``_axis_cells``: indices clamp, a coord one cell below
  -1 puts its weight t on corner 0, out-of-range corners weigh 0; the
  {0, 1} chart flag selects the stacked grid.
* The fine line lookup takes the hat path of ``sample_line_hat`` while
  :func:`line_hat_ok` holds (as JAX's ``_onehot_ok`` gate): the two line
  weights are tents max(0, 1-|pos-j|) at pos = p + sel*L, rounded to bf16.
  Otherwise, and always for the coarse lookup, the line weights are the
  float32 ``_axis_cells`` pair.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .._build import check_launch, kernel
from .._device import check_tensor

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

# JAX's hat-matrix gate (vm_lookup.py:63-73): at most 1,152 stacked rows and
# an (N, rows) bf16 matrix of at most 3e9 bytes
_ONEHOT_FWD_MAX_ROWS = 1152
_ONEHOT_MAX_BYTES = 3e9


def line_hat_ok(n_rows: int, n_idx: int) -> bool:
    """Whether JAX's fine line lookup takes the bf16 hat path for a table of
    ``n_rows`` stacked rows sampled at ``n_idx`` points."""
    return n_rows <= _ONEHOT_FWD_MAX_ROWS and n_rows * n_idx * 2 <= _ONEHOT_MAX_BYTES


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _axis_cells(coord: torch.Tensor, size: int):
    """[-1, 1] coord -> (clamped cell0, weight0, weight1), align_corners=True
    with zeros padding; the weights belong to the clamped pair (cell0,
    cell0+1)."""
    p = (coord + 1.0) * 0.5 * (size - 1)
    i0f = torch.floor(p)
    t = p - i0f
    i0 = i0f.to(torch.int64)
    v0 = (i0 >= 0) & (i0 <= size - 1)
    v1 = (i0 + 1 >= 0) & (i0 + 1 <= size - 1)
    w0 = torch.where(i0 == -1, t, (1.0 - t) * v0)
    w1 = t * (v1 & (i0 >= 0))
    return i0.clamp(0, size - 1), w0, w1


def sample_plane(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 sel: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of stacked (S, H, W, C) planes at normalized (x, y)
    on chart ``sel``; (N, C) float32 ((y0x0 + y0x1) + y1x0) + y1x1."""
    s, h, w, c = plane.shape
    x0, wx0, wx1 = _axis_cells(x, w)
    y0, wy0, wy1 = _axis_cells(y, h)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    flat = plane.reshape(s * h * w, c)
    base = sel.to(torch.int64) * (h * w)

    def corner(yy, xx, wt):
        return wt[:, None] * flat[base + yy * w + xx].float()

    return (corner(y0, x0, wy0 * wx0) + corner(y0, x1, wy0 * wx1)
            + corner(y1, x0, wy1 * wx0) + corner(y1, x1, wy1 * wx1))


def sample_line(line: torch.Tensor, coord: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Linear sample of stacked (S, L, C) lines with float32 weights."""
    s, l, c = line.shape
    i0, w0, w1 = _axis_cells(coord, l)
    flat = line.reshape(s * l, c)
    base = sel.to(torch.int64) * l
    r0 = flat[base + i0].float()
    r1 = flat[base + (i0 + 1).clamp_max(l - 1)].float()
    return w0[:, None] * r0 + w1[:, None] * r1


def sample_line_hat(line: torch.Tensor, coord: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Linear sample of stacked (S, L, C) lines with the bf16-rounded tent
    weights of JAX's ``_hat_matrix``, restricted to the own chart's rows."""
    s, l, c = line.shape
    p = (coord + 1.0) * 0.5 * (l - 1)
    pos = p + sel.to(p.dtype) * l
    jf = torch.floor(pos)
    first = sel.to(torch.int64) * l
    flat = line.reshape(s * l, c)
    out = None
    for jj in (jf, jf + 1.0):
        tent = (1.0 - (pos - jj).abs()).clamp_min(0.0)
        j = jj.to(torch.int64)
        in_chart = (j >= first) & (j <= first + l - 1)
        wt = torch.where(in_chart, tent, torch.zeros_like(tent)).to(torch.bfloat16).float()
        term = wt[:, None] * flat[j.clamp(first, first + l - 1)].float()
        out = term if out is None else out + term
    return out


def field_fwd_plain(coords, planes, lines, n_density, line_hat):
    """Plain version of K1: see :func:`field_fwd`."""
    xyz = coords[:, :3]
    sel = coords[:, 3].to(torch.int64)
    dens = torch.zeros(coords.shape[0], dtype=torch.float32, device=coords.device)
    parts = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        p = sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
        line_fn = sample_line_hat if line_hat[i] else sample_line
        prod = p * line_fn(lines[i], xyz[:, VEC_MODE[i]], sel)
        dens = dens + torch.relu(prod[:, : n_density[i]].sum(-1))
        parts.append(prod[:, n_density[i]:])
    return dens, torch.cat(parts, dim=-1)


def density_fwd_plain(coords, planes, lines):
    """Plain version of K3: see :func:`density_fwd`."""
    xyz = coords[:, :3]
    sel = coords[:, 3].to(torch.int64)
    dens = torch.zeros(coords.shape[0], dtype=torch.float32, device=coords.device)
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        p = sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
        l = sample_line(lines[i], xyz[:, VEC_MODE[i]], sel)
        dens = dens + torch.relu((p * l).sum(-1))
    return dens


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
         ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _check_field_args(coords, planes, lines, n_density):
    check_tensor("coords", coords, torch.float32, (None, 4))
    if len(planes) != 3 or len(lines) != 3 or len(n_density) != 3:
        raise ValueError("expected three planes, three lines and three density widths")
    for i in range(3):
        check_tensor(f"planes[{i}]", planes[i], torch.bfloat16, (2, None, None, None),
                     coords.device)
        c = planes[i].shape[-1]
        check_tensor(f"lines[{i}]", lines[i], torch.bfloat16, (2, None, c), coords.device)
        if not 0 <= n_density[i] <= c:
            raise ValueError(f"n_density[{i}]={n_density[i]} outside [0, {c}]")
    if coords.shape[0] >= 2 ** 31:
        raise ValueError("more than 2**31 samples in one call")


def _launch(fn_name, coords, planes, lines, n_density, line_hat, dens, app):
    dims = []
    for i in range(3):
        _, h, w, c = planes[i].shape
        dims += [h, w, lines[i].shape[1], c, int(n_density[i]), int(bool(line_hat[i]))]
    fn = kernel("vm_lookup", fn_name, _ARGS)
    dev = coords.device
    with torch.cuda.device(dev):
        err = fn(coords.data_ptr(), coords.shape[0],
                 (ctypes.c_void_p * 3)(*[p.data_ptr() for p in planes]),
                 (ctypes.c_void_p * 3)(*[l.data_ptr() for l in lines]),
                 (ctypes.c_int * 18)(*dims), dens.data_ptr(),
                 0 if app is None else app.data_ptr(),
                 0 if app is None else app.shape[1],
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch(fn_name, err)


def field_fwd(coords: torch.Tensor, planes: Sequence[torch.Tensor],
              lines: Sequence[torch.Tensor], n_density: Sequence[int],
              line_hat: Sequence[bool]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: the fused fine field.  For i in 0..2 the bilinear sample of
    plane_i at (x_{m0}, x_{m1}) times the linear sample of line_i at
    x_{vec}, per channel; density = sum_i relu(sum of the first
    n_density[i] channels), appearance = the remaining channels of the
    three decompositions side by side.

    coords (N, 4) float32 normalized [x0, x1, x2, flag]; planes
    (2, H_i, W_i, C_i) and lines (2, L_i, C_i) bfloat16.  Returns density
    (N,) and appearance (N, sum_i C_i - n_density[i]), float32.

    Replaces ``sample_plane_packed_fastgrad`` + ``sample_line_hat`` as
    composed by ``EgoNeRF._fused_products`` / ``compute_field``
    (egonerf_tpu/ops/vm_lookup.py:467,582; models/egonerf.py:207-247).
    Kernel: csrc/vm_lookup.cu.  CPU tensors take :func:`field_fwd_plain`."""
    _check_field_args(coords, planes, lines, n_density)
    if coords.device.type == "cpu":
        return field_fwd_plain(coords, planes, lines, n_density, line_hat)
    n = coords.shape[0]
    n_app = sum(p.shape[-1] - d for p, d in zip(planes, n_density))
    dens = torch.empty(n, dtype=torch.float32, device=coords.device)
    app = torch.empty(n, n_app, dtype=torch.float32, device=coords.device)
    if n:
        _launch("vm_field_fwd", coords, planes, lines, n_density, line_hat, dens, app)
        field_fwd.launches += 1
    return dens, app


field_fwd.launches = 0


def density_fwd(coords: torch.Tensor, planes: Sequence[torch.Tensor],
                lines: Sequence[torch.Tensor]) -> torch.Tensor:
    """K3: the coarse density sum_i relu(sum_c plane_i * line_i) with float32
    line weights, on bfloat16 tables; coords as for :func:`field_fwd`.
    Returns (N,) float32.

    Replaces ``sample_plane_packed`` + ``sample_line_packed`` as composed by
    ``EgoNeRF.compute_density_feature`` (egonerf_tpu/ops/vm_lookup.py:436,504;
    models/egonerf.py:249-270).  Kernel: csrc/vm_lookup.cu.  CPU tensors
    take :func:`density_fwd_plain`."""
    n_density = [p.shape[-1] for p in planes]
    _check_field_args(coords, planes, lines, n_density)
    if coords.device.type == "cpu":
        return density_fwd_plain(coords, planes, lines)
    dens = torch.empty(coords.shape[0], dtype=torch.float32, device=coords.device)
    if coords.shape[0]:
        _launch("vm_density_fwd", coords, planes, lines, n_density, (0, 0, 0), dens, None)
        density_fwd.launches += 1
    return dens


density_fwd.launches = 0
