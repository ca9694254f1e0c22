"""K16: the linear sample of stacked float32 lines (counterpart of
``sample_line`` in ``egonerf_tpu/ops/grid_sample.py:38-57``).

No model path of either package calls it; the port carries it as a
standalone op so that every hand-shaped op of the JAX package has a Hopper
counterpart, and ``tools/microbench_lookup.py`` times it.
Its plain version is ``vm_lookup.sample_line`` (zero padding by
``_axis_cells``' clamped pair), which gives JAX's ``_corner`` values.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import check_tensor
from .vm_lookup import _grid0, check_coord_sel
from .vm_lookup import sample_line as _sample_line

# the channels one lane of K16 reads: one 16-byte float32 load
CHUNK = 4


def sample_line_plain(lines, coord, sel=None) -> torch.Tensor:
    """Plain version of K16: see :func:`sample_line`."""
    return _sample_line(lines, coord, _grid0(sel, coord.shape[0], coord.device))


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p]


def sample_line(lines: torch.Tensor, coord: torch.Tensor, sel=None) -> torch.Tensor:
    """K16: the linear sample of a float32 (S, L, C) stack at normalized
    ``coord`` (align_corners; a corner outside the grid weighs 0) on grid
    ``sel``, grid 0 where None (S = 1).  coord (N,) float32; sel None or
    (N,) int64.  Returns (N, C) float32: line[clip(i0)] (1 - t) +
    line[clip(i0 + 1)] t over the valid corners.

    Replaces ``egonerf_tpu/ops/grid_sample.py::sample_line`` (:38-57, its
    ``_corner`` :23-35).  Kernel: csrc/grid_sample.cu.  CPU tensors take
    :func:`sample_line_plain`."""
    check_tensor("lines", lines, torch.float32, (None, None, None))
    n = check_coord_sel((coord,), sel, lines)
    if lines.device.type == "cpu":
        return sample_line_plain(lines, coord, sel)
    dev = lines.device
    _, l, c = lines.shape
    out = torch.empty(n, c, dtype=torch.float32, device=dev)
    if n:
        chunks = max(1, -(-c // CHUNK))
        group = min(32, 1 << (chunks - 1).bit_length())
        vec = c % CHUNK == 0 and lines.data_ptr() % 16 == 0
        dims = (ctypes.c_int * 4)(l, c, group.bit_length() - 1, int(vec))
        fn = kernel("grid_sample", "line_sample", _ARGS)
        with torch.cuda.device(dev):
            err = fn(coord.data_ptr(), 0 if sel is None else sel.data_ptr(), n, lines.data_ptr(),
                     dims, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("line_sample", err)
        sample_line.launches += 1
    return out


sample_line.launches = 0
