"""VM-grid lookups: the plain plane and line samples, the fused field
kernels K1 (fine density + appearance) and K3 (coarse density), and K2,
K1's backward, with the autograd Function that pairs them.

Counterpart of ``egonerf_tpu/ops/vm_lookup.py``, read for what it computes
and not for its TPU layout: no corner packing, no one-hot or hat matmuls,
no channel padding.  What carries over exactly:

* Tables are read as bf16 (the JAX forward casts in ``pack_plane`` /
  ``pack_line``); corner weights and sums are float32.
* Cell semantics of ``_axis_cells``: indices clamp, a coord one cell below
  -1 puts its weight t on corner 0, out-of-range corners weigh 0.
* Stacks of one or two grids: with two (EgoNeRF's yin and yang) the {0, 1}
  chart flag in the coords' fourth column selects one; with one
  (TensoRF's single grid) the flag column is ignored, as JAX's lookups
  with ``sel=None``.  ``line_hat_ok`` counts the stacked rows S*L.
* The fine line lookup takes one of three line modes a decomposition,
  the ``line_hat`` entries of K1 and K2:

  - ``HAT`` (1): the hat path of ``sample_line_hat``, while
    :func:`line_hat_ok` holds (JAX's ``_onehot_ok`` gate): the two line
    weights are tents max(0, 1-|pos-j|) at pos = p + sel*L, rounded to
    bf16, and the backward rounds the line's cotangent to bf16;
  - ``LINEAR`` (0): the float32 ``_axis_cells`` pair (``sample_line_packed``,
    always for the coarse lookup), with a float32 backward;
  - ``LINEAR_BF16_GRAD`` (2): ``sample_line_packed_fastgrad``, which
    ``EGONERF_LINE_HAT=0`` gives EgoNeRF's fine lines: the forward of
    ``LINEAR``, and a backward that rounds each corner's cotangent w * dl to
    bf16 before the float32 sum, as ``_line_bwd_onehot`` does while
    :func:`line_onehot_ok` holds (``LINEAR`` otherwise).
* The fine density ``sum_i jnp.maximum(partial_i, 0)`` has JAX's gradient:
  1 where a partial is > 0, 0.5 where it is exactly 0, 0 below.  K1 in
  training writes each partial's state (the relu mask) from the sums that
  gave the relu, and K2 takes it, so one sum decides the relu both ways.
* The sparsity loss differentiates the density alone
  (:func:`density_train`): K3's training instantiation writes the relu
  mask as K1's does, and K2 at no appearance channels, in line mode
  ``LINEAR``, is its backward.
* TensorVM sums each partial raw (JAX's ``_density_relu = False``):
  ``relu=False`` takes K1's and K3's relu-free instantiations (a single
  grid; no mask) and K2's, which passes the density cotangent at scale 1.
"""
from __future__ import annotations

import ctypes
import os
from types import SimpleNamespace
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .._build import check_launch, kernel
from .._device import check_tensor

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

# JAX's hat-matrix and one-hot gates (vm_lookup.py:63-73): at most 1,152
# stacked rows for the hat forward, 4,096 for the one-hot line backward, and
# an (N, rows) bf16 matrix of at most 3e9 bytes
_ONEHOT_FWD_MAX_ROWS = 1152
_ONEHOT_BWD_MAX_ROWS = 4096
_ONEHOT_MAX_BYTES = 3e9

# EGONERF_LINE_HAT=0 takes the fine lines off the hat path, as in JAX
# (egonerf_tpu/ops/vm_lookup.py:93); read once, at import
LINE_HAT = os.environ.get("EGONERF_LINE_HAT", "1") == "1"

# the line modes of K1 and K2, one a decomposition (module docstring)
LINEAR, HAT, LINEAR_BF16_GRAD = 0, 1, 2


def line_hat_ok(n_rows: int, n_idx: int) -> bool:
    """Whether JAX's fine line lookup takes the bf16 hat path for a table of
    ``n_rows`` stacked rows sampled at ``n_idx`` points."""
    return n_rows <= _ONEHOT_FWD_MAX_ROWS and n_rows * n_idx * 2 <= _ONEHOT_MAX_BYTES


def line_onehot_ok(n_rows: int, n_idx: int) -> bool:
    """Whether JAX's ``_line_bwd_onehot`` takes the bf16 one-hot
    contraction (and not the float32 ``_line_bwd``) for a table of
    ``n_rows`` stacked rows sampled at ``n_idx`` points."""
    return n_rows <= _ONEHOT_BWD_MAX_ROWS and n_rows * n_idx * 2 <= _ONEHOT_MAX_BYTES


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


def chart_sel(coords: torch.Tensor, n_grids: int) -> torch.Tensor:
    """(N,) int64 grid of each sample: the chart flag of (N, 4) coords on a
    stack of two grids, 0 on a single grid."""
    if n_grids == 1:
        return torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
    return coords[:, 3].to(torch.int64)


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


def _warp_order_sum(prod: torch.Tensor) -> torch.Tensor:
    """(N, CD) -> (N,): the sum in the order K1 and K3 take it on the card.
    Channel c lies in chunk c // 8 and chunk q belongs to lane q mod 32;
    each lane adds its channels in increasing c, then a butterfly over xor
    offsets 16, 8, 4, 2, 1.  K1 and K3 spread the chunks over a group of G
    lanes instead (chunk q to lane q mod G, butterfly G/2 .. 1,
    csrc/vm_lookup.cu).  Lanes past the last chunk hold zeros, and adding a
    zero changes no bit, so both equal the butterfly over the smallest
    power of two of lanes that holds every chunk, which is what this
    takes."""
    n, cd = prod.shape
    lanes = min(32, 1 << (max(1, -(-cd // CHUNK)) - 1).bit_length())
    width = max(1, -(-cd // (lanes * CHUNK))) * lanes * CHUNK
    x = torch.nn.functional.pad(prod, (0, width - cd)).reshape(n, -1, lanes, CHUNK)
    terms = x.permute(0, 2, 1, 3).reshape(n, lanes, -1)  # per lane, in its order
    acc = terms[:, :, 0]
    for k in range(1, terms.shape[2]):
        acc = acc + terms[:, :, k]
    lane = torch.arange(lanes, device=prod.device)
    off = lanes // 2
    while off:
        acc = acc + acc[:, lane ^ off]
        off //= 2
    return acc[:, 0]


def relu_states(partial: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 relu state of density partials: 2 where > 0, 1 where
    == 0, 0 where < 0 (NaN included).  Half the state is the factor
    ``jnp.maximum(partial, 0)``'s gradient passes: 1, 0.5 (a tie) or 0."""
    return (partial > 0).to(torch.uint8) * 2 + (partial == 0).to(torch.uint8)


def relu_scale(mask: torch.Tensor, i: int) -> torch.Tensor:
    """(N,) float32 factor of decomposition ``i``'s density cotangent under
    the relu ``mask`` (bits 2i, 2i+1 hold its state): 1, 0.5 or 0."""
    return ((mask >> (2 * i)) & 3).to(torch.float32) * 0.5


def field_fwd_plain(coords, planes, lines, n_density, line_hat, with_mask=False, relu=True):
    """Plain version of K1: see :func:`field_fwd`.  The density partials
    are ``.sum(-1)`` (eager JAX's bits); the mask, with ``with_mask``,
    comes from the same sums that give the relu."""
    xyz = coords[:, :3]
    sel = chart_sel(coords, planes[0].shape[0])
    dens = torch.zeros(coords.shape[0], dtype=torch.float32, device=coords.device)
    mask = torch.zeros(coords.shape[0], dtype=torch.uint8, device=coords.device)
    parts = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        p = sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
        line_fn = sample_line_hat if line_hat[i] == HAT else sample_line
        prod = p * line_fn(lines[i], xyz[:, VEC_MODE[i]], sel)
        partial = prod[:, : n_density[i]].sum(-1)
        dens = dens + (torch.relu(partial) if relu else partial)
        mask |= relu_states(partial) << (2 * i)
        parts.append(prod[:, n_density[i]:])
    app = torch.cat(parts, dim=-1)
    return (dens, app, mask) if with_mask else (dens, app)


def density_fwd_plain(coords, planes, lines, with_mask=False, relu=True):
    """Plain version of K3: see :func:`density_fwd`.  Each partial is summed
    in K3's lane order (:func:`_warp_order_sum`): K4 places the fine
    samples from these densities, so a last bit moves a sample.  The mask,
    with ``with_mask``, comes from the same sums that give the relu."""
    xyz = coords[:, :3]
    sel = chart_sel(coords, planes[0].shape[0])
    dens = torch.zeros(coords.shape[0], dtype=torch.float32, device=coords.device)
    mask = torch.zeros(coords.shape[0], dtype=torch.uint8, device=coords.device)
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        p = sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
        l = sample_line(lines[i], xyz[:, VEC_MODE[i]], sel)
        partial = _warp_order_sum(p * l)
        dens = dens + (torch.relu(partial) if relu else partial)
        mask |= relu_states(partial) << (2 * i)
    return (dens, mask) if with_mask else dens


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_FWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_DENSITY_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                 ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                 ctypes.c_void_p, ctypes.c_void_p]
# vm_density_train_fwd: the mask before the stream
_DENSITY_MASK_ARGS = _DENSITY_ARGS[:-1] + [ctypes.c_void_p] * 2


def _check_field_args(coords, planes, lines, n_density):
    check_tensor("coords", coords, torch.float32, (None, 4))
    if len(planes) != 3 or len(lines) != 3 or len(n_density) != 3:
        raise ValueError("expected three planes, three lines and three density widths")
    s = planes[0].shape[0] if planes[0].dim() == 4 else 0
    if s not in (1, 2):
        raise ValueError(f"expected stacks of 1 or 2 grids, got planes[0] of shape "
                         f"{tuple(planes[0].shape)}")
    for i in range(3):
        check_tensor(f"planes[{i}]", planes[i], torch.bfloat16, (s, None, None, None),
                     coords.device)
        c = planes[i].shape[-1]
        check_tensor(f"lines[{i}]", lines[i], torch.bfloat16, (s, None, c), coords.device)
        if not 0 <= n_density[i] <= c:
            raise ValueError(f"n_density[{i}]={n_density[i]} outside [0, {c}]")
    if coords.shape[0] >= 2 ** 31:
        raise ValueError("more than 2**31 samples in one call")


# K1/K3's block, the channels one lane reads (16 bytes of bf16), and the
# largest appearance tile K1's vector instantiation stages in shared memory
THREADS_PER_BLOCK = 256
CHUNK = 8
MAX_TILE_BYTES = 48 * 1024
# K2's channels a lane in its vector instantiation (one 16-byte RED; the
# scalar one takes one)
BWD_CHUNK = 4


class Layout(NamedTuple):
    """How K1 and K3 spread samples over lanes (csrc/vm_lookup.cu)."""
    group: int              # lanes a sample takes: a power of two, at most 32
    samples_per_warp: int
    samples_per_block: int
    vector: bool            # 16-byte loads (and K1's bulk-copy store), else 2-byte loads


def lookup_layout(coords: torch.Tensor, planes: Sequence[torch.Tensor],
                  lines: Sequence[torch.Tensor], n_app: int = 0) -> Layout:
    """The instantiation and geometry K1/K3 take for these tables (and K1's
    ``n_app`` appearance channels): a sample takes the power of two of
    lanes that covers ceil(max C / 8) chunks of 8 channels (at most 32;
    lanes then loop over the further chunks).  The vector instantiation
    needs every C % 8 == 0, 16-byte aligned coords and tables, and, for
    K1's bulk copy, n_app % 4 == 0 and a block's appearance rows within
    48 KB; anything else takes the scalar one."""
    chunks = max(1, -(-max(p.shape[-1] for p in planes) // CHUNK))
    group = min(32, 1 << (chunks - 1).bit_length())
    per_block = THREADS_PER_BLOCK // group
    vector = (all(p.shape[-1] % CHUNK == 0 for p in planes)
              and all(t.data_ptr() % 16 == 0 for t in (coords, *planes, *lines))
              and n_app % 4 == 0 and per_block * n_app * 4 <= MAX_TILE_BYTES)
    return Layout(group, 32 // group, per_block, vector)


class BwdLayout(NamedTuple):
    """How K2 spreads samples over lanes (csrc/vm_lookup.cu)."""
    group: int       # lanes a sample takes
    vector: bool     # 4 channels a lane: 8-byte loads, 16-byte REDs; else one channel a lane


def bwd_layout(plane_shapes: Sequence[Sequence[int]], n_density: Sequence[int],
               aligned: bool = True) -> BwdLayout:
    """K2's layout for planes (S, H, W, C) of these shapes.  The vector
    instantiation (every C and n_density a multiple of 4, and ``aligned``:
    16-byte aligned coords, tables and d_app) gives a lane 4 channels, the
    scalar one 1; a sample takes the power of two of lanes that covers the
    widest row (at most 32; further channels take further passes)."""
    cs = [int(p[-1]) for p in plane_shapes]
    vector = aligned and all(c % BWD_CHUNK == 0 and int(d) % BWD_CHUNK == 0
                             for c, d in zip(cs, n_density))
    chunks = max(1, -(-max(cs) // (BWD_CHUNK if vector else 1)))
    return BwdLayout(min(32, 1 << (chunks - 1).bit_length()), vector)


def _bwd_layout_of(coords, planes, lines, n_density, d_app) -> BwdLayout:
    return bwd_layout([p.shape for p in planes], n_density,
                      all(t.data_ptr() % 16 == 0 for t in (coords, d_app, *planes, *lines)))


def _dims(coords, planes, lines, n_density, line_hat, bwd=None):
    """The kernels' int array: per decomposition {H, W, L, C, n_density,
    line mode}; then the stack size, log2 of K1/K3's lanes a sample and their
    vector flag (:func:`lookup_layout`); then log2 of K2's lanes a sample
    and its vector flag (``bwd``, a :class:`BwdLayout`; zeros for K1/K3)."""
    dims = []
    for i in range(3):
        _, h, w, c = planes[i].shape
        mode = int(line_hat[i])
        if mode not in (LINEAR, HAT, LINEAR_BF16_GRAD):
            raise ValueError(f"line mode {line_hat[i]!r} of decomposition {i}")
        dims += [h, w, lines[i].shape[1], c, int(n_density[i]), mode]
    n_app = sum(p.shape[-1] - int(d) for p, d in zip(planes, n_density))
    layout = lookup_layout(coords, planes, lines, n_app)
    dims += [planes[0].shape[0], layout.group.bit_length() - 1, int(layout.vector)]
    dims += [0, 0] if bwd is None else [bwd.group.bit_length() - 1, int(bwd.vector)]
    return (ctypes.c_int * 23)(*dims)


def _tables(planes, lines):
    ptrs = ctypes.c_void_p * 3
    return ptrs(*[p.data_ptr() for p in planes]), ptrs(*[l.data_ptr() for l in lines])


def _check_relu(relu: bool, with_mask: bool, planes) -> None:
    if not relu and (with_mask or planes[0].shape[0] != 1):
        raise ValueError("the relu-free forms (TensorVM) take a single grid and write no mask")


def field_fwd(coords: torch.Tensor, planes: Sequence[torch.Tensor],
              lines: Sequence[torch.Tensor], n_density: Sequence[int],
              line_hat: Sequence[int], with_mask: bool = False, relu: bool = True):
    """K1: the fused fine field.  For i in 0..2 the bilinear sample of
    plane_i at (x_{m0}, x_{m1}) times the linear sample of line_i at
    x_{vec}, per channel; density = sum_i relu(sum of the first
    n_density[i] channels), appearance = the remaining channels of the
    three decompositions side by side.

    coords (N, 4) float32 normalized [x0, x1, x2, flag]; planes
    (S, H_i, W_i, C_i) and lines (S, L_i, C_i) bfloat16, S = 2 (the flag
    selects the grid) or 1 (the flag is ignored); ``line_hat`` holds each
    decomposition's line mode (``HAT`` takes the bf16 tents, the others the
    float32 pair; True and False are ``HAT`` and ``LINEAR``).  Returns density
    (N,) and appearance (N, sum_i C_i - n_density[i]), float32; with
    ``with_mask`` also the relu mask (N,) uint8, decomposition i's
    :func:`relu_states` at bits 2i, 2i+1, from the sums that gave the
    density (K2's input).  ``relu=False`` (TensorVM, a single grid, no
    mask) sums each partial raw: sum_i (sum of the first n_density[i]
    channels), in the order 0 + d_0 + d_1 + d_2; a launch counts also in
    ``field_fwd.norelu_form.launches``.

    Replaces ``sample_plane_packed_fastgrad`` + ``sample_line_hat`` as
    composed by ``EgoNeRF._fused_products`` / ``compute_field`` and by
    ``TensorVMSplit.compute_field`` with ``sel=None``
    (egonerf_tpu/ops/vm_lookup.py:467,582; models/egonerf.py:207-247,
    models/tensorf.py:325-349).
    Kernel: csrc/vm_lookup.cu.  CPU tensors take :func:`field_fwd_plain`."""
    _check_field_args(coords, planes, lines, n_density)
    _check_relu(relu, with_mask, planes)
    if coords.device.type == "cpu":
        return field_fwd_plain(coords, planes, lines, n_density, line_hat, with_mask, relu)
    n = coords.shape[0]
    dev = coords.device
    n_app = sum(p.shape[-1] - d for p, d in zip(planes, n_density))
    dens = torch.empty(n, dtype=torch.float32, device=dev)
    app = torch.empty(n, n_app, dtype=torch.float32, device=dev)
    mask = torch.empty(n, dtype=torch.uint8, device=dev) if with_mask else None
    if n:
        name = "vm_field_fwd" if relu else "vm_field_fwd_norelu"
        fn = kernel("vm_lookup", name, _FWD_ARGS)
        with torch.cuda.device(dev):
            err = fn(coords.data_ptr(), n, *_tables(planes, lines),
                     _dims(coords, planes, lines, n_density, line_hat), dens.data_ptr(),
                     app.data_ptr(), n_app, 0 if mask is None else mask.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch(name, err)
        field_fwd.launches += 1
        if not relu:
            field_fwd.norelu_form.launches += 1
    return (dens, app, mask) if with_mask else (dens, app)


field_fwd.launches = 0
field_fwd.norelu_form = SimpleNamespace(launches=0)


def density_fwd(coords: torch.Tensor, planes: Sequence[torch.Tensor],
                lines: Sequence[torch.Tensor], with_mask: bool = False, relu: bool = True):
    """K3: the coarse density sum_i relu(sum_c plane_i * line_i) with float32
    line weights, on bfloat16 tables; coords as for :func:`field_fwd`.
    Returns (N,) float32; with ``with_mask`` (the training instantiation,
    the sparsity loss's density) also the relu mask (N,) uint8 of
    :func:`field_fwd`, from the sums that gave the density (K2's input).

    Replaces ``sample_plane_packed`` + ``sample_line_packed`` as composed by
    ``EgoNeRF.compute_density_feature`` and
    ``TensorVMSplit.compute_density_feature_only``, over the real channels
    only (egonerf_tpu/ops/vm_lookup.py:436,504; models/egonerf.py:249-270,
    models/tensorf.py:351-367).  Kernel: csrc/vm_lookup.cu.  A launch
    counts in ``density_fwd.launches``, with the mask also in
    ``density_fwd.train_form.launches``.  ``relu=False`` (TensorVM, a
    single grid, no mask) sums the partials raw, as :func:`field_fwd`;
    such a launch counts also in ``density_fwd.norelu_form.launches``.
    CPU tensors take :func:`density_fwd_plain`."""
    n_density = [p.shape[-1] for p in planes]
    _check_field_args(coords, planes, lines, n_density)
    _check_relu(relu, with_mask, planes)
    if coords.device.type == "cpu":
        return density_fwd_plain(coords, planes, lines, with_mask, relu)
    dev = coords.device
    n = coords.shape[0]
    dens = torch.empty(n, dtype=torch.float32, device=dev)
    mask = torch.empty(n, dtype=torch.uint8, device=dev) if with_mask else None
    if n:
        name = ("vm_density_train_fwd" if with_mask
                else "vm_density_fwd" if relu else "vm_density_fwd_norelu")
        fn = kernel("vm_lookup", name, _DENSITY_MASK_ARGS if with_mask else _DENSITY_ARGS)
        with torch.cuda.device(dev):
            err = fn(coords.data_ptr(), n, *_tables(planes, lines),
                     _dims(coords, planes, lines, n_density, (0, 0, 0)), dens.data_ptr(),
                     *((mask.data_ptr(),) if with_mask else ()),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch(name, err)
        density_fwd.launches += 1
        if with_mask:
            density_fwd.train_form.launches += 1
        if not relu:
            density_fwd.norelu_form.launches += 1
    return (dens, mask) if with_mask else dens


density_fwd.launches = 0
density_fwd.train_form = SimpleNamespace(launches=0)
density_fwd.norelu_form = SimpleNamespace(launches=0)


# ---------------------------------------------------------------------------
# K2: the fine field's backward
# ---------------------------------------------------------------------------
def _plane_corners(x, y, sel, h, w):
    """The four (flat cell index, weight) pairs of :func:`sample_plane`."""
    x0, wx0, wx1 = _axis_cells(x, w)
    y0, wy0, wy1 = _axis_cells(y, h)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    base = sel * (h * w)
    return ((base + y0 * w + x0, wy0 * wx0), (base + y0 * w + x1, wy0 * wx1),
            (base + y1 * w + x0, wy1 * wx0), (base + y1 * w + x1, wy1 * wx1))


def _line_rows(coord, sel, l, hat):
    """The two (flat row index, weight) pairs of :func:`sample_line_hat`
    (``hat``) or :func:`sample_line`."""
    if hat == HAT:
        p = (coord + 1.0) * 0.5 * (l - 1)
        pos = p + sel.to(p.dtype) * l
        jf = torch.floor(pos)
        first = sel * l
        rows = []
        for jj in (jf, jf + 1.0):
            tent = (1.0 - (pos - jj).abs()).clamp_min(0.0)
            j = jj.to(torch.int64)
            in_chart = (j >= first) & (j <= first + l - 1)
            wt = torch.where(in_chart, tent, torch.zeros_like(tent)).to(torch.bfloat16).float()
            rows.append((j.clamp(first, first + l - 1), wt))
        return rows
    i0, w0, w1 = _axis_cells(coord, l)
    return ((sel * l + i0, w0), (sel * l + (i0 + 1).clamp_max(l - 1), w1))


def field_bwd_plain(coords, planes, lines, d_dens, d_app, mask, n_density, line_hat,
                    magnitude=False, accumulate=torch.float32, relu=True):
    """Plain version of K2: see :func:`field_bwd`.  With ``magnitude`` it
    scatters |contribution| instead, so that each cell holds the sum of the
    absolute terms that a float32 tolerance is stated against.  The float32
    terms are summed in ``accumulate``: float64 gives the exact sum of the
    same terms, a reference for a cell that a million samples hit, where
    float32's own rounding reaches 1e-4 of the terms."""
    xyz = coords[:, :3]
    sel = chart_sel(coords, planes[0].shape[0])
    g_planes, g_lines = [], []
    off = 0
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        s, h, w, c = planes[i].shape
        l = lines[i].shape[1]
        cd = int(n_density[i])
        pv = sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
        line_fn = sample_line_hat if line_hat[i] == HAT else sample_line
        lv = line_fn(lines[i], xyz[:, VEC_MODE[i]], sel)
        dd = d_dens * relu_scale(mask, i) if relu else d_dens
        dprod = torch.cat([dd[:, None].expand(-1, cd), d_app[:, off:off + c - cd]], dim=-1)
        off += c - cd
        dp = dprod * lv
        dl = dprod * pv
        if line_hat[i] == HAT:
            dl = dl.to(torch.bfloat16).float()
        if magnitude:
            dp, dl = dp.abs(), dl.abs()
        gp = torch.zeros(s * h * w, c, dtype=accumulate, device=coords.device)
        for idx, wt in _plane_corners(xyz[:, m0], xyz[:, m1], sel, h, w):
            gp.index_add_(0, idx, (wt[:, None] * dp).to(accumulate))
        gl = torch.zeros(s * l, c, dtype=accumulate, device=coords.device)
        for idx, wt in _line_rows(xyz[:, VEC_MODE[i]], sel, l, line_hat[i]):
            corner = wt[:, None] * dl
            if line_hat[i] == LINEAR_BF16_GRAD:
                corner = corner.to(torch.bfloat16).float()
            gl.index_add_(0, idx, corner.to(accumulate))
        g_planes.append(gp.reshape(s, h, w, c))
        g_lines.append(gl.reshape(s, l, c))
    return g_planes, g_lines


_BWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
             ctypes.c_void_p]


def field_bwd(coords: torch.Tensor, planes: Sequence[torch.Tensor],
              lines: Sequence[torch.Tensor], d_dens: torch.Tensor, d_app: torch.Tensor,
              mask, n_density: Sequence[int], line_hat: Sequence[int], relu: bool = True
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """K2: the gradient of :func:`field_fwd` with respect to its tables.
    Per sample and decomposition i: dprod = d_dens times
    :func:`relu_scale` of the forward's ``mask`` (1, 0.5 at an exact zero
    partial, 0; ``jnp.maximum``'s gradient) on the density channels and
    d_app on the rest; dp = dprod * line and dl = dprod * plane; w_k * dp
    into the four plane corners and the line weights times dl into the two
    line rows, all summed in float32.  The line mode decides the roundings:
    ``HAT`` rounds dl to bf16 (as ``_hat_bwd`` rounds its cotangent),
    ``LINEAR_BF16_GRAD`` each corner's w_j * dl (as ``_line_bwd_onehot``),
    ``LINEAR`` none.  The gradient treats the bf16
    cast of the tables as the identity, as JAX's custom VJPs do.

    coords (N, 4), d_dens (N,) and d_app (N, sum_i C_i - n_density[i])
    float32; mask (N,) uint8 from ``field_fwd(..., with_mask=True)``;
    planes and lines bfloat16 as for :func:`field_fwd`.  Returns float32
    gradients shaped like the planes and the lines.  The kernel's lanes
    follow :func:`bwd_layout`.  ``relu=False`` (TensorVM's raw sums, a
    single grid, line modes ``LINEAR`` and ``HAT``) passes d_dens at scale 1
    on every decomposition and reads no ``mask`` (None); such a launch
    counts also in ``field_bwd.norelu_form.launches``.

    Replaces ``_plane_bwd_bf16`` + ``_hat_bwd`` (``_plane_bwd`` +
    ``_line_bwd`` where the lines take float32 weights, ``_line_bwd_onehot``
    under ``EGONERF_LINE_HAT=0``)
    (egonerf_tpu/ops/vm_lookup.py:482,611,456,519,544).  Kernel:
    csrc/vm_lookup.cu.  CPU tensors take :func:`field_bwd_plain`."""
    _check_field_args(coords, planes, lines, n_density)
    n = coords.shape[0]
    n_app = sum(p.shape[-1] - d for p, d in zip(planes, n_density))
    check_tensor("d_dens", d_dens, torch.float32, (n,), coords.device)
    check_tensor("d_app", d_app, torch.float32, (n, n_app), coords.device)
    if relu:
        check_tensor("mask", mask, torch.uint8, (n,), coords.device)
    else:
        _check_relu(relu, False, planes)
        if LINEAR_BF16_GRAD in tuple(int(h) for h in line_hat):
            raise ValueError("the relu-free K2 takes line modes LINEAR and HAT")
    if any(t.numel() >= 2 ** 31 for t in (*planes, *lines)):
        raise ValueError("a table of 2**31 elements or more (K2 indexes rows in int)")
    if coords.device.type == "cpu":
        return field_bwd_plain(coords, planes, lines, d_dens, d_app, mask, n_density, line_hat,
                               relu=relu)
    dev = coords.device
    g_planes = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in planes]
    g_lines = [torch.zeros(l.shape, dtype=torch.float32, device=dev) for l in lines]
    if n:
        name = "vm_field_bwd" if relu else "vm_field_bwd_norelu"
        fn = kernel("vm_lookup", name, _BWD_ARGS)
        layout = _bwd_layout_of(coords, planes, lines, n_density, d_app)
        with torch.cuda.device(dev):
            err = fn(coords.data_ptr(), n, *_tables(planes, lines),
                     _dims(coords, planes, lines, n_density, line_hat, layout),
                     d_dens.data_ptr(), d_app.data_ptr(), mask.data_ptr() if relu else 0, n_app,
                     *_tables(g_planes, g_lines), torch.cuda.current_stream(dev).cuda_stream)
        check_launch(name, err)
        field_bwd.launches += 1
        if n_app == 0:
            field_bwd.density_form.launches += 1
        if not relu:
            field_bwd.norelu_form.launches += 1
    return g_planes, g_lines


# K2's launches; those with no appearance channels (the backward of
# density_train, the sparsity loss's) and the relu-free ones also apart
field_bwd.launches = 0
field_bwd.density_form = SimpleNamespace(launches=0)
field_bwd.norelu_form = SimpleNamespace(launches=0)


def _no_mask(coords: torch.Tensor) -> torch.Tensor:
    """The saved stand-in for the relu mask where the relu-free forms write
    none."""
    return coords.new_empty(0, dtype=torch.uint8)


class _Field(torch.autograd.Function):
    """K1 forward, K2 backward on float32 tables (``fwd`` and ``bwd`` are
    an ``Ops`` pair, so the plain versions run through the same Function).
    The tables are cast to bf16 inside; the coords, the bf16 tables and
    K1's relu mask (none without the relu) are saved, and the backward
    recomputes the lookups."""

    @staticmethod
    def forward(ctx, coords, n_density, line_hat, relu, fwd, bwd, *tables):
        bf16 = [t.detach().to(torch.bfloat16).contiguous() for t in tables]
        if relu:
            dens, app, mask = fwd(coords, bf16[:3], bf16[3:], n_density, line_hat,
                                  with_mask=True)
        else:
            dens, app = fwd(coords, bf16[:3], bf16[3:], n_density, line_hat, relu=False)
            mask = _no_mask(coords)
        ctx.save_for_backward(coords, mask, *bf16)
        ctx.args = (n_density, line_hat, relu, bwd)
        return dens, app

    @staticmethod
    def backward(ctx, d_dens, d_app):
        coords, mask, *bf16 = ctx.saved_tensors
        n_density, line_hat, relu, bwd = ctx.args
        g_planes, g_lines = bwd(coords, bf16[:3], bf16[3:], d_dens.contiguous(),
                                d_app.contiguous(), mask if relu else None, n_density, line_hat,
                                relu=relu)
        return (None, None, None, None, None, None, *g_planes, *g_lines)


def field_train(coords: torch.Tensor, planes: Sequence[torch.Tensor],
                lines: Sequence[torch.Tensor], n_density: Sequence[int],
                line_hat: Sequence[int], fwd=field_fwd, bwd=field_bwd, relu: bool = True):
    """:func:`field_fwd` on float32 ``planes`` and ``lines`` (read as
    bf16), differentiable in them through ``bwd`` (K2); ``line_hat`` holds
    each decomposition's line mode, ``relu=False`` takes the relu-free
    pair (TensorVM).  Returns density (N,) and appearance (N, n_app)."""
    return _Field.apply(coords, tuple(int(d) for d in n_density),
                        tuple(int(h) for h in line_hat), bool(relu), fwd, bwd, *planes, *lines)


class _Density(torch.autograd.Function):
    """K3's training instantiation forward, K2 at no appearance channels
    backward (``fwd`` and ``bwd`` an ``Ops`` pair): the density alone,
    differentiable in its float32 tables, as JAX differentiates
    ``sample_plane_packed`` and ``sample_line_packed`` (their float32
    ``_plane_bwd`` and ``_line_bwd``: K2's line mode ``LINEAR``).  The
    tables are cast to bf16 inside; the coords, the bf16 tables and K3's
    relu mask (none without the relu: the eval instantiation's raw sums)
    are saved."""

    @staticmethod
    def forward(ctx, coords, relu, fwd, bwd, *tables):
        bf16 = [t.detach().to(torch.bfloat16).contiguous() for t in tables]
        if relu:
            dens, mask = fwd(coords, bf16[:3], bf16[3:], with_mask=True)
        else:
            dens, mask = fwd(coords, bf16[:3], bf16[3:], relu=False), _no_mask(coords)
        ctx.save_for_backward(coords, mask, *bf16)
        ctx.args = (relu, bwd)
        return dens

    @staticmethod
    def backward(ctx, d_dens):
        coords, mask, *bf16 = ctx.saved_tensors
        relu, bwd = ctx.args
        n_density = [p.shape[-1] for p in bf16[:3]]
        d_app = torch.empty(coords.shape[0], 0, dtype=torch.float32, device=coords.device)
        g_planes, g_lines = bwd(coords, bf16[:3], bf16[3:], d_dens.contiguous(), d_app,
                                mask if relu else None, n_density, (LINEAR,) * 3,
                                relu=relu)
        return (None, None, None, None, *g_planes, *g_lines)


def density_train(coords: torch.Tensor, planes: Sequence[torch.Tensor],
                  lines: Sequence[torch.Tensor], fwd=density_fwd, bwd=field_bwd,
                  relu: bool = True) -> torch.Tensor:
    """:func:`density_fwd` on float32 ``planes`` and ``lines`` (read as
    bf16, stacks of 2 or 1 grids), differentiable in them through ``bwd``
    (K2 with every channel a density channel, float32 line weights, and
    JAX's relu-tie rule, half the gradient at an exactly zero partial;
    ``relu=False``, TensorVM's raw sums, the cotangent at scale 1).
    Returns the density (N,)."""
    return _Density.apply(coords, bool(relu), fwd, bwd, *planes, *lines)


# ---------------------------------------------------------------------------
# K15: one table's lookup with no gradient
# ---------------------------------------------------------------------------
def _grid0(sel, n: int, device) -> torch.Tensor:
    """``sel``, or grid 0 for every sample where it is None (JAX's
    ``sel=None``)."""
    return torch.zeros(n, dtype=torch.int64, device=device) if sel is None else sel


def sample_plane_nograd_plain(plane, x, y, sel=None) -> torch.Tensor:
    """Plain version of K15's plane lookup: see :func:`sample_plane_nograd`."""
    return sample_plane(plane, x, y, _grid0(sel, x.shape[0], x.device))


def sample_line_nograd_plain(line, coord, sel=None) -> torch.Tensor:
    """Plain version of K15's line lookup: see :func:`sample_line_nograd`."""
    return sample_line(line, coord, _grid0(sel, coord.shape[0], coord.device))


_SAMPLE_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                ctypes.c_void_p, ctypes.c_void_p]


def check_coord_sel(coords: Sequence, sel, table: torch.Tensor) -> int:
    """The shared argument checks of K15 and K16: a table with no empty
    axis; each of ``coords`` an (N,) contiguous float32 tensor on its
    device, ``sel`` None or an (N,) int64 one.  On the CPU ``sel``'s
    values must be grids of the stack, [0, S), or IndexError; on the card
    they are not read here (that would wait for the device), and a grid
    outside the stack makes the kernel read outside the table: undefined
    behaviour.  Returns N."""
    if min(table.shape) < 1:
        raise ValueError(f"expected a table with no empty axis, got {tuple(table.shape)}")
    device = table.device
    check_tensor("coord", coords[0], torch.float32, (None,), device)
    n = coords[0].shape[0]
    for i, c in enumerate(coords[1:], 1):
        check_tensor(f"coord {i}", c, torch.float32, (n,), device)
    if sel is not None:
        check_tensor("sel", sel, torch.int64, (n,), device)
        if device.type == "cpu" and n and not 0 <= int(sel.min()) <= int(sel.max()) < len(table):
            raise IndexError(f"sel holds grids outside the stack's [0, {len(table)})")
    return n


def _sample_nograd(plane: bool, table, x, y, sel, hwc, name):
    """Launch K15 on ``table`` (``hwc``: H, W, C; a line passes L, 1, C)."""
    n, dev = x.shape[0], x.device
    c = hwc[2]
    out = torch.empty(n, c, dtype=torch.float32, device=dev)
    if n:
        chunks = max(1, -(-c // CHUNK))
        group = min(32, 1 << (chunks - 1).bit_length())
        vec = c % CHUNK == 0 and table.data_ptr() % 16 == 0
        dims = (ctypes.c_int * 5)(*hwc, group.bit_length() - 1, int(vec))
        fn = kernel("vm_lookup", "vm_sample_nograd", _SAMPLE_ARGS)
        with torch.cuda.device(dev):
            err = fn(int(plane), x.data_ptr(), y.data_ptr(), 0 if sel is None else sel.data_ptr(),
                     n, table.data_ptr(), dims, out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch(name, err)
    return out


def sample_plane_nograd(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        sel=None) -> torch.Tensor:
    """K15, the plane lookup: the bilinear sample of a bfloat16 (S, H, W, C)
    stack at normalized (x, y) (x indexes W, y H; align_corners, zero
    padding by ``_axis_cells``' clamped pair) on grid ``sel`` (grid 0
    where None), summed ((c00 + c01) + c10) + c11 in float32.  x, y (N,)
    float32; sel None or (N,) int64.  Returns (N, C) float32.

    Replaces ``sample_plane_packed_nograd`` (egonerf_tpu/ops/vm_lookup.py:
    636-642) on the port's unpacked table: JAX's packed table holds the same
    bf16 values (``pack_plane``) and its corner rule is
    ``plane_idx_weights_fac``.  Kernel: csrc/vm_lookup.cu
    (``vm_sample_kernel``).  CPU tensors take
    :func:`sample_plane_nograd_plain`."""
    check_tensor("plane", plane, torch.bfloat16, (None, None, None, None))
    check_coord_sel((x, y), sel, plane)
    if plane.device.type == "cpu":
        return sample_plane_nograd_plain(plane, x, y, sel)
    _, h, w, c = plane.shape
    out = _sample_nograd(True, plane, x, y, sel, (h, w, c), "vm_sample_nograd (plane)")
    if x.shape[0]:
        sample_plane_nograd.launches += 1
    return out


sample_plane_nograd.launches = 0


def sample_line_nograd(line: torch.Tensor, coord: torch.Tensor, sel=None) -> torch.Tensor:
    """K15, the line lookup: the linear sample of a bfloat16 (S, L, C) stack
    at normalized ``coord`` on grid ``sel`` (grid 0 where None), w0 r0 +
    w1 r1 in float32 with ``_axis_cells``' weights.  coord (N,) float32;
    sel None or (N,) int64.  Returns (N, C) float32.

    Replaces ``sample_line_packed_nograd`` (egonerf_tpu/ops/vm_lookup.py:
    645-649) on the unpacked table (``pack_line``'s bf16 values,
    ``line_idx_weights_fac``'s corner rule).  Kernel: csrc/vm_lookup.cu
    (``vm_sample_kernel``).  CPU tensors take :func:`sample_line_nograd_plain`."""
    check_tensor("line", line, torch.bfloat16, (None, None, None))
    check_coord_sel((coord,), sel, line)
    if line.device.type == "cpu":
        return sample_line_nograd_plain(line, coord, sel)
    _, l, c = line.shape
    out = _sample_nograd(False, line, coord, coord, sel, (l, 1, c), "vm_sample_nograd (line)")
    if coord.shape[0]:
        sample_line_nograd.launches += 1
    return out


sample_line_nograd.launches = 0
