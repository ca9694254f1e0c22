"""The CP line product of TensorCP: K17 (forward) and K17b (its backward),
with the autograd Function that pairs them.

Counterpart of ``TensorCP._line_products`` and the density sum of
``compute_field`` / ``compute_density_feature_only``
(``egonerf_tpu/models/tensorf.py:459-487``) over JAX's line lookups: per
sample and axis i the linear sample l_i of line i at x_{VEC_MODE[i]}, the
channel product (l_0 * l_1) * l_2 in JAX's order, the density the sum of
the first ``n_density`` channels (no relu), the appearance the rest.  The
port fuses a field's density and appearance lines per axis, (1, L_i,
n_density + n_app), as ``TensorVMSplit`` fuses its tables: the two lines
of an axis share the coordinate, the row count and so the line mode.

* The line modes are K1's (``vm_lookup.HAT``, ``vm_lookup.LINEAR``): the
  bf16 tents of ``sample_line_hat`` while ``line_hat_ok`` holds under bf16
  compute, else ``sample_line_packed``'s float32 weights; JAX's padding of
  a narrow density line to 32 channels adds zero channels that the slice
  drops, so the port reads the real channels only.
* Tables are read as bf16.  The eval form takes bf16 tables, the training
  form float32 ones and rounds each value to bf16 as it reads it, so
  neither the forward nor the backward of a step casts a table.
* The backward follows JAX's VJPs through the product: dout_0 = (d l_2)
  l_1, dout_1 = (d l_2) l_0, dout_2 = d (l_0 l_1), rounded to bf16 on a hat
  axis (``_hat_bwd``), float32 on a linear one (``_line_bwd``), then w_j
  dout_i into the line's two rows, summed in float32.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .._build import check_launch, kernel
from .._device import check_tensor
from .vm_lookup import HAT, LINEAR, VEC_MODE, _line_rows, sample_line, sample_line_hat

# a lane's channels (a 4-channel chunk), and the blocks of K17 and K17b
CHUNK = 4
THREADS_PER_BLOCK = 256
BWD_THREADS_PER_BLOCK = 512


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _line_samples(coords, lines, line_modes) -> List[torch.Tensor]:
    """The three (N, C) float32 line samples of the bf16-rounded tables."""
    sel = torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
    out = []
    for i in range(3):
        fn = sample_line_hat if int(line_modes[i]) == HAT else sample_line
        out.append(fn(lines[i].to(torch.bfloat16), coords[:, VEC_MODE[i]], sel))
    return out


def cp_fwd_plain(coords, lines, n_density, line_modes):
    """Plain version of K17: see :func:`cp_fwd`.  The density is
    ``.sum(-1)`` of the product's first ``n_density`` channels."""
    l0, l1, l2 = _line_samples(coords, lines, line_modes)
    prod = (l0 * l1) * l2
    return prod[:, :n_density].sum(-1), prod[:, n_density:]


def cp_bwd_plain(coords, lines, d_dens, d_app, n_density, line_modes,
                 magnitude=False, accumulate=torch.float32) -> List[torch.Tensor]:
    """Plain version of K17b: see :func:`cp_bwd`.  With ``magnitude`` it
    scatters |contribution| instead (what a per-row tolerance is stated
    against); the float32 terms are summed in ``accumulate``."""
    l0, l1, l2 = _line_samples(coords, lines, line_modes)
    c = lines[0].shape[-1]
    dprod = torch.cat([d_dens[:, None].expand(-1, int(n_density)), d_app], dim=-1)
    d2 = dprod * l2
    douts = (d2 * l1, d2 * l0, dprod * (l0 * l1))
    sel = torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
    grads = []
    for i in range(3):
        dout = douts[i]
        if int(line_modes[i]) == HAT:
            dout = dout.to(torch.bfloat16).float()
        length = lines[i].shape[1]
        g = torch.zeros(length, c, dtype=accumulate, device=coords.device)
        for idx, wt in _line_rows(coords[:, VEC_MODE[i]], sel, length, int(line_modes[i])):
            term = wt[:, None] * dout
            g.index_add_(0, idx, (term.abs() if magnitude else term).to(accumulate))
        grads.append(g.reshape(1, length, c))
    return grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
class Layout(NamedTuple):
    """How K17 spreads a sample's channels over lanes (K17b takes its
    vector flag and :func:`bwd_geometry`)."""
    group: int      # K17's lanes a sample: a power of two, at most 32
    vector: bool    # 4 channels a lane with vector loads and stores, else scalar


def cp_layout(coords: torch.Tensor, lines: Sequence[torch.Tensor], n_density: int,
              d_app=None) -> Layout:
    """The vector instantiation needs C and ``n_density`` multiples of 4
    and 16-byte aligned coords, tables (and ``d_app``); a sample of K17
    takes the power of two of lanes that covers its 4-channel chunks, at
    most 32, the lanes looping over further chunks."""
    c = lines[0].shape[-1]
    ts = (coords, *lines) + (() if d_app is None else (d_app,))
    vector = c % CHUNK == 0 and n_density % CHUNK == 0 and all(
        t.data_ptr() % 16 == 0 for t in ts)
    chunks = max(1, -(-c // CHUNK))
    return Layout(min(32, 1 << (chunks - 1).bit_length()), vector)


def line_mode_name(line_modes: Sequence[int]) -> str:
    """The counters' name of a call's line modes: ``"hat"`` where every
    axis takes the hat, else ``"linear"`` (an axis or more on the float32
    weights)."""
    return "hat" if all(int(m) == HAT for m in line_modes) else "linear"


# K17b's gradient copies: at most this many bytes, and one for every
# SAMPLES_PER_COPY samples or part of it
WORK_BYTES = 64 << 20
SAMPLES_PER_COPY = 1 << 14


class BwdGeometry(NamedTuple):
    """K17b's launch geometry (:func:`bwd_geometry`)."""
    group: int      # lanes a sample: a power of two, at most 32
    run: int        # samples a group walks
    blocks: int     # a persistent grid: one block an SM
    copies: int     # copies of the gradient rows the blocks add into


def bwd_geometry(n: int, c: int, rows: int, vector: bool, sms: int) -> BwdGeometry:
    """K17b for ``n`` samples of ``c`` channels over lines of ``rows`` rows
    in all on ``sms`` SMs: a sample takes the power of two of lanes that
    covers its channels (4 a lane in the vector instantiation, 1 in the
    scalar one), at most 32; one block of 512 threads an SM, each group one
    run of consecutive samples; copies of the (rows, c) float32 gradient,
    one a SAMPLES_PER_COPY samples, as many as fit WORK_BYTES and at most
    one a block, so that a chain of float32 atomics takes the terms of
    about n / copies samples."""
    per_lane = CHUNK if vector else 1
    chunks = max(1, -(-c // per_lane))
    group = min(32, 1 << (chunks - 1).bit_length())
    per_block = BWD_THREADS_PER_BLOCK // group
    run = max(1, -(-n // (sms * per_block)))
    walkers = -(-n // run)
    blocks = max(1, -(-walkers // per_block))
    copies = max(1, min(blocks, WORK_BYTES // (rows * c * 4), -(-n // SAMPLES_PER_COPY)))
    return BwdGeometry(group, run, blocks, copies)


def bwd_plan(coords: torch.Tensor, lines: Sequence[torch.Tensor], n_density: int,
             d_app=None) -> Tuple[Layout, BwdGeometry]:
    """:func:`cp_bwd`'s layout and geometry for these CUDA arguments."""
    layout = cp_layout(coords, lines, n_density, d_app)
    sms = torch.cuda.get_device_properties(coords.device).multi_processor_count
    rows = sum(l.shape[1] for l in lines)
    return layout, bwd_geometry(coords.shape[0], lines[0].shape[-1], rows, layout.vector, sms)


def _dims(lines, n_density, line_modes, layout: Layout, geometry: BwdGeometry = None):
    """The C entries' dims: {L_0, L_1, L_2, three line modes, C, n_density,
    log2 of the lanes a sample, vector}, and K17b's {run, blocks, copies}."""
    modes = [int(m) for m in line_modes]
    if any(m not in (LINEAR, HAT) for m in modes):
        raise ValueError(f"line modes {tuple(line_modes)}: K17 takes LINEAR and HAT")
    group = layout.group if geometry is None else geometry.group
    dims = [l.shape[1] for l in lines] + modes + [lines[0].shape[-1], int(n_density),
                                                    group.bit_length() - 1, int(layout.vector)]
    if geometry is not None:
        dims += [geometry.run, geometry.blocks, geometry.copies]
    return (ctypes.c_int * len(dims))(*dims)


def _ptrs(ts):
    return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])


def _check_args(coords, lines, n_density, dtypes):
    check_tensor("coords", coords, torch.float32, (None, 4))
    if len(lines) != 3:
        raise ValueError("expected three lines")
    c = lines[0].shape[-1] if lines[0].dim() == 3 else 0
    dtype = lines[0].dtype
    if dtype not in dtypes:
        raise ValueError(f"expected lines of {dtypes}, got {dtype}")
    for i in range(3):
        check_tensor(f"lines[{i}]", lines[i], dtype, (1, None, c), coords.device)
    if not 0 < n_density <= c:
        raise ValueError(f"n_density={n_density} outside (0, {c}]")
    if n_density == c and dtype != torch.float32:
        raise ValueError("the density-only form (no appearance channels) takes float32 lines")
    if coords.shape[0] >= 2 ** 31:
        raise ValueError("more than 2**31 samples in one call")


_FWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


def cp_fwd(coords: torch.Tensor, lines: Sequence[torch.Tensor], n_density: int,
           line_modes: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17: the CP line product.  coords (N, 4) float32 normalized [x0, x1,
    x2, flag] (the flag is ignored: a single grid); ``lines`` three (1, L_i,
    C) tables, all bfloat16 (the eval form) or all float32 (the training
    form, read as bf16); ``line_modes`` each axis's ``HAT`` or ``LINEAR``.
    Returns the density (N,) = sum of the product's first ``n_density``
    channels and the appearance (N, C - n_density), float32.  C ==
    ``n_density`` is the density-only form (the bake, ``compute_alpha``,
    the sparsity loss), on float32 lines, which writes no appearance.

    Replaces ``TensorCP._line_products`` + the density sum over
    ``sample_line_hat`` / ``sample_line_packed``
    (egonerf_tpu/models/tensorf.py:459-487; ops/vm_lookup.py:503-518,
    581-608).  Kernel: csrc/cp_lookup.cu.  A launch counts in
    ``cp_fwd.launches`` and in ``cp_fwd.forms[(form, mode)].launches``:
    form ``"eval"`` (bf16 lines), ``"train"`` (float32 lines with
    appearance) or ``"density"``, mode :func:`line_mode_name`.  CPU tensors
    take :func:`cp_fwd_plain`."""
    n_density = int(n_density)
    _check_args(coords, lines, n_density, (torch.bfloat16, torch.float32))
    if coords.device.type == "cpu":
        return cp_fwd_plain(coords, lines, n_density, line_modes)
    n, dev = coords.shape[0], coords.device
    n_app = lines[0].shape[-1] - n_density
    dens = torch.empty(n, dtype=torch.float32, device=dev)
    app = torch.empty(n, n_app, dtype=torch.float32, device=dev)
    if n:
        f32 = lines[0].dtype == torch.float32
        layout = cp_layout(coords, lines, n_density)
        fn = kernel("cp_lookup", "cp_fwd", _FWD_ARGS)
        with torch.cuda.device(dev):
            err = fn(coords.data_ptr(), n, _ptrs(lines),
                     _dims(lines, n_density, line_modes, layout), dens.data_ptr(),
                     app.data_ptr() if n_app else 0, int(f32),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("cp_fwd", err)
        cp_fwd.launches += 1
        form = "density" if not n_app else ("train" if f32 else "eval")
        cp_fwd.forms[form, line_mode_name(line_modes)].launches += 1
    return dens, app


def _form_counters(forms) -> dict:
    return {(form, mode): SimpleNamespace(launches=0) for form in forms
            for mode in ("hat", "linear")}


cp_fwd.launches = 0
cp_fwd.forms = _form_counters(("eval", "train", "density"))


def cp_bwd(coords: torch.Tensor, lines: Sequence[torch.Tensor], d_dens: torch.Tensor,
           d_app: torch.Tensor, n_density: int, line_modes: Sequence[int]) -> List[torch.Tensor]:
    """K17b: the gradient of :func:`cp_fwd` with respect to its float32
    ``lines``.  Per sample, channel and axis i: dprod = d_dens on the first
    ``n_density`` channels and d_app on the rest; dout_0 = (dprod l_2) l_1,
    dout_1 = (dprod l_2) l_0, dout_2 = dprod (l_0 l_1), rounded to bf16 on
    a ``HAT`` axis (``_hat_bwd``), not on a ``LINEAR`` one (``_line_bwd``);
    then each of the sample's two rows of line i gets its weight times
    dout_i, summed in float32.  The gradient treats the tables' bf16 read
    as the identity, as JAX's custom VJPs do.

    coords (N, 4), d_dens (N,), d_app (N, C - n_density) float32; lines
    three (1, L_i, C) float32.  Returns three float32 gradients shaped like
    the lines.  Replaces ``_hat_bwd`` and ``_line_bwd`` through the product
    (egonerf_tpu/ops/vm_lookup.py:519-528, 611-628).  Kernel:
    csrc/cp_lookup.cu: its walk adds into copies of the gradient rows and
    a second pass sums them (:func:`bwd_geometry`).  The pair counts as one
    launch in ``cp_bwd.launches`` and in ``cp_bwd.forms[(form,
    mode)].launches``: form ``"train"`` (with appearance) or ``"density"``,
    mode :func:`line_mode_name`.  CPU tensors take :func:`cp_bwd_plain`."""
    n_density = int(n_density)
    _check_args(coords, lines, n_density, (torch.float32,))
    n, dev = coords.shape[0], coords.device
    n_app = lines[0].shape[-1] - n_density
    check_tensor("d_dens", d_dens, torch.float32, (n,), dev)
    check_tensor("d_app", d_app, torch.float32, (n, n_app), dev)
    if dev.type == "cpu":
        return cp_bwd_plain(coords, lines, d_dens, d_app, n_density, line_modes)
    rows, c = sum(l.shape[1] for l in lines), lines[0].shape[-1]
    # the second pass writes every element
    out = (torch.empty if n else torch.zeros)(rows, c, dtype=torch.float32, device=dev)
    if n:
        layout, geo = bwd_plan(coords, lines, n_density, d_app if n_app else None)
        work = torch.zeros(geo.copies * rows * c, dtype=torch.float32, device=dev)
        fn = kernel("cp_lookup", "cp_bwd", _BWD_ARGS)
        with torch.cuda.device(dev):
            err = fn(coords.data_ptr(), n, _ptrs(lines),
                     _dims(lines, n_density, line_modes, layout, geo), d_dens.data_ptr(),
                     d_app.data_ptr() if n_app else 0, work.data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("cp_bwd", err)
        cp_bwd.launches += 1
        cp_bwd.forms["train" if n_app else "density", line_mode_name(line_modes)].launches += 1
    return [g.reshape(l.shape) for g, l in zip(out.split([l.shape[1] for l in lines]), lines)]


cp_bwd.launches = 0
cp_bwd.forms = _form_counters(("train", "density"))


class _CP(torch.autograd.Function):
    """K17's training form forward, K17b backward, on the float32 lines
    (``fwd`` and ``bwd`` are an ``Ops`` pair, so the plain versions run
    through the same Function).  The coords and the lines are saved; the
    backward recomputes the line samples."""

    @staticmethod
    def forward(ctx, coords, n_density, line_modes, fwd, bwd, *lines):
        tabs = [l.detach().contiguous() for l in lines]
        dens, app = fwd(coords, tabs, n_density, line_modes)
        ctx.save_for_backward(coords, *tabs)
        ctx.args = (n_density, line_modes, bwd)
        return dens, app

    @staticmethod
    def backward(ctx, d_dens, d_app):
        coords, *tabs = ctx.saved_tensors
        n_density, line_modes, bwd = ctx.args
        grads = bwd(coords, tabs, d_dens.contiguous(), d_app.contiguous(), n_density,
                    line_modes)
        return (None, None, None, None, None, *grads)


def cp_train(coords: torch.Tensor, lines: Sequence[torch.Tensor], n_density: int,
             line_modes: Sequence[int], fwd=cp_fwd, bwd=cp_bwd):
    """:func:`cp_fwd` on the float32 ``lines``, differentiable in them
    through ``bwd`` (K17b).  Returns density (N,) and appearance (N, C -
    n_density)."""
    return _CP.apply(coords, int(n_density), tuple(int(m) for m in line_modes), fwd, bwd,
                     *lines)
