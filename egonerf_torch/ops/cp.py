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
* On the card both kernels stage one channel slice of the three lines a
  block in shared memory (:func:`fwd_plan`, :func:`bwd_plan`); lines too
  long for that take the unstaged form (:func:`cp_layout`,
  :func:`bwd_geometry`).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .._build import check_launch, kernel
from .._device import check_tensor
from .vm_lookup import HAT, LINEAR, VEC_MODE, _line_rows, sample_line, sample_line_hat

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
# launch plans
# ---------------------------------------------------------------------------
# a quad of channels, the blocks of K17b and of the unstaged K17b, and
# K17's tile of samples
CHUNK = 4
BWD_THREADS_PER_BLOCK = 1024
UNSTAGED_BWD_THREADS = 512
TILE = 128
# K17b: a walker's samples a chunk, its chunks in flight or ready
STEPS = 8
BUFS = 2
# a sample's three (row, row, weight, weight) and its coords in shared memory
ROWS_BYTES = 48
COORDS_BYTES = 16
# shared memory on an H100: the most a block may use, an SM's for its
# blocks, and what the SM reserves a block
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
# the slice width: narrower slices recompute a sample's rows and weights
# for too few channels (on an H100, 16 channels ran K17 1.8x and K17b 1.3x
# slower than the unstaged form on lines of 3,517 rows, 4 and 8 channels 4x
# on 12,517), so lines too long for 32 channels take the unstaged form
WIDTH = 32
# K17b's gradient copies: at most this many bytes (so that they stay in the
# 50 MB L2), and one for every SAMPLES_PER_COPY samples or part of it
WORK_BYTES = 32 << 20
SAMPLES_PER_COPY = 1 << 14


class Layout(NamedTuple):
    """How the unstaged K17 spreads a sample's channels over lanes, and the
    global-memory access of every form."""
    group: int      # the unstaged K17's lanes a sample: a power of two, at most 32
    vector: bool    # vector loads, cp.async and stores, else a channel at a time


def cp_layout(coords: torch.Tensor, lines: Sequence[torch.Tensor], n_density: int,
              d_app=None) -> Layout:
    """The vector instantiation needs C and ``n_density`` multiples of 4
    and 16-byte aligned coords, tables (and ``d_app``); a sample of the
    unstaged K17 takes the power of two of lanes that covers its 4-channel
    chunks, at most 32, the lanes looping over further chunks."""
    c = lines[0].shape[-1]
    ts = (coords, *lines) + (() if d_app is None else (d_app,))
    vector = c % CHUNK == 0 and n_density % CHUNK == 0 and all(
        t.data_ptr() % 16 == 0 for t in ts)
    chunks = max(1, -(-c // CHUNK))
    return Layout(min(32, 1 << (chunks - 1).bit_length()), vector)


class Plan(NamedTuple):
    """A staged launch of K17 (:func:`fwd_plan`) or K17b (:func:`bwd_plan`):
    block (slice, part) stages channels slice * width .. + width - 1 of the
    three lines' rows and walks samples part * per_part .. + per_part - 1."""
    width: int           # W: channels a slice (WIDTH)
    slices: int          # ceil(C / W)
    density_slices: int  # ceil(n_density / W): the first slices, holding the density
    blocks_per_sm: int
    parts: int           # blocks a slice
    per_part: int        # samples a part
    smem: int            # dynamic shared bytes a block
    copies: int          # K17b's gradient copies, part p adding into p % copies (K17: 1)

    @property
    def blocks(self) -> int:
        return self.slices * self.parts


def staged_bytes(rows: int, width: int) -> int:
    """A slice of ``rows`` rows in all staged as bf16, to 16 bytes."""
    return -(-rows * width * 2 // 16) * 16


def fwd_smem(rows: int, width: int) -> int:
    """K17's shared memory: the slice, two tiles' rows and weights and
    three tiles' coords."""
    return staged_bytes(rows, width) + TILE * (2 * ROWS_BYTES + 3 * COORDS_BYTES)


def bwd_smem(rows: int, width: int) -> int:
    """K17b's: the slice and the own region of each walker (``width``
    lanes): BUFS chunks of STEPS samples' slices of d_app, coords and
    d_dens, and one chunk's rows and weights."""
    per_walker = BUFS * STEPS * (4 * width + COORDS_BYTES + 4) + STEPS * ROWS_BYTES
    return staged_bytes(rows, width) + BWD_THREADS_PER_BLOCK // width * per_walker


def _parts(n: int, slices: int, resident: int, unit: int) -> Tuple[int, int]:
    """(parts, samples a part): as many parts as ``resident`` blocks give a
    slice, at least one and none with fewer than ``unit`` samples."""
    n = max(n, 1)
    parts = max(1, min(resident // slices, -(-n // unit)))
    per_part = -(-n // parts)
    return -(-n // per_part), per_part


def fwd_plan(n: int, rows: int, c: int, n_density: int, sms: int):
    """K17's plan for ``n`` samples of ``c`` channels (the first
    ``n_density`` density) over lines of ``rows`` rows in all on ``sms``
    SMs: WIDTH-channel slices, two blocks an SM where they fit, else one,
    the slices sharing the resident blocks.  None past the staging limit
    (no slice fits a block): the unstaged form."""
    smem = fwd_smem(rows, WIDTH)
    per_sm = next((k for k in (2, 1) if smem <= SMEM_PER_BLOCK
                   and k * (smem + SMEM_RESERVED) <= SMEM_PER_SM), None)
    if per_sm is None:
        return None
    slices = -(-c // WIDTH)
    parts, per_part = _parts(n, slices, per_sm * sms, TILE)
    return Plan(WIDTH, slices, -(-n_density // WIDTH), per_sm, parts, per_part, smem, 1)


def bwd_plan(n: int, rows: int, c: int, n_density: int, sms: int):
    """K17b's plan, as :func:`fwd_plan`'s, one block an SM, and copies of
    the (rows, c) float32 gradient, one a SAMPLES_PER_COPY samples, as many
    as fit WORK_BYTES and at most one a part, so that a chain of float32
    atomics takes the terms of about n / copies samples.  None past the
    staging limit."""
    smem = bwd_smem(rows, WIDTH)
    if smem > SMEM_PER_BLOCK:
        return None
    slices = -(-c // WIDTH)
    parts, per_part = _parts(n, slices, sms, BWD_THREADS_PER_BLOCK // WIDTH)
    copies = max(1, min(parts, WORK_BYTES // (rows * c * 4), -(-max(n, 1) // SAMPLES_PER_COPY)))
    return Plan(WIDTH, slices, -(-n_density // WIDTH), 1, parts, per_part, smem, copies)


class BwdGeometry(NamedTuple):
    """The unstaged K17b's launch geometry (:func:`bwd_geometry`)."""
    group: int      # lanes a sample: a power of two, at most 32
    run: int        # samples a group walks
    blocks: int     # a persistent grid: one block an SM
    copies: int     # copies of the gradient rows the blocks add into


def bwd_geometry(n: int, c: int, rows: int, vector: bool, sms: int) -> BwdGeometry:
    """The unstaged K17b for ``n`` samples of ``c`` channels over lines of
    ``rows`` rows in all on ``sms`` SMs: a sample takes the power of two of
    lanes that covers its channels (4 a lane in the vector instantiation, 1
    in the scalar one), at most 32; one block of 512 threads an SM, each
    group one run of consecutive samples; copies of the gradient as
    :func:`bwd_plan`'s."""
    per_lane = CHUNK if vector else 1
    chunks = max(1, -(-c // per_lane))
    group = min(32, 1 << (chunks - 1).bit_length())
    per_block = UNSTAGED_BWD_THREADS // group
    run = max(1, -(-n // (sms * per_block)))
    walkers = -(-n // run)
    blocks = max(1, -(-walkers // per_block))
    copies = max(1, min(blocks, WORK_BYTES // (rows * c * 4), -(-n // SAMPLES_PER_COPY)))
    return BwdGeometry(group, run, blocks, copies)


def launch_plan(coords: torch.Tensor, lines: Sequence[torch.Tensor], n_density: int,
                d_app=None, backward: bool = False, unstaged: bool = False):
    """(layout, plan) of :func:`cp_fwd` (or with ``backward`` :func:`cp_bwd`)
    for these CUDA arguments: a :class:`Plan`, or the unstaged form's
    layout alone (plan None) or K17b's :class:`BwdGeometry`."""
    layout = cp_layout(coords, lines, n_density, d_app)
    sms = torch.cuda.get_device_properties(coords.device).multi_processor_count
    n, rows, c = coords.shape[0], sum(l.shape[1] for l in lines), lines[0].shape[-1]
    plan = None if unstaged else (bwd_plan if backward else fwd_plan)(n, rows, c, n_density,
                                                                      sms)
    if plan is None and backward:
        plan = bwd_geometry(n, c, rows, layout.vector, sms)
    return layout, plan


def line_mode_name(line_modes: Sequence[int]) -> str:
    """The counters' name of a call's line modes: ``"hat"`` where every
    axis takes the hat, else ``"linear"`` (an axis or more on the float32
    weights)."""
    return "hat" if all(int(m) == HAT for m in line_modes) else "linear"


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _dims(lines, n_density, line_modes, layout: Layout, plan=None, backward=False):
    """The C entries' dims: {L_0, L_1, L_2, three line modes, C, n_density,
    log2 of the unstaged K17's lanes a sample, vector}, then a staged
    plan's {log2(W / 4), slices, samples a part, density slices (K17) or
    copies (K17b), shared bytes, blocks}, or the unstaged K17b's {run,
    blocks, copies}."""
    modes = [int(m) for m in line_modes]
    if any(m not in (LINEAR, HAT) for m in modes):
        raise ValueError(f"line modes {tuple(line_modes)}: K17 takes LINEAR and HAT")
    group = layout.group if not isinstance(plan, BwdGeometry) else plan.group
    dims = [l.shape[1] for l in lines] + modes + [lines[0].shape[-1], int(n_density),
                                                    group.bit_length() - 1, int(layout.vector)]
    if isinstance(plan, Plan):
        dims += [(plan.width // CHUNK).bit_length() - 1, plan.slices, plan.per_part,
                 plan.copies if backward else plan.density_slices, plan.smem, plan.blocks]
    elif isinstance(plan, BwdGeometry):
        dims += [plan.run, plan.blocks, plan.copies]
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
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]
_FWD_UNSTAGED_ARGS = _FWD_ARGS[:5] + _FWD_ARGS[6:]
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


def cp_fwd(coords: torch.Tensor, lines: Sequence[torch.Tensor], n_density: int,
           line_modes: Sequence[int], unstaged: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
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
    581-608).  Kernel: csrc/cp_lookup.cu, on the staged slices of
    :func:`fwd_plan`; lines past the staging limit (or ``unstaged``) take
    the unstaged form, which reads its rows from L2.  A launch counts in
    ``cp_fwd.launches`` and, staged, in ``cp_fwd.forms[(form,
    mode)].launches``: form ``"eval"`` (bf16 lines), ``"train"`` (float32
    lines with appearance) or ``"density"``, mode :func:`line_mode_name`;
    unstaged in ``cp_fwd.unstaged.launches``.  CPU tensors take
    :func:`cp_fwd_plain`."""
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
        layout, plan = launch_plan(coords, lines, n_density, unstaged=unstaged)
        app_ptr = app.data_ptr() if n_app else 0
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if plan is None:
                err = kernel("cp_lookup", "cp_fwd_unstaged", _FWD_UNSTAGED_ARGS)(
                    coords.data_ptr(), n, _ptrs(lines),
                    _dims(lines, n_density, line_modes, layout), dens.data_ptr(), app_ptr,
                    int(f32), stream)
            else:
                partial = (torch.empty(plan.density_slices, n, dtype=torch.float32, device=dev)
                           if plan.density_slices > 1 else None)
                err = kernel("cp_lookup", "cp_fwd", _FWD_ARGS)(
                    coords.data_ptr(), n, _ptrs(lines),
                    _dims(lines, n_density, line_modes, layout, plan), dens.data_ptr(),
                    0 if partial is None else partial.data_ptr(), app_ptr, int(f32), stream)
        check_launch("cp_fwd", err)
        cp_fwd.launches += 1
        if plan is None:
            cp_fwd.unstaged.launches += 1
        else:
            form = "density" if not n_app else ("train" if f32 else "eval")
            cp_fwd.forms[form, line_mode_name(line_modes)].launches += 1
    return dens, app


def _form_counters(forms) -> dict:
    return {(form, mode): SimpleNamespace(launches=0) for form in forms
            for mode in ("hat", "linear")}


cp_fwd.launches = 0
cp_fwd.forms = _form_counters(("eval", "train", "density"))
cp_fwd.unstaged = SimpleNamespace(launches=0)


def cp_bwd(coords: torch.Tensor, lines: Sequence[torch.Tensor], d_dens: torch.Tensor,
           d_app: torch.Tensor, n_density: int, line_modes: Sequence[int],
           unstaged: bool = False) -> List[torch.Tensor]:
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
    csrc/cp_lookup.cu: walks over the staged slices of :func:`bwd_plan`
    (past the staging limit, or ``unstaged``, the unstaged form of
    :func:`bwd_geometry`) add into copies of the gradient rows, and a
    second pass sums them.  The pair counts as one launch in
    ``cp_bwd.launches`` and, staged, in ``cp_bwd.forms[(form,
    mode)].launches``: form ``"train"`` (with appearance) or ``"density"``,
    mode :func:`line_mode_name`; unstaged in ``cp_bwd.unstaged.launches``.
    CPU tensors take :func:`cp_bwd_plain`."""
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
        layout, plan = launch_plan(coords, lines, n_density, d_app if n_app else None,
                                   backward=True, unstaged=unstaged)
        work = torch.zeros(plan.copies * rows * c, dtype=torch.float32, device=dev)
        staged = isinstance(plan, Plan)
        with torch.cuda.device(dev):
            err = kernel("cp_lookup", "cp_bwd" if staged else "cp_bwd_unstaged", _BWD_ARGS)(
                coords.data_ptr(), n, _ptrs(lines),
                _dims(lines, n_density, line_modes, layout, plan, backward=True),
                d_dens.data_ptr(), d_app.data_ptr() if n_app else 0, work.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check_launch("cp_bwd", err)
        cp_bwd.launches += 1
        if staged:
            cp_bwd.forms["train" if n_app else "density", line_mode_name(line_modes)].launches += 1
        else:
            cp_bwd.unstaged.launches += 1
    return [g.reshape(l.shape) for g, l in zip(out.split([l.shape[1] for l in lines]), lines)]


cp_bwd.launches = 0
cp_bwd.forms = _form_counters(("train", "density"))
cp_bwd.unstaged = SimpleNamespace(launches=0)


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
