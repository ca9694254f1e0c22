"""K10, the mixed-precision matrix product: bf16 operands, float32
accumulation, in the forward and both backward contractions
(counterpart of ``egonerf_tpu/ops/mm.py``).

``mixed_matmul(a, b)`` is (..., K) @ (K, N) -> (..., N) with both operands
rounded to bf16 (round to nearest even, as ``astype(bfloat16)``) and the
products summed in float32; its backward rounds the cotangent to bf16 as
well and computes ``da = bf16(dout) @ bf16(b)^T`` and ``db = bf16(a)^T @
bf16(dout)``, both in float32, as JAX's custom VJP does.  A product of two
bf16 values is exact in float32.  The forward sums each output's products
in k order, in the kernel and in its plain version alike, so the two agree
bit for bit: every forward output is rounded to bf16 again as the next
product's operand, where a last-bit difference would land a bf16 ulp apart
(csrc/mixed_mm.cu says why the forward leaves the tensor cores).  The
backward's contractions run on the tensor cores; their plain versions sum
in another order.

EgoNeRF takes it for its shader layers and its basis products under
``EGONERF_MIXED_MM=1`` with ``compute_dtype = "bfloat16"``
(``models/egonerf.py``); the default path is float32 ``torch`` matmuls.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import check_tensor

# shared memory a block may use on the card (every layout sets its dynamic
# limit to what it takes)
_SMEM_LIMIT = 227 * 1024

# the forward's instantiations, by index of the C entry point's `layout`
# (csrc/mixed_mm.cu): narrow (a thread a row and all of 4 or 16 columns,
# read from device memory) and wide ((rows, columns) a block of 128
# threads: a thread 8 x 4 or 16 x 8), a's chunks 32 deep transposed in
# shared memory
FWD_LAYOUTS = ("narrow4", "narrow16", "wide64", "wide128")
_FWD_DEPTH = 32
_WIDE_TILES = {"wide64": (64, 64), "wide128": (128, 128)}
# the reduce layout (db): rows a stage of its ring, the most stages, and
# the K x N outputs one block holds in each of its warp layouts (16 warps:
# 2 along K of 5 x 2 m16n8 tiles each, or 16 along K of 1 x 2 for N <= 16)
DB_ROWS, DB_MAX_STAGES = 32, 4
DB_GROUPS = {"wide": (160, 128), "narrow": (256, 16)}
# the rows layout (da): rows a stage (a row tile), the columns a block
# holds (further column blocks past them), the most stages of its ring and
# the deepest product (b^T's k16 steps held in registers)
DA_TILE, DA_COLS, DA_MAX_STAGES, DA_MAX_DEPTH = 64, 160, 4, 160


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def mixed_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K10's forward: see :func:`mixed_mm`.  The products
    are added in k order from zero, each exact in float32, so every add
    rounds once, as the kernel's fma does."""
    a16, b16 = _bf16(a), _bf16(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    for kk in range(a.shape[1]):
        acc = acc + a16[:, kk:kk + 1] * b16[kk:kk + 1]
    return acc


def mixed_mm_da_plain(dout: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K10's ``da``: see :func:`mixed_mm_da`."""
    return _bf16(dout) @ _bf16(b).t()


def mixed_mm_db_plain(a: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain version of K10's ``db``: see :func:`mixed_mm_db`."""
    return _bf16(a).t() @ _bf16(dout)


def fwd_layout(k: int, n: int) -> str:
    """The forward's instantiation for depth ``k`` and ``n`` output columns:
    the narrow one for n <= 16 (4 or 16 columns a thread), else the wide
    one with 128 columns a block (further column blocks past 128), or 64
    where n <= 64 or b's 128 columns over the depth do not fit."""
    if n <= 16:
        return "narrow4" if n <= 4 else "narrow16"
    if n <= 64 or fwd_smem_bytes(k, "wide128") > _SMEM_LIMIT:
        return "wide64"
    return "wide128"


def fwd_smem_bytes(k: int, layout: str) -> int:
    """Shared memory of one block of the forward's ``layout`` for depth
    ``k``, float32: narrow, b (K x 4 or 16); wide, b's block of columns
    over K rounded up to 4 and a's transposed 32-deep chunk (rows + 4 a
    depth)."""
    if layout.startswith("narrow"):
        return 4 * k * (4 if layout == "narrow4" else 16)
    rows, cols = _WIDE_TILES[layout]
    return 4 * (-(-k // 4) * 4 * cols + _FWD_DEPTH * (rows + 4))


def _pad_8_24(w: int) -> int:
    """The smallest w' >= w of 8 or 24 words mod 32 (w a multiple of 4):
    csrc/mixed_mm.cu pad_8_24, a row stride on which the four rows of a
    half-warp's float2 fragment access fall on distinct banks."""
    r = w % 32
    return w + (8 - r if r <= 8 else 24 - r if r <= 24 else 40 - r)


def da_lda(k: int) -> int:
    """A stage row of the rows layout (da) for depth ``k``, float32: as it
    lies where k % 4 != 0 (the stage is one contiguous range), else padded
    by :func:`_pad_8_24` (copied row by row)."""
    return k if k % 4 else _pad_8_24(k)


def da_ks(k: int) -> int:
    """k16 steps of b^T a warp of the rows layout holds in registers for
    depth ``k`` (the kernel's instantiations: 1, 4, 8, 10)."""
    if not 0 < k <= DA_MAX_DEPTH:
        raise ValueError(f"the rows layout takes depths 1 to {DA_MAX_DEPTH}, got {k}")
    return next(ks for ks in (1, 4, 8, 10) if 16 * ks >= k)


def da_smem_bytes(k: int, n: int, stages: int) -> int:
    """Shared memory of one block of the rows layout for depth ``k``, ``n``
    output columns (the widest column block, DA_COLS at most) and
    ``stages`` stages, float32: the ring of DA_TILE-row stages and two
    staging tiles of the block's columns as they lie in the output."""
    return 4 * (stages * DA_TILE * da_lda(k) + 2 * DA_TILE * min(DA_COLS, n))


def da_stages(k: int, n: int) -> int:
    """The rows layout's ring depth: DA_MAX_STAGES stages where they fit,
    else three (the kernel's instantiations; three fit every depth up to
    DA_MAX_DEPTH); depths past DA_MAX_DEPTH are refused."""
    da_ks(k)
    return DA_MAX_STAGES if da_smem_bytes(k, n, DA_MAX_STAGES) <= _SMEM_LIMIT else 3


def da_tile_range(m: int, width: int, tile: int) -> tuple:
    """(byte offset, bytes in 16-byte pieces, floats moved plainly) of row
    tile ``tile``'s rows of ``width`` floats in an (m, width) row-major
    operand of the rows layout, one contiguous range (:func:`bulk_copy`):
    dout's rows copied into a stage (row by row in width / 4 pieces where
    width % 4 == 0, the same bytes), and da's rows handed to the bulk copy
    (one column block, width <= DA_COLS; wider outputs go row by row)."""
    r0 = tile * DA_TILE
    return (4 * r0 * width, *bulk_copy(min(DA_TILE, m - r0), width))


def _ldm_stride(width: int) -> int:
    """The reduce layout's padded bf16 row (csrc/mixed_mm.cu ldm_stride)."""
    units = -(-width // 8)
    return units * 8 + (8 if units % 2 == 0 else 16)


def db_smem_bytes(k: int, n: int, stages: int) -> int:
    """Shared memory of one block of the reduce layout: a ring of
    ``stages`` stages of DB_ROWS rows of a and of dout (float32) and two
    bf16 tiles of DB_ROWS padded rows of each."""
    return 4 * stages * DB_ROWS * (k + n) + 2 * 2 * DB_ROWS * (_ldm_stride(k) + _ldm_stride(n))


def db_stages(k: int, n: int) -> int:
    """The reduce layout's ring depth: DB_MAX_STAGES stages where they fit,
    fewer for wide operands, never fewer than two (the kernel's
    instantiations: 2, 3, 4)."""
    stages = DB_MAX_STAGES
    while stages >= 2 and db_smem_bytes(k, n, stages) > _SMEM_LIMIT:
        stages -= 1
    if stages < 2:
        raise ValueError(f"K + N = {k} + {n} too large for the reduce layout's shared memory")
    return stages


def db_layout(n: int) -> str:
    """The reduce layout's warps: along K only ("narrow") for N <= 16."""
    return "narrow" if n <= 16 else "wide"


def db_groups(k: int, n: int) -> int:
    """Blocks that share a row range: one a group of outputs of
    :func:`db_layout` (each reads every row of a and dout)."""
    gk, gn = DB_GROUPS[db_layout(n)]
    return -(-k // gk) * -(-n // gn)


def db_row_ranges(m: int, sms: int, groups: int = 1) -> tuple:
    """(rows a block, row ranges) of the reduce layout: about one block an
    SM over all groups, each block over a contiguous range of a multiple of
    DB_ROWS rows (so that every stage starts on a 16-byte boundary)."""
    per_block = -(-m * groups // sms)
    per_block = max(DB_ROWS, -(-per_block // DB_ROWS) * DB_ROWS)
    return per_block, -(-m // per_block)


def bulk_copy(rows: int, width: int) -> tuple:
    """(bytes copied in 16-byte pieces, floats loaded plainly) for a stage
    of ``rows`` rows of ``width`` float32, one contiguous range: the
    largest multiple of 16 bytes and the last (rows * width) % 4 floats (a
    tail of 150-float rows)."""
    return rows * width // 4 * 16, rows * width % 4


def _check_operand(name, t, shape, device=None):
    """A 2-D float32 tensor of ``shape`` (None: any extent) on ``device``;
    strides are free (the kernel reads b at its element strides)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if t.dim() != 2 or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if any(s < 0 for s in t.stride()):
        raise ValueError(f"{name}: negative strides")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")


# the rows layout's C signature (with its stage count); the forward's has
# a layout index in its place
_ROWS_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p]
_FWD_ARGS = _ROWS_ARGS
_DB_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]


def _rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The rows layout on the tensor cores: bf16(a) (M, K) @ bf16(b) (K, N),
    b at its strides (an ``a`` that does not start on a 16-byte boundary is
    copied first: the kernel's stages are 16-byte copies)."""
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    if not (m and n):
        return c
    if k == 0:
        return c.zero_()
    stages = da_stages(k, n)
    a = a if a.data_ptr() % 16 == 0 else a.clone()
    fn = kernel("mixed_mm", "mixed_mm_rows", _ROWS_ARGS)
    dev = a.device
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), m, k, b.data_ptr(), b.stride(0), b.stride(1), n, stages,
                 c.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch("mixed_mm_rows", err)
    return c


def mixed_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10, forward: ``bf16(a) @ bf16(b)`` with float32 accumulation, each
    output's products added in k order (bit for bit with
    :func:`mixed_mm_plain`).

    a (M, K) float32, contiguous; b (K, N) float32 at any strides (a weight
    and its transpose view alike).  Returns (M, N) float32.  Replaces
    ``mixed_matmul``'s forward (egonerf_tpu/ops/mm.py:24-34).  Kernel:
    csrc/mixed_mm.cu (mm_fwd_kernel, or mm_fwd_narrow_kernel for N <= 16:
    :func:`fwd_layout`).  CPU tensors take :func:`mixed_mm_plain`."""
    check_tensor("a", a, torch.float32, (None, None))
    _check_operand("b", b, (a.shape[1], None), a.device)
    if a.device.type == "cpu":
        return mixed_mm_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    layout = fwd_layout(k, n)
    if fwd_smem_bytes(k, layout) > _SMEM_LIMIT:
        raise ValueError(f"depth {k} too large for the forward's shared memory")
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    if m and n:
        fn = kernel("mixed_mm", "mixed_mm_fwd", _FWD_ARGS)
        dev = a.device
        with torch.cuda.device(dev):
            err = fn(a.data_ptr(), m, k, b.data_ptr(), b.stride(0), b.stride(1), n,
                     FWD_LAYOUTS.index(layout), c.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("mixed_mm_fwd", err)
        mixed_mm.launches += 1
    return c


mixed_mm.launches = 0


def mixed_mm_da(dout: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10, the input's gradient: ``bf16(dout) @ bf16(b)^T`` with float32
    accumulation.

    dout (M, N) float32, contiguous, N <= DA_MAX_DEPTH (160); b (K, N) as
    for :func:`mixed_mm`.  Returns (M, K) float32.  Replaces ``_bwd``'s
    ``da`` (egonerf_tpu/ops/mm.py:41-47).  Kernel: csrc/mixed_mm.cu (the
    tensor cores' rows layout, with b^T as its (N, K) operand, held in
    registers; a ring of 64-row stages of dout, :func:`da_stages`).  CPU
    tensors take :func:`mixed_mm_da_plain`."""
    check_tensor("dout", dout, torch.float32, (None, None))
    _check_operand("b", b, (None, dout.shape[1]), dout.device)
    if dout.device.type == "cpu":
        return mixed_mm_da_plain(dout, b)
    da = _rows(dout, b.t())
    if dout.shape[0] and b.shape[0]:
        mixed_mm_da.launches += 1
    return da


mixed_mm_da.launches = 0


def mixed_mm_db(a: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """K10, the weight's gradient: ``bf16(a)^T @ bf16(dout)`` with float32
    accumulation over the M rows.

    a (M, K) and dout (M, N) float32, contiguous (an operand that does not
    start on a 16-byte boundary is copied first: the kernel's bulk copies
    need one).  Returns (K, N) float32.  The rows are split into ranges
    (:func:`db_row_ranges`) that blocks sum into partial (K, N) tiles,
    which a second kernel adds in range order (the same bits every run).
    Replaces ``_bwd``'s ``db`` (egonerf_tpu/ops/mm.py:48-53).  Kernel:
    csrc/mixed_mm.cu (reduce layout).  CPU tensors take
    :func:`mixed_mm_db_plain`."""
    check_tensor("a", a, torch.float32, (None, None))
    check_tensor("dout", dout, torch.float32, (a.shape[0], None), a.device)
    m, k = a.shape
    n = dout.shape[1]
    if a.device.type == "cpu":
        return mixed_mm_db_plain(a, dout)
    stages = db_stages(k, n)
    out = torch.empty(k, n, dtype=torch.float32, device=a.device)
    if not (k and n):
        return out
    if m == 0:
        return out.zero_()
    a, dout = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, dout))
    dev = a.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block, splits = db_row_ranges(m, sms, db_groups(k, n))
    part = torch.empty(splits, k, n, dtype=torch.float32, device=dev)
    fn = kernel("mixed_mm", "mixed_mm_db", _DB_ARGS)
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), dout.data_ptr(), m, k, n, per_block, stages,
                 int(db_layout(n) == "narrow"), part.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch("mixed_mm_db", err)
    mixed_mm_db.launches += 1
    return out


mixed_mm_db.launches = 0


class _MixedMatmul(torch.autograd.Function):
    """``mixed_matmul``'s forward and its custom VJP; ``fwd``, ``da`` and
    ``db`` are the three layouts (an ``Ops`` triple, so the plain versions
    run through the same Function).  a and b are saved in float32, as JAX
    saves them."""

    @staticmethod
    def forward(ctx, a, b, fwd, da, db):
        a2 = a.reshape(-1, a.shape[-1]).contiguous()
        ctx.save_for_backward(a2, b)
        ctx.fns = (da, db)
        ctx.lead = a.shape[:-1]
        return fwd(a2, b).reshape(*a.shape[:-1], b.shape[1])

    @staticmethod
    def backward(ctx, dout):
        a2, b = ctx.saved_tensors
        da_fn, db_fn = ctx.fns
        d2 = dout.reshape(-1, dout.shape[-1]).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = da_fn(d2, b).reshape(*ctx.lead, b.shape[0])
        if ctx.needs_input_grad[1]:
            db = db_fn(a2, d2)
        return da, db, None, None, None


def mixed_matmul(a: torch.Tensor, b: torch.Tensor, fwd=mixed_mm, da=mixed_mm_da,
                 db=mixed_mm_db) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) float32, computed at bf16 x bf16 ->
    float32 (JAX ``mixed_matmul``), differentiable in both operands through
    ``da`` and ``db``."""
    return _MixedMatmul.apply(a, b, fwd, da, db)
