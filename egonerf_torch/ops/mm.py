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

# shared memory a block may use on the card, and the reduce layout's static
# limit (csrc/mixed_mm.cu)
_SMEM_LIMIT = 227 * 1024
_DB_SMEM_LIMIT = 48 * 1024


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


def fwd_smem_bytes(k: int, n: int) -> int:
    """Shared memory of one block of the forward for depth ``k`` and ``n``
    output columns: b's block of 16 TN columns (TN = 1, 4 or 8) over the
    depth padded to 32, and a 32 x 132 chunk of a, float32."""
    tn = 1 if n <= 16 else 4 if n <= 64 else 8
    return 4 * (-(-k // 32) * 32 * 16 * tn + 32 * (16 * 8 + 4))


def rows_smem_bytes(k: int, n: int) -> int:
    """Shared memory of one block of the rows layout (da) for depth ``k``
    and ``n`` output columns: b^T's block of 8 NT columns (NT = 20 for
    129 to 160 columns, else 16) over the depth padded to 32 (+ 8), and a
    128 x 40 chunk of a, bf16."""
    nt = 20 if 128 < n <= 160 else 16
    kpad = -(-k // 32) * 32
    return 2 * (8 * nt * (kpad + 8) + 128 * 40)


def _ldm_stride(width: int) -> int:
    """The reduce layout's padded shared row (csrc/mixed_mm.cu ldm_stride)."""
    units = -(-width // 8)
    return units * 8 + (8 if units % 2 == 0 else 16)


def db_smem_bytes(k: int, n: int) -> int:
    """Shared memory of one block of the reduce layout: 32 rows of a and of
    dout in bf16."""
    return 2 * 32 * (_ldm_stride(k) + _ldm_stride(n))


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


# the forward's and the rows layout's C signature
_ROWS_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p]
_DB_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The rows layout on the tensor cores: bf16(a) (M, K) @ bf16(b) (K, N),
    b at its strides."""
    m, k = a.shape
    n = b.shape[1]
    if rows_smem_bytes(k, n) > _SMEM_LIMIT:
        raise ValueError(f"depth {k} too large for the rows layout's shared memory")
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    if m and n:
        fn = kernel("mixed_mm", "mixed_mm_rows", _ROWS_ARGS)
        dev = a.device
        with torch.cuda.device(dev):
            err = fn(a.data_ptr(), m, k, b.data_ptr(), b.stride(0), b.stride(1), n, c.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("mixed_mm_rows", err)
    return c


def mixed_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10, forward: ``bf16(a) @ bf16(b)`` with float32 accumulation, each
    output's products added in k order (bit for bit with
    :func:`mixed_mm_plain`).

    a (M, K) float32, contiguous; b (K, N) float32 at any strides (a weight
    and its transpose view alike).  Returns (M, N) float32.  Replaces
    ``mixed_matmul``'s forward (egonerf_tpu/ops/mm.py:24-34).  Kernel:
    csrc/mixed_mm.cu (mm_fwd_kernel).  CPU tensors take
    :func:`mixed_mm_plain`."""
    check_tensor("a", a, torch.float32, (None, None))
    _check_operand("b", b, (a.shape[1], None), a.device)
    if a.device.type == "cpu":
        return mixed_mm_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    if fwd_smem_bytes(k, n) > _SMEM_LIMIT:
        raise ValueError(f"depth {k} too large for the forward's shared memory")
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    if m and n:
        fn = kernel("mixed_mm", "mixed_mm_fwd", _ROWS_ARGS)
        dev = a.device
        with torch.cuda.device(dev):
            err = fn(a.data_ptr(), m, k, b.data_ptr(), b.stride(0), b.stride(1), n, c.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        check_launch("mixed_mm_fwd", err)
        mixed_mm.launches += 1
    return c


mixed_mm.launches = 0


def mixed_mm_da(dout: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10, the input's gradient: ``bf16(dout) @ bf16(b)^T`` with float32
    accumulation.

    dout (M, N) float32, contiguous; b (K, N) as for :func:`mixed_mm`.
    Returns (M, K) float32.  Replaces ``_bwd``'s ``da`` (egonerf_tpu/ops/
    mm.py:41-47).  Kernel: csrc/mixed_mm.cu (the tensor cores' rows layout,
    with b^T as its (N, K) operand).  CPU tensors take
    :func:`mixed_mm_da_plain`."""
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

    a (M, K) and dout (M, N) float32, contiguous.  Returns (K, N) float32.
    The rows are split into ranges that blocks sum into partial (K, N)
    tiles, which a second kernel adds in range order (the same bits every
    run).  Replaces ``_bwd``'s ``db`` (egonerf_tpu/ops/mm.py:48-53).
    Kernel: csrc/mixed_mm.cu (reduce layout).  CPU tensors take
    :func:`mixed_mm_db_plain`."""
    check_tensor("a", a, torch.float32, (None, None))
    check_tensor("dout", dout, torch.float32, (a.shape[0], None), a.device)
    m, k = a.shape
    n = dout.shape[1]
    if a.device.type == "cpu":
        return mixed_mm_db_plain(a, dout)
    if db_smem_bytes(k, n) > _DB_SMEM_LIMIT:
        raise ValueError(f"K + N = {k} + {n} too large for the reduce layout's shared memory")
    out = torch.empty(k, n, dtype=torch.float32, device=a.device)
    if not (k and n):
        return out
    if m == 0:
        return out.zero_()
    dev = a.device
    # about two blocks an SM, each over a contiguous range of rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block = max(32, -(-m // (2 * sms)))
    splits = -(-m // per_block)
    part = torch.empty(splits, k, n, dtype=torch.float32, device=dev)
    fn = kernel("mixed_mm", "mixed_mm_db", _DB_ARGS)
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), dout.data_ptr(), m, k, n, per_block, part.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
