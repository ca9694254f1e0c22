"""K11, the bias gradient of a shader layer, and the bias add whose
backward it is (counterpart of ``_bias_add`` in
``egonerf_tpu/models/shading.py``).

Under ``EGONERF_BIAS_DOT=1`` every shader layer adds its bias through
:func:`bias_add`: the forward is the plain ``x + b``, the backward passes
``dout`` to x and gives b the column sum of ``dout`` over all rows in
float32 (JAX contracts ``ones @ dout`` with float32 accumulation).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel
from .._device import check_tensor

# the partial kernel's lanes, one float32 each, in shared memory
_SMEM_LIMIT = 48 * 1024


def bias_grad_plain(dout: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: see :func:`bias_grad`."""
    return dout.sum(0)


_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _lanes(c: int, vec: bool) -> int:
    """The partial kernel's lanes of shared memory (csrc/bias_grad.cu)."""
    if vec:
        return 256 // (c // 4) * c
    return 256 // c * c if c <= 256 else c


def bias_grad(dout: torch.Tensor) -> torch.Tensor:
    """K11: ``db = sum over rows of dout``, float32.

    dout (M, C) float32, contiguous.  Returns (C,) float32.  Blocks sum
    contiguous ranges of rows into partial rows, which a second kernel adds
    in range order (the same bits every run).  Replaces ``_bias_add_bwd``'s
    db (egonerf_tpu/models/shading.py:71-77).  Kernel: csrc/bias_grad.cu.
    CPU tensors take :func:`bias_grad_plain`."""
    check_tensor("dout", dout, torch.float32, (None, None))
    m, c = dout.shape
    if dout.device.type == "cpu":
        return bias_grad_plain(dout)
    dev = dout.device
    out = torch.empty(c, dtype=torch.float32, device=dev)
    if c == 0:
        return out
    # 16-byte lanes where the rows allow them
    vec = c % 4 == 0 and c <= 1024 and dout.data_ptr() % 16 == 0
    if 4 * _lanes(c, vec) > _SMEM_LIMIT:
        raise ValueError(f"{c} columns exceed the kernel's shared memory")
    if m == 0:
        return out.zero_()
    # about four blocks an SM, each over a contiguous range of rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block = max(64, -(-m // (4 * sms)))
    part = torch.empty(-(-m // per_block), c, dtype=torch.float32, device=dev)
    fn = kernel("bias_grad", "bias_grad", _ARGS)
    with torch.cuda.device(dev):
        err = fn(dout.data_ptr(), m, c, per_block, int(vec), part.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch("bias_grad", err)
    bias_grad.launches += 1
    return out


bias_grad.launches = 0


class _BiasAdd(torch.autograd.Function):
    """x + b, with b's gradient from ``grad`` (K11 or its plain version)."""

    @staticmethod
    def forward(ctx, x, b, grad):
        ctx.grad = grad
        return x + b

    @staticmethod
    def backward(ctx, dout):
        db = None
        if ctx.needs_input_grad[1]:
            db = ctx.grad(dout.reshape(-1, dout.shape[-1]).contiguous())
        return dout, db, None


def bias_add(x: torch.Tensor, b: torch.Tensor, grad=bias_grad) -> torch.Tensor:
    """``x + b`` over the last axis, its bias gradient through ``grad``
    (JAX ``_bias_add``)."""
    return _BiasAdd.apply(x, b, grad)
