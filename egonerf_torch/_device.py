"""Device resolution and the argument checks shared by the kernel wrappers.

Entry points default to ``device="cuda"``.  Without a card that default
raises: the port never carries on quietly on the host.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (pass ``device="cpu"`` to run the plain versions on the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "egonerf_torch runs on a CUDA device by default and torch sees "
            "none; pass device='cpu' to run the plain PyTorch versions on "
            "the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def full_f32_matmul() -> None:
    """Matmuls and convolutions in full float32 on the card, as the JAX
    reference computes them on the CPU (TF32 keeps ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_tensor(name: str, t, dtype: torch.dtype, shape: Sequence[Optional[int]],
                 device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` whose shape
    matches ``shape`` (None matches any extent), on ``device`` if given."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def check_rows(name: str, t, n_rows: int, n_cols: int, device: torch.device) -> None:
    """Raise unless ``t`` is an (n_rows, n_cols) float32 tensor on ``device``
    with unit column stride; the row stride is free (a column slice of the
    (R, 6) rays, or 0 for one row broadcast to all)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != (n_rows, n_cols):
        raise ValueError(f"{name}: expected shape {(n_rows, n_cols)}, got {tuple(t.shape)}")
    if n_cols > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: expected unit column stride")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
