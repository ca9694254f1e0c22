"""Frequency positional encoding (counterpart of ``egonerf_tpu/ops/pe.py``).

For input dim d and frequency f the flat index is d*F + f; the sin block
comes first, then the cos block.
"""
from __future__ import annotations

import torch


def positional_encoding(positions: torch.Tensor, freqs: int) -> torch.Tensor:
    """positions: (..., D) -> (..., 2*D*freqs)."""
    bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype, device=positions.device)
    pts = (positions[..., None] * bands).reshape(*positions.shape[:-1], -1)
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)
