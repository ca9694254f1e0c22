"""Merge of per-ray sorted depth arrays (counterpart of
``egonerf_tpu/ops/merge.py::merge_sorted``).

JAX merges with a bitonic network because a full sort is costly on the TPU;
its result is bit-identical to sorting the concatenation, which is the
plain version here.  The kernel path merges inside K4 (``ops/pdf.py``).
``sorted_uniform`` (K5) comes with the training slice.
"""
from __future__ import annotations

import torch


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) and (..., m), each sorted ascending -> (..., n+m) sorted."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
