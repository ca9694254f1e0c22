"""Philox4x32-10 (Salmon et al., SC'11) in int64 torch arithmetic, as
``csrc/philox.cuh`` runs it on the card: the generator of K5's sorted
draws (``ops/merge.py``, and the training instantiations of K4 and K4c,
which draw in the kernel) and of the theta sampler's batches
(``ops/sampler.py``).  Each stream is a counter word of its own, so the
two never share a block under the same key.
"""
from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
SORTED_STREAM = 0x4B35  # counter word 3 of K5's draws
THETA_STREAM = 0x7E7A  # counter word 3 of the theta sampler's draws


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64 x
    holding 32-bit values, without leaving int64: m splits into 16-bit
    halves so that every partial product stays below 2**49."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Four int64 tensors of 32-bit counter words -> the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & MASK
        k1 = (k1 + _W1) & MASK
    return c0, c1, c2, c3
