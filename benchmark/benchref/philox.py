"""Philox4x32-10 (Salmon et al., SC'11) in int64 torch arithmetic, and the
sorted uniforms of a training step drawn from it: per ray, n + 1 Exp(1)
draws, their cumulative sum c, and c[:-1] / c[-1].  Draw j of ray r is
word j % 4 of the block at counter (j // 4, r, r >> 32, 0x4B35) under key
(seed, step), mapped to -log((bits + 0.5) * 2**-32) in float64."""
from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
SORTED_STREAM = 0x4B35


def _mulhilo(m: int, x: torch.Tensor):
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & MASK
        k1 = (k1 + _W1) & MASK
    return c0, c1, c2, c3


def sorted_uniform(n_rays: int, n: int, seed: int, step: int, device) -> torch.Tensor:
    """(n_rays, n) sorted uniforms of training step ``step``."""
    m = n + 1
    g = -(-m // 4)
    ray = torch.arange(n_rays, dtype=torch.int64, device=device)[:, None]
    c0 = torch.arange(g, dtype=torch.int64, device=device)[None, :].expand(n_rays, g)
    c1 = (ray & MASK).expand(n_rays, g)
    c2 = (ray >> 32).expand(n_rays, g)
    c3 = torch.full_like(c0, SORTED_STREAM)
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, seed & MASK, step & MASK), dim=-1)
    bits = words.reshape(n_rays, 4 * g)[:, :m]
    e = (-torch.log((bits.to(torch.float64) + 0.5) * 2.0 ** -32)).to(torch.float32)
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]
