"""Alpha masks: baked binary occupancy volumes sampled trilinearly to gate
samples (counterpart of ``egonerf_tpu/models/alphamask.py``:
``AlphaGridMask``, ``YinYangAlphaGridMask``, ``bake_alpha_mask``).

A mask keeps its volume on the model's device as (S, D, H, W) uint8, one
byte per cell, laid out (z, y, x) against coords (x, y, z); K9
(``ops.alphamask.alpha_fwd``) samples it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.alphamask import alpha_fwd


def _as_volume(vol) -> torch.Tensor:
    t = vol if isinstance(vol, torch.Tensor) else torch.from_numpy(np.asarray(vol))
    return t > 0


class AlphaGridMask:
    """One occupancy volume (D, H, W) in normalized [-1, 1]^3 coords."""

    def __init__(self, alpha_volume, device="cpu"):
        vol = _as_volume(alpha_volume)
        self.grid_size = tuple(int(v) for v in vol.shape[-3:])
        self.vol = vol.reshape(1, *self.grid_size).to(device=device, dtype=torch.uint8)

    @property
    def volume(self) -> np.ndarray:
        """(S, D, H, W, 1) float32, as JAX's ``volume`` gives it to its
        checkpoints and tests."""
        return self.vol.cpu().numpy().astype(np.float32)[..., None]

    def sample_alpha(self, norm_coords: torch.Tensor, lookup=alpha_fwd) -> torch.Tensor:
        """norm_coords (..., 3) in grid_sample (x, y, z) order, or (..., 4)
        with a chart flag that a single volume ignores -> (...)."""
        lead = norm_coords.shape[:-1]
        flat = norm_coords.reshape(-1, norm_coords.shape[-1]).contiguous()
        return lookup(flat, self.vol).reshape(lead)


class YinYangAlphaGridMask(AlphaGridMask):
    """Occupancy volumes of both yin-yang grids, stacked (2, D, H, W); the
    chart flag of (..., 4) coords selects one."""

    def __init__(self, alpha_volume_yin, alpha_volume_yang, device="cpu"):
        yin, yang = _as_volume(alpha_volume_yin), _as_volume(alpha_volume_yang)
        if yin.shape != yang.shape:
            raise ValueError(f"yin {tuple(yin.shape)} and yang {tuple(yang.shape)} differ")
        self.grid_size = tuple(int(v) for v in yin.shape[-3:])
        self.vol = torch.stack([yin.reshape(self.grid_size),
                                yang.reshape(self.grid_size)]).to(device=device,
                                                                  dtype=torch.uint8)


def mask_from_volumes(vols, device) -> AlphaGridMask:
    """A checkpoint's volumes as a mask, by JAX's rule (``trainer.py:
    837-849``): two volumes make a yin-yang mask, one a plain mask."""
    if len(vols) == 2:
        return YinYangAlphaGridMask(vols[0], vols[1], device=device)
    return AlphaGridMask(vols[0], device=device)


def bake_alpha_mask(alpha_grid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense alpha (Dx, Dy, Dz) -> the binary volume (Dz, Dy, Dx) uint8:
    clipped to [0, 1], laid out (z, y, x) to match grid_sample's (x, y, z)
    coords, dilated by a same-padded 3^3 max pool, thresholded at
    ``threshold`` (JAX ``models/alphamask.py:123-138``; ``F.max_pool3d``
    pads with -inf as JAX's ``reduce_window`` does)."""
    vol = alpha_grid.clamp(0.0, 1.0).permute(2, 1, 0)
    vol = F.max_pool3d(vol[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    return (vol >= threshold).to(torch.uint8)


# points a slab of the bake computes at once (2M: one slab at 128^3)
_SLAB = 1 << 21


def dense_alpha(alpha_of, grid_size, device, n_grids: int = 1):
    """Alpha over the dense normalized grid of ``grid_size`` (Dx, Dy, Dz),
    the points (x_i, y_j, z_k) of ``linspace(-1, 1, D)`` per axis as JAX's
    ``get_dense_alpha`` lays them (``meshgrid(indexing="ij")``; torch's
    linspace and XLA's differ in the last bit of some points).
    ``alpha_of`` maps (M, 4) coords [x, y, z, flag] to (M,) alpha; one
    (Dx, Dy, Dz) volume per chart flag 0 .. n_grids - 1, computed in slabs
    of whole x-planes of at most ``_SLAB`` points (one at least)."""
    gx, gy, gz = (int(g) for g in grid_size)
    ax = [torch.linspace(-1.0, 1.0, g, device=device) for g in (gx, gy, gz)]
    yz = torch.stack(torch.meshgrid(ax[1], ax[2], indexing="ij"), dim=-1).reshape(-1, 2)
    rows = max(1, _SLAB // (gy * gz))
    out = []
    for flag in range(n_grids):
        vol = torch.empty(gx, gy * gz, dtype=torch.float32, device=device)
        for i0 in range(0, gx, rows):
            xs = ax[0][i0:i0 + rows]
            pts = torch.cat([xs[:, None, None].expand(-1, gy * gz, 1),
                             yz[None].expand(xs.shape[0], -1, -1),
                             torch.full((xs.shape[0], gy * gz, 1), float(flag), device=device)],
                            dim=-1)
            vol[i0:i0 + rows] = alpha_of(pts.reshape(-1, 4)).reshape(xs.shape[0], -1)
        out.append(vol.reshape(gx, gy, gz))
    return out
