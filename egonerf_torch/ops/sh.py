"""Real spherical-harmonics bases of degrees 0-4 (counterpart of
``egonerf_tpu/ops/sh.py``): the standard polynomials, in JAX's order and
float32 arithmetic.  No hand op in JAX; plain torch here."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh_bases(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """The bases at directions ``dirs`` (..., 3): (..., (deg + 1) ** 2)."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} outside 0-4")
    out = [torch.full(dirs.shape[:-1], C0, dtype=dirs.dtype, device=dirs.device)]
    if deg > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                    C2[3] * xz, C2[4] * (xx - yy)]
            if deg > 2:
                out += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                        C3[2] * y * (4 * zz - xx - yy),
                        C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                        C3[4] * x * (4 * zz - xx - yy),
                        C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
                if deg > 3:
                    out += [C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy),
                            C4[2] * xy * (7 * zz - 1), C4[3] * yz * (7 * zz - 3),
                            C4[4] * (zz * (35 * zz - 30) + 3),
                            C4[5] * xz * (7 * zz - 3),
                            C4[6] * (xx - yy) * (7 * zz - 1),
                            C4[7] * xz * (xx - 3 * yy),
                            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Contract coefficients ``sh`` (..., C, (deg + 1) ** 2) with the bases
    at ``dirs`` (..., 3): (..., C)."""
    return torch.sum(sh * eval_sh_bases(deg, dirs)[..., None, :], dim=-1)
