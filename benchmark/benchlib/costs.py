"""The yardstick's arithmetic: the card's published peaks, a kernel's
bound from its bytes and operations, and the model's floating-point
operations counted from the configuration's widths.

Peaks: NVIDIA H100 SXM data sheet (dense, no sparsity): HBM3 at 3.35 TB/s
and 67 TFLOP/s in float32 outside the tensor cores, the rate of the
configs' float32 products with TF32 off.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the float32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOP_PER_S)


@dataclass
class Shapes:
    """The shapes one training step or one render chunk works on."""
    rays: int              # rays a step or a chunk
    n_coarse: int
    n_fine: int
    grid: tuple            # (n_r, n_theta, n_phi)
    n_sigma: tuple         # density channels a decomposition
    n_app: tuple           # appearance channels a decomposition
    app_dim: int
    n_shader_in: int
    feature_c: int
    envmap_h: int          # 0 without the envmap
    train: bool

    @property
    def samples(self) -> int:
        """Fine samples (the coarse depths merged with the drawn ones)."""
        return self.rays * (self.n_coarse + self.n_fine)

    @property
    def coarse_samples(self) -> int:
        return self.rays * self.n_coarse

    @property
    def n_grid(self) -> int:
        """Entries of the radial lookup grid."""
        return self.grid[0] + 1

    @property
    def channels(self) -> int:
        """Fused channels over the three decompositions."""
        return sum(self.n_sigma) + sum(self.n_app)

    def _table_elems(self, a, b, div) -> int:
        """Elements of both charts' planes and lines with ``a`` + ``b``
        channels a decomposition, each axis cut by ``div``."""
        g = self.grid
        planes = ((g[1] // div) * (g[0] // div) * (a[0] + b[0])
                  + (g[2] // div) * (g[0] // div) * (a[1] + b[1])
                  + (g[2] // div) * (g[1] // div) * (a[2] + b[2]))
        lines = (g[2] // div) * (a[0] + b[0]) + (g[1] // div) * (a[1] + b[1]) \
            + (g[0] // div) * (a[2] + b[2])
        return 2 * (planes + lines)

    def fine_table_elems(self) -> int:
        return self._table_elems(self.n_sigma, self.n_app, 1)

    def coarse_table_elems(self) -> int:
        return self._table_elems(self.n_sigma, (0, 0, 0), 2)


# ---------------------------------------------------------------------------
# the model's floating-point operations
# ---------------------------------------------------------------------------
def shader_flop_per_sample(s: Shapes) -> int:
    """One sample's shader and basis products, forward: l1 (n_in ->
    feature_c), l2, l3 (-> 3) and one chart's basis (appearance channels ->
    app_dim), two operations a multiply-add.  At the configs' widths
    2 x (150 x 128 + 128 x 128 + 128 x 3 + 144 x 27) = 79,712."""
    return 2 * (s.n_shader_in * s.feature_c + s.feature_c * s.feature_c + s.feature_c * 3
                + sum(s.n_app) * s.app_dim)


def gemm_flop(s: Shapes) -> float:
    """A step's (forward and both backward contractions: three times the
    forward) or a chunk's (forward) shader and basis operations."""
    return shader_flop_per_sample(s) * s.samples * (3 if s.train else 1)


def lookup_flop_per_sample(channels: int, density_channels: int) -> int:
    """One sample's VM lookup interpolation over ``channels`` fused channels
    of the three decompositions: the bilinear plane sample (a multiply-add
    a corner: 8 a channel), the linear line sample (4), the plane-line
    product (1), and the sum of the density channels; the corner weights,
    a sample's and not a channel's, are left out."""
    return 13 * channels + density_channels


def model_flop(s: Shapes) -> float:
    """A step's or a chunk's model operations: the shader and basis
    products, the fine lookups, and the coarse density lookups; training
    counts the fine lookups' backward as twice their forward."""
    fine = lookup_flop_per_sample(s.channels, sum(s.n_sigma)) * s.samples
    coarse = lookup_flop_per_sample(sum(s.n_sigma), sum(s.n_sigma)) * s.coarse_samples
    return gemm_flop(s) + fine * (3 if s.train else 1) + coarse
