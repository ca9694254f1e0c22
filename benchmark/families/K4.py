"""Profiler family: K4, the resampling with the fine chart in its epilogue (training: K5's draw in its prologue).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
import math

from benchlib.costs import Shapes

LABEL = 'K4 resample'
PATTERN = '(?<![A-Za-z_])resample_kernel'
ORDER = 40
KERNEL = True


def cost(s: Shapes):
    """The coarse features, depths and dists read once, the merged depths
    and dists written, the rays and the radial grid read and the fine
    coords written by the chart epilogue; a ray's weights and pdf (12 a
    coarse sample), a draw's search and bracket, the merge and the dists (2
    a merged sample) and the chart (170 a merged sample)."""
    r, sc, nf = s.rays, s.n_coarse, s.n_fine
    n_out = sc + nf
    n_bytes = (3 * r * sc * 4 + 2 * r * n_out * 4 + r * 24 + s.n_grid * 4
               + r * n_out * 16)
    n_ops = r * (12 * sc + nf * (int(math.log2(sc)) + 8) + 2 * n_out) + r * n_out * 170
    return n_bytes, n_ops
