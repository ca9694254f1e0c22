"""Profiler family: K7, the coarse chart.

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K7 chart'
PATTERN = '(?<![A-Za-z_])chart_kernel'
ORDER = 70
KERNEL = True


def cost(s: Shapes):
    """The rays, the coarse depths and the radial grid read once, the
    coords written; about 170 operations a sample (two acos, two atan2, the
    root, the search and the normalisation)."""
    r, n = s.rays, s.coarse_samples
    return r * 24 + n * 4 + s.n_grid * 4 + n * 16, n * 170
