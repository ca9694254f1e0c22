"""Profiler family: K6, the composite (composite_kernel<G, false, ...>).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K6 composite'
PATTERN = '(?<![A-Za-z_])composite_kernel'
ORDER = 60
KERNEL = True


def cost(s: Shapes):
    """Density features, dists, depths and colours (24 bytes a sample)
    and a ray's z direction read once, six floats a ray written; 20
    operations a sample."""
    r, n = s.rays, s.samples
    return n * 24 + r * 4 + r * 6 * 4, n * 20
