"""Profiler family: K6e, the composite with the envmap's lookup inside (composite_kernel<G, true, ...>).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K6e composite with envmap'
PATTERN = '(?<![A-Za-z_])composite_kernel(?:<(?:true|false), true|ILb[01]ELb1E)'
ORDER = 59
KERNEL = True


def cost(s: Shapes):
    """K6's bytes, with the directions read and the environment's
    radiance written (the texels it reads are not counted); K6's 20
    operations a sample and 134 a ray for the lookup."""
    r, n = s.rays, s.samples
    return n * 24 + r * 4 + r * 9 * 4 + r * 12 + r * 12, n * 20 + r * 134
