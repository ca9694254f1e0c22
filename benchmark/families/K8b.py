"""Profiler family: K8b, the envmap's backward.

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K8b envmap backward'
PATTERN = '(?<![A-Za-z_])envmap_bwd_kernel'
ORDER = 81
KERNEL = True


def cost(s: Shapes):
    """Directions, radiance and its cotangent read once, the whole table's
    gradient written; 110 operations a ray."""
    r, h = s.rays, s.envmap_h
    return 3 * r * 12 + 2 * h * h * 12, r * 110
