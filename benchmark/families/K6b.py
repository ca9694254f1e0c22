"""Profiler family: K6b, the composite's backward.

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K6b composite backward'
PATTERN = '(?<![A-Za-z_])composite_bwd_kernel'
ORDER = 61
KERNEL = True


def cost(s: Shapes):
    """Features, dists, colours and the rgb cotangent read once, the
    feature and colour cotangents written (36 bytes a sample; with the
    envmap its radiance read too); 60 operations a sample."""
    r, n = s.rays, s.samples
    return n * 36 + r * 12 + (r * 12 if s.envmap_h else 0), n * 60
