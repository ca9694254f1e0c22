"""Profiler family: K2, the fine field's backward.

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K2 field backward'
PATTERN = '(?<![A-Za-z_])vm_field_bwd_kernel'
ORDER = 30
KERNEL = True


def cost(s: Shapes):
    """The coords, the bfloat16 tables, the density and appearance
    cotangents and the relu mask read once, the float32 gradient tables
    written whole; 18 operations a sample and channel (the plane and line
    recomputed, both products, six weighted contributions)."""
    n = s.samples
    n_bytes = (n * 16 + 2 * s.fine_table_elems() + n * 4 + n * sum(s.n_app) * 4 + n
               + 4 * s.fine_table_elems())
    return n_bytes, n * s.channels * 18
