"""Profiler family: K1, the fine field's lookup (csrc/vm_lookup.cu, vm_lookup_kernel<true, ...>).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K1 field'
PATTERN = '(?<![A-Za-z_])vm_lookup_kernel(?:<true|ILb1E)'
ORDER = 10
KERNEL = True


def cost(s: Shapes):
    """The fine samples' coords and the fused bfloat16 tables read once,
    the density and appearance written (and the relu mask in training);
    11 operations a sample and channel."""
    n = s.samples
    n_bytes = n * 16 + 2 * s.fine_table_elems() + n * (1 + sum(s.n_app)) * 4
    if s.train:
        n_bytes += n
    return n_bytes, n * s.channels * 11
