"""Profiler family: K3, the coarse density's lookup (vm_lookup_kernel<false, ...>).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
from benchlib.costs import Shapes

LABEL = 'K3 density'
PATTERN = '(?<![A-Za-z_])vm_lookup_kernel(?:<false|ILb0E)'
ORDER = 20
KERNEL = True


def cost(s: Shapes):
    """The coarse samples' coords and the half-resolution bfloat16 density
    tables read once, the density written; 11 operations a sample and
    channel."""
    n = s.coarse_samples
    return n * 16 + 2 * s.coarse_table_elems() + n * 4, n * sum(s.n_sigma) * 11
