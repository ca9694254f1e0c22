"""Profiler family: torch's elementwise kernels and reductions (activations, PE, casts, the losses).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
LABEL = 'elementwise and reductions'
PATTERN = 'elementwise|reduce_kernel|Reduce'
ORDER = 550
KERNEL = False
