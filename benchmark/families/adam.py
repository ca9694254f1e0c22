"""Profiler family: The optimizer's foreach kernels.

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
LABEL = 'Adam (multi_tensor_apply)'
PATTERN = 'multi_tensor_apply'
ORDER = 520
KERNEL = False
