"""Profiler family: Fills and memsets (gradients zeroed, scatter targets).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
LABEL = 'zero fills'
PATTERN = 'FillFunctor|^Memset'
ORDER = 530
KERNEL = False
