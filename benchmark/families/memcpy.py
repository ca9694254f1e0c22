"""Profiler family: Copies between host and device and within the device.

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
LABEL = 'memcpy'
PATTERN = '^Memcpy'
ORDER = 540
KERNEL = False
