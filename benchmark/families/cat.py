"""Profiler family: torch.cat's copies (the shader's input, the fused tables).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
LABEL = 'cat copies'
PATTERN = 'CatArray'
ORDER = 510
KERNEL = False
