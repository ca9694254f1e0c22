"""Profiler family: The library's matrix products: the shader's layers and the basis (cuBLAS, CUTLASS).

A device operation whose name matches PATTERN, and no family of lower
ORDER, belongs here."""
LABEL = 'shader GEMMs'
PATTERN = 'gemm|gemv|nvjet|xmma|cutlass|cublas|splitK'
ORDER = 500
KERNEL = False
