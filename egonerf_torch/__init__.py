"""PyTorch + CUDA port of EgoNeRF for NVIDIA Hopper (sm_90a).

The package mirrors ``egonerf_tpu``'s layout (``coords/``, ``ops/``,
``models/``, ``render/``, ``data/``) and names, so every function has a
counterpart a reader can find.  It imports neither JAX nor ``egonerf_tpu``.

It covers the render path (``Renderer.render_view`` over
``EgoNeRF.forward`` at eval) and training (``train.trainer.Trainer``, the
command line ``python -m egonerf_torch``).  Seven hand-written CUDA kernels
carry them (``csrc/``): the fine-field lookup (K1) and its backward (K2),
the coarse density lookup (K3), the fused coarse weights + inverse-CDF
resampling + merge with the fine chart in its epilogue (K4), the sorted
uniform draws (K5), and the composite (K6) and its backward (K6b).  Each
has a plain PyTorch version beside its wrapper; the wrapper takes it only
for tensors on the CPU.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
