"""The learnable far-field environment map (counterpart of
``egonerf_tpu/models/envmap.py``): an equirectangular emission table of
shape (2h, h, 3), channel-last, indexed by (v = phi row, u = cos-theta
column), sampled by view direction through K8 (gradient K8b) and squashed
by a sigmoid into [0, 1]."""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import KERNELS, Ops
from ..ops.envmap import envmap_train


def init_envmap(h: int, generator: Optional[torch.Generator] = None,
                init_strategy: str = "random", device="cpu") -> torch.Tensor:
    """The (2h, h, 3) table: U[0, 1) draws from ``generator`` (on its
    device), as JAX's ``init_envmap`` draws them from its key, or zeros."""
    shape = (2 * h, h, 3)
    if init_strategy == "random":
        if generator is None:
            raise ValueError("a random envmap needs a generator")
        return torch.rand(shape, generator=generator, device=generator.device)
    if init_strategy == "zero":
        return torch.zeros(shape, device=device)
    raise ValueError(f"Unknown environment map initialization: {init_strategy}")


def envmap_radiance(emission: torch.Tensor, direction: torch.Tensor,
                    ops: Ops = KERNELS) -> torch.Tensor:
    """emission (2h, h, 3), direction (N, 3) -> (N, 3) radiance in [0, 1],
    differentiable in ``emission`` (K8 forward, K8b backward)."""
    return envmap_train(emission, direction, ops.envmap, ops.envmap_bwd)
