"""Adam with per-group learning rates and per-step exponential decay
(counterpart of ``egonerf_tpu/train/optim.py``).

The JAX package chains ``optax.scale_by_adam(0.9, 0.99)``, a per-leaf lr
(grid: ``lr_init``; network, the basis and the shader: ``lr_basis``;
envmap: ``lr_envmap``) and ``-(factor ** count)`` with factor =
``lr_decay_target_ratio ** (1 / lr_decay_iters)`` and count the number of
updates made, 0 on the first.  ``torch.optim.Adam`` computes the same
update; the group lrs are set as Python floats before each step.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

NETWORK_KEYS = ("basis", "shader")


def lr_group_of(name: str) -> str:
    """envmap / network (basis matrices + shader MLP) / grid for a
    ``state_dict`` name; everything not matched is a grid tensor."""
    top = name.split(".")[0]
    if top == "envmap":
        return "envmap"
    if any(k in top for k in NETWORK_KEYS):
        return "network"
    return "grid"


class Optimizer:
    """Adam(betas=(0.9, 0.99), eps=1e-8) over the three lr groups, each
    step at lr_group * factor ** count."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], lr_grid: float,
                 lr_network: float, lr_envmap: float = 0.0,
                 decay_target_ratio: float = 0.1, decay_iters: Optional[int] = None):
        self.base_lr = {"grid": lr_grid, "network": lr_network, "envmap": lr_envmap}
        groups: dict = {}
        for name, p in params.items():
            groups.setdefault(lr_group_of(name), []).append(p)
        self.adam = torch.optim.Adam(
            [{"params": ps, "lr": self.base_lr[g], "group": g} for g, ps in groups.items()],
            betas=(0.9, 0.99), eps=1e-8)
        self.factor = (decay_target_ratio ** (1.0 / decay_iters)
                       if decay_iters and decay_iters > 0 and decay_target_ratio < 1.0
                       else 1.0)
        self.count = 0

    def fast_forward(self, step: int) -> None:
        """Resume: continue the decay from ``step`` (Adam's moments start
        afresh, as JAX's, which checkpoints do not store)."""
        self.count = int(step)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        scale = self.factor ** self.count
        for group in self.adam.param_groups:
            group["lr"] = self.base_lr[group["group"]] * scale
        self.adam.step()
        self.count += 1
