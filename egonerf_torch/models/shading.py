"""MLP_Fea shading (counterpart of ``egonerf_tpu/models/shading.py``, the
default concat path).  The other shading modes and the default-off
toggles of the JAX module wait (ROADMAP.md §1)."""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pe import positional_encoding


class MLPFea(nn.Module):
    """sigmoid(MLP([features, viewdirs, pe(features), pe(viewdirs)])), three
    ``nn.Linear`` layers with ReLU between them."""

    name = "MLP_Fea"

    def __init__(self, app_dim: int, view_pe: int = 2, fea_pe: int = 2,
                 feature_c: int = 128):
        super().__init__()
        self.view_pe = view_pe
        self.fea_pe = fea_pe
        n_in = 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
        self.l1 = nn.Linear(n_in, feature_c)
        self.l2 = nn.Linear(feature_c, feature_c)
        self.l3 = nn.Linear(feature_c, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``torch.nn.Linear``'s default law, as the JAX init draws it:
        U(-1/sqrt(n_in), 1/sqrt(n_in)) for weights and biases, and a zero
        bias on the last layer."""
        for layer in (self.l1, self.l2, self.l3):
            bound = 1.0 / math.sqrt(layer.in_features)
            for p in (layer.weight, layer.bias):
                u = torch.rand(p.shape, generator=generator, device=generator.device)
                p.copy_((u * 2.0 - 1.0) * bound)
        self.l3.bias.zero_()

    def apply_params(self, params: Mapping[str, torch.Tensor], prefix: str,
                     viewdirs: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        """Shade with the weights ``params[prefix + "l1.weight"]`` etc.
        (``nn.Linear`` layout); viewdirs (..., 3), features (..., app_dim)."""
        parts = [features, viewdirs]
        if self.fea_pe > 0:
            parts.append(positional_encoding(features, self.fea_pe))
        if self.view_pe > 0:
            parts.append(positional_encoding(viewdirs, self.view_pe))
        h = torch.cat(parts, dim=-1)
        h = F.relu(F.linear(h, params[prefix + "l1.weight"], params[prefix + "l1.bias"]))
        h = F.relu(F.linear(h, params[prefix + "l2.weight"], params[prefix + "l2.bias"]))
        return torch.sigmoid(F.linear(h, params[prefix + "l3.weight"],
                                      params[prefix + "l3.bias"]))
