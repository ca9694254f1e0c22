"""MLP_Fea shading (counterpart of ``egonerf_tpu/models/shading.py``).  The
other shading modes wait (ROADMAP.md §1).

Three switches select the JAX module's opt-in forms, read from the
environment once, at import, with JAX's names and defaults:

* ``EGONERF_SPLIT_L1=1``: the first layer as a sum of per-part products
  against column slices of ``l1.weight``, in the input's order [features,
  dirs, pe(features), pe(dirs)]; the concat never forms.
* ``EGONERF_HOIST_DIRS=1``: the models pass unexpanded (R, 3) viewdirs, and
  the first layer takes the dir columns as one (R, 15) ray term, broadcast
  onto the (R, S, 135) feature term.  It wins over the split.
* ``EGONERF_BIAS_DOT=1``: every layer adds its bias through
  ``ops.bias.bias_add``, whose bias gradient is K11.

With ``mixed_mm`` (EgoNeRF under ``EGONERF_MIXED_MM=1``) every product of
the MLP, the partial products and the ray term included, is K10's
``ops.mm.mixed_matmul``.  The parameters and their layout do not change.
"""
from __future__ import annotations

import math
import os
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import KERNELS, Ops
from ..ops.bias import bias_add
from ..ops.mm import mixed_matmul
from ..ops.pe import positional_encoding

_BIAS_DOT = os.environ.get("EGONERF_BIAS_DOT", "0") == "1"
_SPLIT_L1 = os.environ.get("EGONERF_SPLIT_L1", "0") == "1"
_HOIST_DIRS = os.environ.get("EGONERF_HOIST_DIRS", "0") == "1"


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
                     viewdirs: torch.Tensor, features: torch.Tensor, ops: Optional[Ops] = None,
                     mixed_mm: bool = False) -> torch.Tensor:
        """Shade with the weights ``params[prefix + "l1.weight"]`` etc.
        (``nn.Linear`` layout); features (..., app_dim) and viewdirs
        (..., 3), or (R, 3) per ray for features (R, S, app_dim) (the
        hoist).  ``ops`` gives the kernels of the forms (``ops.KERNELS`` by
        default); ``mixed_mm`` takes every product through K10."""
        w = {k: params[prefix + k] for k in ("l1.weight", "l1.bias", "l2.weight", "l2.bias",
                                              "l3.weight", "l3.bias")}
        hoist = viewdirs.dim() == features.dim() - 1
        if not (hoist or mixed_mm or _BIAS_DOT or _SPLIT_L1):
            h = torch.cat(self._parts(features, viewdirs), dim=-1)
            h = F.relu(F.linear(h, w["l1.weight"], w["l1.bias"]))
            h = F.relu(F.linear(h, w["l2.weight"], w["l2.bias"]))
            return torch.sigmoid(F.linear(h, w["l3.weight"], w["l3.bias"]))

        ops = KERNELS if ops is None else ops
        if mixed_mm:
            def mm(x, weight):
                return mixed_matmul(x, weight.t(), ops.mm, ops.mm_da, ops.mm_db)
        else:
            mm = F.linear

        def add_bias(x, b):
            return bias_add(x, b, ops.bias_grad) if _BIAS_DOT else x + b

        w1 = w["l1.weight"]
        if hoist:
            h = self._hoist_l1(features, viewdirs, w1, mm)
        elif _SPLIT_L1:
            h, off = None, 0
            for p in self._parts(features, viewdirs):
                term = mm(p, w1[:, off:off + p.shape[-1]])
                h = term if h is None else h + term
                off += p.shape[-1]
        else:
            h = mm(torch.cat(self._parts(features, viewdirs), dim=-1), w1)
        h = F.relu(add_bias(h, w["l1.bias"]))
        h = F.relu(add_bias(mm(h, w["l2.weight"]), w["l2.bias"]))
        return torch.sigmoid(add_bias(mm(h, w["l3.weight"]), w["l3.bias"]))

    def _parts(self, features, viewdirs):
        parts = [features, viewdirs]
        if self.fea_pe > 0:
            parts.append(positional_encoding(features, self.fea_pe))
        if self.view_pe > 0:
            parts.append(positional_encoding(viewdirs, self.view_pe))
        return parts

    def _hoist_l1(self, features, viewdirs_ray, w1, mm):
        """The first layer's product with the viewdir inputs hoisted to the
        rays (JAX ``_mlp3_apply_hoist``): features (R, S, D_f), viewdirs
        (R, 3).  ``l1.weight``'s columns follow the concat order [features,
        dirs, pe(features), pe(dirs)], so the feature and dir weights are
        column gathers of it."""
        d_f = features.shape[-1]
        n_pef = 2 * self.fea_pe * d_f
        w_fea = torch.cat([w1[:, :d_f], w1[:, d_f + 3:d_f + 3 + n_pef]], dim=1)
        w_dir = torch.cat([w1[:, d_f:d_f + 3], w1[:, d_f + 3 + n_pef:]], dim=1)
        x_fea = (torch.cat([features, positional_encoding(features, self.fea_pe)], dim=-1)
                 if self.fea_pe > 0 else features)
        x_dir = (torch.cat([viewdirs_ray, positional_encoding(viewdirs_ray, self.view_pe)],
                           dim=-1) if self.view_pe > 0 else viewdirs_ray)
        return mm(x_fea, w_fea) + mm(x_dir, w_dir)[..., None, :]
