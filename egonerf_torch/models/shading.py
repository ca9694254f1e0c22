"""Shading modules (counterpart of ``egonerf_tpu/models/shading.py``): the
per-sample appearance decoders of JAX's ``make_shader``, behind the same
factory and names.

* ``MLP_Fea``: sigmoid(MLP([features, viewdirs, pe(features),
  pe(viewdirs)]));
* ``MLP_PE``: sigmoid(MLP([features, viewdirs, pts, pe(pts), pe(viewdirs)]))
  on the normalized coords' first three entries, with the raw pts in the
  input as JAX's self-consistent width has them;
* ``MLP``: sigmoid(MLP([features, viewdirs, pe(viewdirs)]));
* ``SH``: relu(sum(sh * bases) + 0.5) on degree-2 bases of the view
  directions (27 appearance channels), with JAX's ``jnp.maximum`` tie;
* ``RGB``: the appearance features themselves (``app_dim`` 3).

The MLPs are three ``nn.Linear`` layers with ReLU between them; SH and RGB
have no parameters.  Three switches select the JAX module's opt-in forms,
read from the environment once, at import, with JAX's names and defaults:

* ``EGONERF_SPLIT_L1=1``: MLP_Fea's first layer as a sum of per-part
  products against column slices of ``l1.weight``, in the input's order
  [features, dirs, pe(features), pe(dirs)]; the concat never forms.
* ``EGONERF_HOIST_DIRS=1``: the models pass MLP_Fea unexpanded (R, 3)
  viewdirs, and its first layer takes the dir columns as one (R, 15) ray
  term, broadcast onto the (R, S, 135) feature term.  It wins over the
  split.
* ``EGONERF_BIAS_DOT=1``: every MLP layer adds its bias through
  ``ops.bias.bias_add``, whose bias gradient is K11.

With ``mixed_mm`` (EgoNeRF under ``EGONERF_MIXED_MM=1``) every product of
an MLP, the partial products and the ray term included, is K10's
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
from ..ops.sh import eval_sh_bases

_BIAS_DOT = os.environ.get("EGONERF_BIAS_DOT", "0") == "1"
_SPLIT_L1 = os.environ.get("EGONERF_SPLIT_L1", "0") == "1"
_HOIST_DIRS = os.environ.get("EGONERF_HOIST_DIRS", "0") == "1"
_WEIGHTS = ("l1.weight", "l1.bias", "l2.weight", "l2.bias", "l3.weight", "l3.bias")


def _mm_of(ops: Ops, mixed_mm: bool):
    """The layers' product: K10 under ``mixed_mm``, else ``F.linear``."""
    if mixed_mm:
        def mm(x, weight):
            return mixed_matmul(x, weight.t(), ops.mm, ops.mm_da, ops.mm_db)
        return mm
    return F.linear


def _layers(h: torch.Tensor, w: Mapping[str, torch.Tensor], mm, ops: Ops) -> torch.Tensor:
    """The MLP after the first layer's product ``h``: its bias and ReLU,
    the second layer, the third and the sigmoid; each bias through K11's
    ``bias_add`` under ``EGONERF_BIAS_DOT=1``."""
    def add_bias(x, b):
        return bias_add(x, b, ops.bias_grad) if _BIAS_DOT else x + b

    h = F.relu(add_bias(h, w["l1.bias"]))
    h = F.relu(add_bias(mm(h, w["l2.weight"]), w["l2.bias"]))
    return torch.sigmoid(add_bias(mm(h, w["l3.weight"]), w["l3.bias"]))


def _plain_mlp(x: torch.Tensor, w: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The three layers in ``F.linear``, no form."""
    h = F.relu(F.linear(x, w["l1.weight"], w["l1.bias"]))
    h = F.relu(F.linear(h, w["l2.weight"], w["l2.bias"]))
    return torch.sigmoid(F.linear(h, w["l3.weight"], w["l3.bias"]))


class _MLP3(nn.Module):
    """Three ``nn.Linear`` layers, ``n_in`` -> ``feature_c`` ->
    ``feature_c`` -> 3."""

    def __init__(self, n_in: int, feature_c: int):
        super().__init__()
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

    def _parts(self, features, viewdirs, pts):
        raise NotImplementedError

    def apply_params(self, params: Mapping[str, torch.Tensor], prefix: str,
                     viewdirs: torch.Tensor, features: torch.Tensor, ops: Optional[Ops] = None,
                     mixed_mm: bool = False, pts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shade with the weights ``params[prefix + "l1.weight"]`` etc.
        (``nn.Linear`` layout): the concat of :meth:`_parts` through the
        three layers; features (..., app_dim), viewdirs (..., 3), pts (...,
        3+) the normalized coords.  ``ops`` gives the kernels of the forms
        (``ops.KERNELS`` by default); ``mixed_mm`` takes every product
        through K10."""
        w = {k: params[prefix + k] for k in _WEIGHTS}
        x = torch.cat(self._parts(features, viewdirs, pts), dim=-1)
        if not (mixed_mm or _BIAS_DOT):
            return _plain_mlp(x, w)
        ops = KERNELS if ops is None else ops
        mm = _mm_of(ops, mixed_mm)
        return _layers(mm(x, w["l1.weight"]), w, mm, ops)


class MLPFea(_MLP3):
    """sigmoid(MLP([features, viewdirs, pe(features), pe(viewdirs)])), three
    ``nn.Linear`` layers with ReLU between them."""

    name = "MLP_Fea"

    def __init__(self, app_dim: int, view_pe: int = 2, fea_pe: int = 2,
                 feature_c: int = 128):
        super().__init__(2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim, feature_c)
        self.view_pe = view_pe
        self.fea_pe = fea_pe

    def apply_params(self, params: Mapping[str, torch.Tensor], prefix: str,
                     viewdirs: torch.Tensor, features: torch.Tensor, ops: Optional[Ops] = None,
                     mixed_mm: bool = False, pts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shade with the weights ``params[prefix + "l1.weight"]`` etc.
        (``nn.Linear`` layout); features (..., app_dim) and viewdirs
        (..., 3), or (R, 3) per ray for features (R, S, app_dim) (the
        hoist); ``pts`` is unused.  ``ops`` gives the kernels of the forms
        (``ops.KERNELS`` by default); ``mixed_mm`` takes every product
        through K10."""
        w = {k: params[prefix + k] for k in _WEIGHTS}
        hoist = viewdirs.dim() == features.dim() - 1
        if not (hoist or mixed_mm or _BIAS_DOT or _SPLIT_L1):
            return _plain_mlp(torch.cat(self._parts(features, viewdirs), dim=-1), w)

        ops = KERNELS if ops is None else ops
        mm = _mm_of(ops, mixed_mm)
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
        return _layers(h, w, mm, ops)

    def _parts(self, features, viewdirs, pts=None):
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


class MLPPE(_MLP3):
    """sigmoid(MLP([features, viewdirs, pts, pe(pts), pe(viewdirs)])) with
    pts the first three normalized coords.  The reference's width counts
    the raw pts, which its forward never appends (dead code); JAX takes
    them in, self-consistently, and so does the port."""

    name = "MLP_PE"

    def __init__(self, app_dim: int, pos_pe: int = 6, view_pe: int = 6, feature_c: int = 128):
        super().__init__((3 + 2 * view_pe * 3) + (3 + 2 * pos_pe * 3) + app_dim, feature_c)
        self.pos_pe = pos_pe
        self.view_pe = view_pe

    def _parts(self, features, viewdirs, pts):
        xyz = pts[..., :3]
        parts = [features, viewdirs, xyz]
        if self.pos_pe > 0:
            parts.append(positional_encoding(xyz, self.pos_pe))
        if self.view_pe > 0:
            parts.append(positional_encoding(viewdirs, self.view_pe))
        return parts


class MLP(_MLP3):
    """sigmoid(MLP([features, viewdirs, pe(viewdirs)]))."""

    name = "MLP"

    def __init__(self, app_dim: int, view_pe: int = 6, feature_c: int = 128):
        super().__init__((3 + 2 * view_pe * 3) + app_dim, feature_c)
        self.view_pe = view_pe

    def _parts(self, features, viewdirs, pts):
        parts = [features, viewdirs]
        if self.view_pe > 0:
            parts.append(positional_encoding(viewdirs, self.view_pe))
        return parts


def _relu_tie(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s gradient: 1 above 0, 0 below and
    half at exactly 0.  (x + |x|) / 2 is exact in float32 (a doubling, then
    a halving) and torch gives |x| the gradient 0 at 0."""
    return (x + x.abs()) * 0.5


class _Parameterless(nn.Module):
    """A shading mode without parameters: nothing to draw or store."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator


class SH(_Parameterless):
    """relu(sum(sh * bases) + 0.5): the appearance features are 3 x 9
    degree-2 SH coefficients (``app_dim`` 27), contracted with the bases at
    the view directions."""

    name = "SH"

    def apply_params(self, params, prefix, viewdirs, features, ops=None, mixed_mm=False,
                     pts=None) -> torch.Tensor:
        sh_mult = eval_sh_bases(2, viewdirs)[..., None, :]
        rgb_sh = features.reshape(*features.shape[:-1], 3, sh_mult.shape[-1])
        return _relu_tie(torch.sum(sh_mult * rgb_sh, dim=-1) + 0.5)


class RGB(_Parameterless):
    """The appearance features are the colour (``app_dim`` 3)."""

    name = "RGB"

    def __init__(self, app_dim: int):
        super().__init__()
        if app_dim != 3:
            raise ValueError(f"RGB shader needs app_dim == 3, got {app_dim}")

    def apply_params(self, params, prefix, viewdirs, features, ops=None, mixed_mm=False,
                     pts=None) -> torch.Tensor:
        return features


def make_shader(mode: str, app_dim: int, pos_pe: int = 6, view_pe: int = 6, fea_pe: int = 6,
                feature_c: int = 128) -> nn.Module:
    """The shading module of ``mode``, with JAX's ``make_shader`` names and
    arguments (``models/shading.py:162-243``); a name it does not know
    raises its ``ValueError``."""
    if mode == "MLP_Fea":
        return MLPFea(app_dim, view_pe, fea_pe, feature_c)
    if mode == "MLP_PE":
        return MLPPE(app_dim, pos_pe, view_pe, feature_c)
    if mode == "MLP":
        return MLP(app_dim, view_pe, feature_c)
    if mode == "SH":
        return SH()
    if mode == "RGB":
        return RGB(app_dim)
    raise ValueError(f"Unrecognized shading mode: {mode}")
