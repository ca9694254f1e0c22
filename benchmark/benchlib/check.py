"""The numbers that decide ``correct``: what the timed path produced held
against the plain reference, each beside the limit in the cell's file
under ``limits/``; a cell compares the numbers its file has limits for.

Training (the first three steps of the very trainer the window drives):
  * ``loss_gap``: the largest of the three steps' |MSE - reference MSE| /
    reference MSE;
  * ``grad_norm_gap``: over the leaves, the largest |‖g‖ - ‖g_ref‖| of the
    first step's gradient (the program's worked out from Adam's first
    moment after one step), over the larger of the leaf's ‖g_ref‖ and the
    median leaf's;
  * ``step_gap``: over the leaves that the reference's first gradient
    moves (‖g_ref‖ at least a thousandth of the median leaf's), the
    largest |‖Δ‖ - ‖Δ_ref‖| of the change after three steps, over the
    larger of the leaf's ‖Δ_ref‖ and the median leaf's.
Rendering (a sample of the window's rays, drawn from the seed), each
output's mean |x - x_ref| over mean |x_ref|:
  * ``rgb_gap``: the colour;
  * ``depth_gap``: the depth;
  * ``bg_gap``: the envmap's share of the colour, where the cell has one;
and ``rgb_q10_gap``, the tenth percentile over the rays of a ray's mean
|rgb - rgb_ref| over the mean |rgb_ref| of all: a gap that nine rays in
ten exceed, which the few rays whose float32 arithmetic is ill-conditioned
do not move.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch


def _norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def train_numbers(losses, ref_losses, grads, ref_grads, change, ref_change) -> Dict[str, float]:
    """The training cell's numbers (module docstring); ``change`` and
    ``ref_change`` are each leaf's change after the steps compared."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g, g_ref = _norms(grads), _norms(ref_grads)
    med_g = _median(g_ref.values())
    d, d_ref = _norms(change), _norms(ref_change)
    moved = [k for k in d_ref if g_ref[k] >= 1e-3 * med_g]
    med_d = _median(d_ref[k] for k in moved)
    return {
        "loss_gap": loss_gap,
        "grad_norm_gap": max(abs(g[k] - g_ref[k]) / max(g_ref[k], med_g) for k in g_ref),
        "step_gap": max(abs(d[k] - d_ref[k]) / max(d_ref[k], med_d) for k in moved),
    }


def render_numbers(out: Mapping[str, torch.Tensor],
                   ref: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The render cell's numbers (module docstring) on matching rays."""
    nums = {}
    for key in ("rgb", "depth", "bg"):
        if key in ref:
            a, b = out[key].double(), ref[key].double()
            nums[f"{key}_gap"] = float((a - b).abs().mean() / b.abs().mean())
    a, b = out["rgb"].double(), ref["rgb"].double()
    per_ray = (a - b).abs().mean(-1) / b.abs().mean()
    nums["rgb_q10_gap"] = float(torch.quantile(per_ray, 0.1))
    return nums


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number finite and within its limit; a number without a limit,
    or a limit without a number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
