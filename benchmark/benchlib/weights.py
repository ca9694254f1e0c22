"""The model's weights, drawn from the seed on the device in a few large
calls, in float32 as they are trained and served.

The laws are EgoNeRF's init (planes and lines normal, the basis and the
shader uniform as ``nn.Linear``, the envmap uniform in [0, 1)), with the
density tables' scale taken from the configuration file so that the rays
are partly opaque: at the init's 0.1 a ray is nearly transparent, and a
comparison of its colour could not see a lower precision in the shader.
The draws are the benchmark's; both the program and the reference get
copies of them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def shapes(grid, n_sigma, n_app, app_dim: int, n_shader_in: int, feature_c: int,
           envmap_h: int = 0) -> Dict[str, tuple]:
    """Every leaf's shape, under the program's parameter names."""
    out = {}
    for kind, comps in (("density", n_sigma), ("app", n_app)):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            out[f"{kind}_planes.{i}"] = (2, grid[m1], grid[m0], comps[i])
            out[f"{kind}_lines.{i}"] = (2, grid[VEC_MODE[i]], comps[i])
    out["basis"] = (2, sum(n_app), app_dim)
    out["shader.l1.weight"] = (feature_c, n_shader_in)
    out["shader.l1.bias"] = (feature_c,)
    out["shader.l2.weight"] = (feature_c, feature_c)
    out["shader.l2.bias"] = (feature_c,)
    out["shader.l3.weight"] = (3, feature_c)
    out["shader.l3.bias"] = (3,)
    if envmap_h:
        out["envmap"] = (2 * envmap_h, envmap_h, 3)
    return out


def draw(leaf_shapes: Dict[str, tuple], seed: int, device, density_std: float,
         app_std: float = 0.1) -> Dict[str, torch.Tensor]:
    """The weights of ``seed``: one normal draw for every table, one
    uniform draw for the basis and the shader, one for the envmap."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    tables = [k for k in leaf_shapes if "_planes." in k or "_lines." in k]
    uniform = [k for k in leaf_shapes if k == "basis" or k.startswith("shader.")]
    sizes = [math.prod(leaf_shapes[k]) for k in tables]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(tables, flat.split(sizes)):
        std = density_std if k.startswith("density") else app_std
        out[k] = (part * std).reshape(leaf_shapes[k])
    sizes = [math.prod(leaf_shapes[k]) for k in uniform]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    for k, part in zip(uniform, flat.split(sizes)):
        fan_in = leaf_shapes[k][1] if k == "basis" else (
            leaf_shapes[k][-1] if k.endswith("weight") else
            leaf_shapes[k.replace("bias", "weight")][-1])
        out[k] = (part / math.sqrt(fan_in)).reshape(leaf_shapes[k])
    out["shader.l3.bias"].zero_()
    if "envmap" in leaf_shapes:
        out["envmap"] = torch.rand(leaf_shapes["envmap"], generator=gen, device=device)
    return out


def install(params: Dict[str, torch.nn.Parameter], weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the program's parameters in place; every
    parameter gets one and no other key is allowed."""
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: program {sorted(set(params) - set(weights))}"
                         f", benchmark {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for k, p in params.items():
            if tuple(p.shape) != tuple(weights[k].shape):
                raise ValueError(f"{k}: program shape {tuple(p.shape)}, benchmark "
                                 f"{tuple(weights[k].shape)}")
            p.copy_(weights[k])
