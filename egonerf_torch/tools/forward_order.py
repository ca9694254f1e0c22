"""K10's forward: the sum order against the plain version, on the card.

Under ``EGONERF_MIXED_MM=1`` every shader product's float32 output is
rounded to bf16 again as the next product's operand, so wherever the kernel
and the plain version sum in different orders, a last bit can move that
rounding by a bf16 ulp.  This tool measures what that does on the
production shader after some training: the shader's rgb a sample and the
render over a few chunks, against the plain versions, with K10's forward
(the CUDA cores in k order, as the plain version sums) and with the same
products taken on the tensor cores (K10's rows layout, which da uses, on
the transposed weight); and the share of l1's product outputs equal to the
plain version's bit for bit.  Run on a card::

    python -m egonerf_torch.tools.forward_order [--steps 60] [--chunks 3]
"""
from __future__ import annotations

import argparse
import os
import subprocess

import torch

from .. import ops, presets
from ..data.ray_utils import get_ray_directions_360
from ..ops import mm
from ..render.renderer import Renderer
from ..train.config import load_config
from ..train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tensor_core_forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on the tensor cores: K10's rows layout (its da) computes
    dout @ w^T, so a @ b is da(a, b^T)."""
    return mm.mixed_mm_da(a, b.t())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=60, help="training steps before measuring")
    parser.add_argument("--chunks", type=int, default=3, help="render chunks compared")
    args = parser.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    trainer = Trainer(load_config(overrides=presets.production_overrides(
        basedir=os.path.join(ROOT, "build", "forward_order"), expname="production",
        n_iters=10 ** 9, N_vis=0, progress_refresh_rate=10 ** 9)), device=dev)
    for it in range(args.steps):
        trainer.train_step(it)
    model, params = trainer.model, trainer.params
    model.mixed_mm = True  # the shader and basis products through mixed_matmul
    chunk = presets.EVAL_CHUNK
    dirs = torch.as_tensor(get_ray_directions_360(1000, 2000).reshape(-1, 3), device=dev)
    pick = torch.arange(args.chunks * chunk, device=dev) * (dirs.shape[0] // (args.chunks * chunk))
    rays = torch.cat([torch.zeros_like(dirs[pick]), dirs[pick]], dim=-1)
    renderer = Renderer(model, chunk=chunk, **presets.RENDER)
    shader = model.shader
    with torch.no_grad():
        # the shader's inputs on the first chunk
        seen = {}
        apply = shader.apply_params

        def grab(p, prefix, viewdirs, features, o=None, mixed=False, **kw):
            seen["in"] = (viewdirs, features)
            return apply(p, prefix, viewdirs, features, o, mixed, **kw)

        shader.apply_params = grab
        model.forward(params, rays[:chunk], tables=model.lookup_tables(params), **presets.RENDER)
        shader.apply_params = apply
        viewdirs, features = seen["in"]
        model.ops = ops.PLAIN
        ref = renderer.render_rays(params, rays)
        rgb_ref = shader.apply_params(params, "shader.", viewdirs, features, ops.PLAIN, True)
        x = torch.cat(shader._parts(features, viewdirs), dim=-1).reshape(-1, shader.l1.in_features)
        w1 = params["shader.l1.weight"].t()
        l1_ref = mm.mixed_mm_plain(x, w1)
        for label, o, fwd in (("k-order forward (K10)", ops.KERNELS, mm.mixed_mm),
                              ("tensor-core forward", ops.KERNELS._replace(mm=tensor_core_forward),
                               tensor_core_forward)):
            model.ops = o
            got = renderer.render_rays(params, rays)
            rgb = shader.apply_params(params, "shader.", viewdirs, features, o, True)
            d_sample = (rgb - rgb_ref).abs().amax(-1)
            same = float((fwd(x, w1) == l1_ref).float().mean())
            print(f"{label}: l1's outputs equal to the plain version's on {same:.4%}; shader rgb "
                  f"a sample max |diff| {float(d_sample.max()):.3e} ({int((d_sample > 1e-5).sum())}"
                  f" of {d_sample.numel():,} over 1e-5); render of {rays.shape[0]} rays max |rgb - "
                  f"plain| {float((got['rgb'] - ref['rgb']).abs().max()):.3e}", flush=True)
        model.ops = ops.KERNELS
    print(f"{card}; {args.steps} production steps before measuring", flush=True)


if __name__ == "__main__":
    main()
