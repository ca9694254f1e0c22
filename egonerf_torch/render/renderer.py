"""Chunked renderer and the test-set evaluation (counterpart of
``egonerf_tpu/render/renderer.py``: ``Renderer`` and ``evaluation``).
``evaluation_path`` waits (ROADMAP.md §1).

Rays go through ``EgoNeRF.forward`` in fixed chunks under
``torch.no_grad()``; the tail is padded by repeating the last ray and
trimmed from the outputs.  The bf16 lookup tables and the coarse grid are
built once per ``render_*`` call.  With the envmap the outputs gain ``bg``,
and ``pretrain_envmap`` renders the envmap's radiance ``env`` alone.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .metrics import psnr as psnr_fn


class Renderer:
    """Chunked renderer for one model and render configuration; the
    keyword arguments are ``EgoNeRF.forward``'s (n_coarse, n_fine,
    exp_sampling, resampling, use_coarse_sample, white_bg, eval_keep), as
    the JAX ``Renderer.from_config`` maps them from a training config."""

    def __init__(self, model, chunk: int = 4096, **render_kwargs):
        self.model = model
        # env is view-independent: the pretrain_envmap render gives it
        self.out_keys = ("rgb", "depth") + (("bg",) if model.cfg.use_envmap else ())
        self.chunk = int(chunk)
        self.render_kwargs = dict(render_kwargs)
        self._dirs = None
        self._n_rays_view = 0

    @classmethod
    def from_config(cls, model, cfg, white_bg, chunk=None, **overrides):
        """The render keyword arguments of a training config, as the JAX
        ``Renderer.from_config`` maps them."""
        kw = dict(n_coarse=cfg.n_coarse, n_fine=(cfg.n_fine if cfg.resampling else 0),
                  exp_sampling=cfg.exp_sampling, resampling=cfg.resampling,
                  use_coarse_sample=cfg.use_coarse_sample, white_bg=white_bg,
                  eval_keep=cfg.eval_keep)
        kw.update(overrides)
        return cls(model, chunk=int(cfg.eval_chunk if chunk is None else chunk), **kw)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        n_pad = -(-n // self.chunk) * self.chunk
        if n_pad != n:
            x = torch.cat([x, x[-1:].expand(n_pad - n, x.shape[1])])
        return x

    @torch.no_grad()
    def _render_chunks(self, params, rays_of_chunk, n_chunks: int, n: int,
                       pretrain_envmap: bool = False) -> dict:
        model = self.model
        if pretrain_envmap:
            kw, keys = {"pretrain_envmap": True}, ("env",)
        else:
            kw = dict(tables=model.lookup_tables(params), **self.render_kwargs)
            keys = self.out_keys
        outs = [model.forward(params, rays_of_chunk(c), key=None, is_train=False, **kw)
                for c in range(n_chunks)]
        return {k: torch.cat([o[k] for o in outs])[:n] for k in keys}

    def render_rays(self, params, rays, pretrain_envmap: bool = False) -> dict:
        """rays (N, 6), numpy or tensor -> dict of (N, ...) tensors on the
        model's device; ``pretrain_envmap`` gives the envmap's ``env``
        alone."""
        dev = self.model.device
        rays = torch.as_tensor(np.asarray(rays, np.float32) if isinstance(rays, np.ndarray)
                               else rays, dtype=torch.float32, device=dev)
        n = rays.shape[0]
        rays = self._pad(rays)
        return self._render_chunks(
            params, lambda c: rays[c * self.chunk:(c + 1) * self.chunk],
            rays.shape[0] // self.chunk, n, pretrain_envmap)

    def set_directions(self, directions) -> None:
        """Install the camera-frame direction grid (h, w, 3) or (N, 3),
        resident on the model's device."""
        dirs = torch.as_tensor(np.asarray(directions, np.float32).reshape(-1, 3),
                               device=self.model.device)
        self._n_rays_view = dirs.shape[0]
        self._dirs = self._pad(dirs)

    def render_view(self, params, c2w) -> dict:
        """Render one camera of pose ``c2w`` (3x4 or 4x4); rays are made on
        the device from the installed directions.  Requires
        :meth:`set_directions`."""
        if self._dirs is None:
            raise RuntimeError("call set_directions() before render_view()")
        c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=self.model.device)
        rot_t = c2w[:3, :3].T
        origin = c2w[:3, 3]

        def rays_of_chunk(c):
            rays_d = self._dirs[c * self.chunk:(c + 1) * self.chunk] @ rot_t
            return torch.cat([origin.expand_as(rays_d), rays_d], dim=-1)

        return self._render_chunks(params, rays_of_chunk,
                                   self._dirs.shape[0] // self.chunk,
                                   self._n_rays_view)


def evaluation(test_dataset, model, params, renderer: Renderer, save_path=None,
               n_vis: int = -1, prefix: str = "", envmap_only: bool = False) -> list:
    """Render the test split and return the PSNR of each rendered view;
    with ``save_path``, write ``{prefix}mean.txt`` in the JAX package's
    five-row layout [psnr, ssim, ws_ssim, lpips_alex, lpips_vgg], nan where
    the port has no metric yet.  ``n_vis`` > 0 renders every
    (n_images // n_vis)-th view, -1 all, 0 none.  ``envmap_only`` renders
    the envmap's radiance of view 0 alone (the pretrain's check, JAX
    ``renderer.py:220-226``; PNG output waits) and returns []."""
    w, h = test_dataset.img_wh
    n_images = test_dataset.all_rays.shape[0]
    if n_vis == 0:
        return []
    if envmap_only:
        out = renderer.render_rays(params, test_dataset.all_rays[0].reshape(-1, 6),
                                   pretrain_envmap=True)
        env = out["env"].reshape(h, w, 3)
        line = f"envmap of view 0: mean radiance {float(env.mean()):.4f}"
        if len(test_dataset.all_rgbs):
            gt = np.asarray(test_dataset.all_rgbs[0]).reshape(h, w, 3)
            line += f", psnr {psnr_fn(env.cpu().numpy(), gt):.2f} against the image"
        print(line)
        return []
    interval = 1 if n_vis < 0 else max(n_images // n_vis, 1)
    idxs = list(range(0, n_images, interval))
    device_raygen = (getattr(test_dataset, "directions", None) is not None
                     and getattr(test_dataset, "poses", None) is not None)
    if device_raygen:
        renderer.set_directions(test_dataset.directions)
    psnrs = []
    for out_idx, img_idx in enumerate(idxs):
        t0 = time.time()
        if device_raygen:
            out = renderer.render_view(params, test_dataset.poses[img_idx])
        else:
            out = renderer.render_rays(params, test_dataset.all_rays[img_idx].reshape(-1, 6))
        rgb = out["rgb"].reshape(h, w, 3).cpu().numpy()
        elapsed = time.time() - t0
        if len(test_dataset.all_rgbs):
            gt = np.asarray(test_dataset.all_rgbs[img_idx]).reshape(h, w, 3)
            psnrs.append(psnr_fn(rgb, gt))
        print(f"eval image {out_idx}: {elapsed:.2f}s"
              + (f", psnr {psnrs[-1]:.2f}" if psnrs else ""))
    if psnrs and save_path:
        os.makedirs(save_path, exist_ok=True)
        row = [float(np.mean(psnrs))] + [float("nan")] * 4
        np.savetxt(os.path.join(save_path, f"{prefix}mean.txt"), np.asarray(row))
    return psnrs
