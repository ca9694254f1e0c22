"""Chunked renderer, the test-set evaluation and the trajectory render
(counterpart of ``egonerf_tpu/render/renderer.py``: ``Renderer``,
``evaluation`` and ``evaluation_path``).

Rays go through the model's forward (``EgoNeRF`` or a TensoRF member) in
fixed chunks under ``torch.no_grad()``; the tail is padded by repeating the
last ray and trimmed from the outputs.  On a data mesh
(``parallel/mesh.py``) each rank renders its contiguous share of a view's
chunks (the rays padded to a multiple of chunk x world, JAX's
``pad_to_multiple``) and the outputs are gathered, so every rank holds the
whole view, as JAX replicates it.  The bf16 lookup tables (and
EgoNeRF's coarse grid) come from ``model.lookup_tables`` once per
``render_*`` call.  With the envmap the outputs gain ``bg``,
and ``pretrain_envmap`` renders the envmap's radiance ``env`` alone.
"""
from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.png import write_png
from ..data.ray_utils import get_ray_directions_360
from ..parallel.mesh import pad_to_multiple
from .lpips import rgb_lpips
from .metrics import psnr as psnr_fn
from .metrics import ssim_and_ws_ssim, ws_psnr
from .viz import to_uint8, visualize_depth


class Renderer:
    """Chunked renderer for one model and render configuration; the
    keyword arguments are the model forward's (n_coarse, n_fine,
    exp_sampling, resampling, use_coarse_sample, white_bg, eval_keep), as
    the JAX ``Renderer.from_config`` maps them from a training config
    (the TensoRF family marches ``n_coarse`` samples a ray and ignores the
    rest; ``ndc_ray`` is never passed, as JAX's renderer never passes
    it).  ``mesh`` (a ``parallel.mesh.DataMesh``) splits each view's chunks
    over its ranks."""

    def __init__(self, model, chunk: int = 4096, mesh=None, **render_kwargs):
        self.model = model
        self.mesh = mesh
        # env is view-independent: the pretrain_envmap render gives it
        self.out_keys = ("rgb", "depth") + (("bg",) if model.cfg.use_envmap else ())
        self.chunk = int(chunk)
        self.render_kwargs = dict(render_kwargs)
        self._dirs = None
        self._n_rays_view = 0

    @classmethod
    def from_config(cls, model, cfg, white_bg, chunk=None, mesh=None, **overrides):
        """The render keyword arguments of a training config, as the JAX
        ``Renderer.from_config`` maps them."""
        kw = dict(n_coarse=cfg.n_coarse, n_fine=(cfg.n_fine if cfg.resampling else 0),
                  exp_sampling=cfg.exp_sampling, resampling=cfg.resampling,
                  use_coarse_sample=cfg.use_coarse_sample, white_bg=white_bg,
                  eval_keep=cfg.eval_keep)
        kw.update(overrides)
        return cls(model, chunk=int(cfg.eval_chunk if chunk is None else chunk), mesh=mesh, **kw)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        n_pad = pad_to_multiple(n, self.chunk * (self.mesh.world if self.mesh else 1))
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
        chunks = range(n_chunks)
        if self.mesh is not None:
            chunks = range(*self.mesh.shard(n_chunks))
        outs = [model.forward(params, rays_of_chunk(c), key=None, is_train=False, **kw)
                for c in chunks]
        out = {k: torch.cat([o[k] for o in outs]) for k in keys}
        if self.mesh is not None:
            out = {k: self.mesh.gather_rows(v) for k, v in out.items()}
        return {k: v[:n] for k, v in out.items()}

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

    def render_view(self, params, c2w, pretrain_envmap: bool = False) -> dict:
        """Render one camera of pose ``c2w`` (3x4 or 4x4); rays are made on
        the device from the installed directions; ``pretrain_envmap`` gives
        the envmap's ``env`` alone.  Requires :meth:`set_directions`."""
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
                                   self._n_rays_view, pretrain_envmap)


def _write_view(save_path, prefix, out_idx, rgb8, depth_vis, bg, env) -> None:
    """The images of one view: ``{prefix}{i:03d}.png``, ``rgbd/`` (rgb
    beside the depth colour map), and with the envmap ``{prefix}envmap.png``
    (view 0 only) and ``{prefix}{i:03d}_bg.png``."""
    write_png(os.path.join(save_path, f"{prefix}{out_idx:03d}.png"), rgb8)
    write_png(os.path.join(save_path, "rgbd", f"{prefix}{out_idx:03d}.png"),
              np.concatenate([rgb8, depth_vis], axis=1))
    if env is not None:
        if out_idx == 0:
            write_png(os.path.join(save_path, f"{prefix}envmap.png"), to_uint8(env))
        write_png(os.path.join(save_path, f"{prefix}{out_idx:03d}_bg.png"), to_uint8(bg))


def _view_metrics(rgb, gt, extra: bool, device) -> dict:
    """PSNR of one view, and with ``extra`` SSIM and WS-SSIM (one SSIM
    map), WS-PSNR and LPIPS alex and vgg (None without a weights file)."""
    m = {"psnr": psnr_fn(rgb, gt)}
    if extra:
        m["ssim"], m["ws_ssim"] = ssim_and_ws_ssim(rgb, gt, 1.0)
        m["ws_psnr"] = ws_psnr(rgb, gt)
        m["lpips_alex"] = rgb_lpips(gt, rgb, "alex", device)
        m["lpips_vgg"] = rgb_lpips(gt, rgb, "vgg", device)
    return m


def _mean(rows: list, key: str):
    vals = [r[key] for r in rows if r.get(key) is not None]
    return float(np.mean(vals)) if vals else None


def evaluation(test_dataset, model, params, renderer: Renderer, save_path=None,
               n_vis: int = -1, prefix: str = "", compute_extra_metrics: bool = True,
               envmap_only: bool = False, save_images: bool = True,
               overlap: bool = True) -> list:
    """Render the test split and return the PSNR of each rendered view (JAX
    ``egonerf_tpu/render/renderer.py:200-348``).

    ``n_vis`` > 0 renders every (n_images // n_vis)-th view, -1 all, 0
    none.  ``compute_extra_metrics`` adds SSIM, WS-SSIM, WS-PSNR and LPIPS
    (:mod:`.lpips`; absent without a weights file).  With ``save_path``
    it writes ``{prefix}mean.txt``, the five rows [psnr, ssim, ws_ssim,
    lpips_alex, lpips_vgg] with nan for an absent metric, and
    ``{prefix}mean.json`` (JAX's keys, null for an absent metric), and with
    ``save_images`` each view's images (:func:`_write_view`; the envmap's
    image from one ``pretrain_envmap`` render of the first view).
    ``envmap_only`` writes the envmap's radiance of view 0 as
    ``pretrained_envmap.png`` (the pretrain's check) and returns [].

    ``overlap`` hands each view's metrics and images to one worker thread
    once its outputs are on the host, so they run while the main thread
    queues the next view on the card; without it they run in turn."""
    w, h = test_dataset.img_wh
    n_images = test_dataset.all_rays.shape[0]
    if n_vis == 0:
        return []
    if save_path:
        os.makedirs(os.path.join(save_path, "rgbd"), exist_ok=True)
    if envmap_only:
        out = renderer.render_rays(params, test_dataset.all_rays[0].reshape(-1, 6),
                                   pretrain_envmap=True)
        if save_path:
            write_png(os.path.join(save_path, "pretrained_envmap.png"),
                      to_uint8(out["env"].reshape(h, w, 3).cpu().numpy()))
        return []
    interval = 1 if n_vis < 0 else max(n_images // n_vis, 1)
    idxs = list(range(0, n_images, interval))
    device_raygen = (getattr(test_dataset, "directions", None) is not None
                     and getattr(test_dataset, "poses", None) is not None)
    if device_raygen:
        renderer.set_directions(test_dataset.directions)

    def render(img_idx, pretrain_envmap=False):
        if device_raygen:
            return renderer.render_view(params, test_dataset.poses[img_idx], pretrain_envmap)
        return renderer.render_rays(params, test_dataset.all_rays[img_idx].reshape(-1, 6),
                                    pretrain_envmap)

    save_maps = bool(save_path and save_images)
    # the envmap is view-independent radiance: rendered once (on a mesh by
    # every rank whenever one writes it, since the render is collective)
    env = None
    if idxs and save_images and getattr(model.cfg, "use_envmap", False) and (
            save_path or renderer.mesh is not None):
        env = render(idxs[0], pretrain_envmap=True)["env"].reshape(h, w, 3).cpu().numpy()
    has_gt = len(test_dataset.all_rgbs) > 0

    def host_work(out_idx, img_idx, rgb, depth, bg, elapsed):
        m = {}
        if has_gt:
            gt = np.asarray(test_dataset.all_rgbs[img_idx]).reshape(h, w, 3)
            m = _view_metrics(rgb, gt, compute_extra_metrics, model.device)
        if save_maps:
            depth_vis, _ = visualize_depth(depth, test_dataset.near_far)
            _write_view(save_path, prefix, out_idx, to_uint8(rgb), depth_vis, bg, env)
        print(f"eval image {out_idx}: {elapsed:.2f}s (render and copy)"
              + (f", psnr {m['psnr']:.2f}" if m else ""), flush=True)
        return m

    pool = ThreadPoolExecutor(max_workers=1) if overlap else None
    jobs = []
    t_wall0 = time.time()
    try:
        for out_idx, img_idx in enumerate(idxs):
            t0 = time.time()
            out = render(img_idx)
            rgb = out["rgb"].reshape(h, w, 3).cpu().numpy()
            depth = out["depth"].reshape(h, w).cpu().numpy()
            bg = out["bg"].reshape(h, w, 3).cpu().numpy() if env is not None else None
            args = (out_idx, img_idx, rgb, depth, bg, time.time() - t0)
            jobs.append(pool.submit(host_work, *args) if pool else host_work(*args))
        rows = [j.result() for j in jobs] if pool else jobs
    finally:
        if pool:
            pool.shutdown(wait=True)
    if len(idxs) > 1:
        wall = time.time() - t_wall0
        print(f"eval total: {len(idxs)} images in {wall:.2f}s "
              f"({wall / len(idxs):.2f}s/image)")

    psnrs = [r["psnr"] for r in rows if r]
    if psnrs and save_path:
        summary = {k: _mean(rows, k) for k in ("psnr", "ssim", "ws_ssim", "ws_psnr",
                                                "lpips_alex", "lpips_vgg")}
        summary["n_images"] = len(psnrs)
        row = [float("nan") if summary[k] is None else summary[k]
               for k in ("psnr", "ssim", "ws_ssim", "lpips_alex", "lpips_vgg")]
        np.savetxt(os.path.join(save_path, f"{prefix}mean.txt"), np.asarray(row))
        with open(os.path.join(save_path, f"{prefix}mean.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return psnrs


def evaluation_path(test_dataset, model, params, c2ws, renderer: Renderer, save_path=None,
                    prefix: str = "") -> list:
    """Render the camera trajectory ``c2ws`` (JAX ``renderer.py:351-401``):
    with ``save_path``, PNG frames ``{prefix}{i:03d}.png`` and ``rgbd/``
    frames, then the two mp4s where an ffmpeg-backed ``imageio`` writer
    exists (else JAX's "video export skipped" line).  Directions are the
    dataset's, or the equirectangular grid normalised.  Returns the uint8
    rgb frames."""
    w, h = test_dataset.img_wh
    if save_path:
        os.makedirs(os.path.join(save_path, "rgbd"), exist_ok=True)
    directions = getattr(test_dataset, "directions", None)
    if directions is None:
        directions = get_ray_directions_360(h, w)
        directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    renderer.set_directions(directions)
    rgb_maps, depth_maps = [], []
    for idx, c2w in enumerate(c2ws):
        out = renderer.render_view(params, c2w)
        rgb = to_uint8(out["rgb"].reshape(h, w, 3).cpu().numpy())
        depth_vis, _ = visualize_depth(out["depth"].reshape(h, w).cpu().numpy(),
                                       test_dataset.near_far)
        rgb_maps.append(rgb)
        depth_maps.append(depth_vis)
        if save_path:
            write_png(os.path.join(save_path, f"{prefix}{idx:03d}.png"), rgb)
            write_png(os.path.join(save_path, "rgbd", f"{prefix}{idx:03d}.png"),
                      np.concatenate([rgb, depth_vis], axis=1))
    if save_path:
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(os.path.join(save_path, f"{prefix}video.mp4"),
                             np.stack(rgb_maps), fps=30, quality=8)
            imageio.mimwrite(os.path.join(save_path, f"{prefix}depthvideo.mp4"),
                             np.stack(depth_maps), fps=30, quality=8)
        except Exception as e:  # no ffmpeg-backed writer
            print(f"video export skipped: {e}")
    return rgb_maps
