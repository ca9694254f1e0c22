"""The TensoRF family: single grids on any chart but the yin-yang one
(counterpart of ``egonerf_tpu/models/tensorf.py``: ``TensorBase``,
``TensorVMSplit``, ``TensorVM``, ``TensorCP``).

The parameters keep the JAX layout at the module's public functions:
planes (1, H, W, C), lines (1, L, C), basis (n_app, app_dim), under
``state_dict`` names as for EgoNeRF.  ``TensorVMSplit``'s lookups are
EgoNeRF's kernels on a stack of one grid: K1 (fine density + appearance,
K2 backward) and K3 (density alone, for the bake and the sparsity loss).
``TensorVM`` is ``TensorVMSplit`` whose density partials are summed raw,
with no relu (K1, K2 and K3 in their relu-free instantiations).
``TensorCP`` holds three lines a field and no plane: its field is the
channel product of the three line samples, K17 (K17b backward).  Samples
march uniformly from the aabb entry, ``step_size`` apart (or
exponentially, or, in training under ``ndc_ray``, over [near, far] in NDC
space); K9 gates them with the alpha mask once one is baked; the
composite (K6, K6b backward) zeroes sigma outside the box and the mask,
and rgb where the weight is not above ``ray_march_weight_thres``.  The
samples' chart is ``generic_sphere``'s K7s under ``interval_th`` (JAX's
gather-free ``normalize_r_lookup``; it also gives the samples' in-box mask,
so that path forms no points in torch) and the chart's plain torch map
otherwise, as JAX computes those outside any hand op; the shader is any of
JAX's five modes.  The family also carries JAX's ``shrink`` (a crop of the
grids to a tighter aabb; no trainer calls it, in either package) and
``filtering_rays`` (the trainer's ``filter_ray``).  Of the JAX module's opt-in forms the
family takes ``EGONERF_LINE_HAT=0`` (float32 line weights) and the
shader's (``EGONERF_HOIST_DIRS``, ``EGONERF_SPLIT_L1``,
``EGONERF_BIAS_DOT``), not ``EGONERF_MIXED_MM``, as in JAX.
"""
from __future__ import annotations

from math import pi
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .._device import full_f32_matmul, resolve_device
from ..coords.base import Coordinates
from ..coords.yinyang import YinYangSphericalCoords
from ..ops import KERNELS
from ..ops.chart import is_single_sphere
from ..ops.cp import cp_train
from ..ops.vm_lookup import LINE_HAT as _LINE_HAT
from ..ops.vm_lookup import (HAT, LINEAR, MAT_MODE, VEC_MODE, density_train, field_train,
                             line_hat_ok)
from ..ops.volrend import composite_train
from .alphamask import AlphaGridMask, bake_alpha_mask, dense_alpha
from .egonerf import (EgoNeRF, LookupTables, StepKey, _bf16, _dists, feature2density, tv_plane,
                      with_background)
from .envmap import envmap_radiance, init_envmap
from .shading import _HOIST_DIRS, make_shader


def linspace(start: float, stop: float, n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` as XLA compiles it inside a jitted
    forward, where ``start`` and ``stop`` are constants, bit for bit: in
    float32, start * (1 - i r) + i (stop r) with r = 1 / (n - 1) (XLA
    multiplies by the reciprocal and folds stop * r), then ``stop``."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if n == 1:
        return torch.full((1,), float(start32), device=device)
    r = np.float32(1.0) / np.float32(n - 1)
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    head = float(start32) * (1.0 - i * float(r)) + i * float(stop32 * r)
    return torch.cat([head, torch.full((1,), float(stop32), device=device)])


class TensorBase(nn.Module):
    """What the family shares (JAX ``TensorBase``): the grid bookkeeping,
    the ray samplers, the alpha mask, ray filtering and the forward.  A
    member builds its parameters in ``_make_params`` and supplies the
    field (``compute_field``, ``compute_density_feature_only``), the
    regularizers, ``upsample_params`` and ``shrink``."""

    name = "TensorBase"

    def __init__(self, aabb, grid_size, coordinates: Coordinates, cfg, near_far=(2.0, 6.0),
                 device="cuda"):
        super().__init__()
        if isinstance(coordinates, YinYangSphericalCoords):
            # JAX's family reads the chart's [r, theta, phi] and drops the grid
            # flag, so both halves of the sphere land on one grid
            raise ValueError(f"{self.name} takes a single-grid chart; the yin-yang chart is "
                             "EgoNeRF's (ROADMAP.md §3)")
        if cfg.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.device = resolve_device(device)
        full_f32_matmul()
        self.aabb = np.asarray(aabb, np.float32).reshape(2, 3)
        self.coordinates = coordinates
        self.cfg = cfg
        self.near_far = (float(near_far[0]), float(near_far[1]))
        self.ops = KERNELS
        self.alpha_mask: Optional[AlphaGridMask] = None
        self._aabb_t: dict = {}
        self._make_params(grid_size)
        self.shader = make_shader(cfg.shading_mode, cfg.app_dim, cfg.pos_pe, cfg.view_pe,
                                  cfg.fea_pe, cfg.feature_c).to(self.device)
        if cfg.use_envmap:
            self.envmap = nn.Parameter(init_envmap(cfg.envmap_res_h, init_strategy="zero",
                                                   device=self.device))
        self.update_step_size(grid_size)

    def _make_params(self, grid_size) -> None:
        raise NotImplementedError

    def _lines(self, gs, n_comp):
        return nn.ParameterList([
            nn.Parameter(torch.zeros(1, gs[VEC_MODE[i]], n_comp[i], device=self.device))
            for i in range(3)])

    def update_step_size(self, grid_size) -> None:
        """Grid bookkeeping (JAX ``tensorf.py:52-58``): the march step is
        the mean grid unit times ``step_ratio``, so each upsample shortens
        the ray's reach."""
        self.grid_size = [int(g) for g in grid_size]
        aabb_size = self.aabb[1] - self.aabb[0]
        self.step_size = float(np.mean(aabb_size / (np.asarray(self.grid_size) - 1))
                               * self.cfg.step_ratio)
        self.n_samples_auto = int(float(np.linalg.norm(aabb_size) / 2.0) / self.step_size) + 1

    params = EgoNeRF.params

    def _line_hat(self, lines, n: int):
        """Each line's mode for ``n`` samples: the hat path under bf16
        compute while its gate holds, else float32 weights (JAX's
        ``sample_line_packed``, also under ``EGONERF_LINE_HAT=0``)."""
        hat = self.cfg.compute_dtype == "bfloat16" and _LINE_HAT
        return [HAT if hat and line_hat_ok(l.shape[0] * l.shape[1], n) else LINEAR
                for l in lines]

    def _set_aabb(self, new_aabb, new_size) -> None:
        """``shrink``'s tail: the new aabb, pushed into the chart, and the
        step of the cropped grid (JAX ``tensorf.py:416-418``)."""
        self.aabb = np.asarray(new_aabb, np.float32).reshape(2, 3)
        self.coordinates.update_aabb(self.aabb)
        self._aabb_t.clear()
        self.update_step_size(new_size)

    @staticmethod
    def _sparsity_points(generator, n_points: int, points) -> torch.Tensor:
        """The sparsity loss's (n, 4) lookup coords: ``points`` (n, 3), or
        ``n_points`` uniform in [-1, 1)^3 from ``generator`` (JAX
        ``models/tensorf.py:284-287``), with the flag of a single grid."""
        if points is None:
            points = torch.rand(n_points, 3, generator=generator,
                                device=generator.device) * 2.0 - 1.0
        return F.pad(points, (0, 1)).contiguous()

    # ------------------------------------------------------------------
    # alpha mask (JAX tensorf.py:123-164)
    # ------------------------------------------------------------------
    def compute_alpha(self, params, norm_coords: torch.Tensor, length: float,
                      gate_n: Optional[int] = None) -> torch.Tensor:
        sigma = feature2density(self.compute_density_feature_only(params, norm_coords, gate_n),
                                self.cfg)
        if self.alpha_mask is not None:
            gate = self.alpha_mask.sample_alpha(norm_coords, self.ops.alpha) > 0
            sigma = torch.where(gate, sigma, torch.zeros_like(sigma))
        return 1.0 - torch.exp(-sigma * length)

    @torch.no_grad()
    def get_dense_alpha(self, params, grid_size=None) -> torch.Tensor:
        """Alpha (Dx, Dy, Dz) over the dense normalized grid (the density
        lookup, and K9 where a mask is installed).  JAX computes one x-plane
        a call, so a line's hat gate counts Dy * Dz points."""
        gs = self.grid_size if grid_size is None else [int(g) for g in grid_size]
        dev = params["density_lines.0"].device
        return dense_alpha(lambda c: self.compute_alpha(params, c, self.step_size,
                                                        gs[1] * gs[2]), gs, dev)[0]

    @torch.no_grad()
    def update_alpha_mask(self, params, grid_size=None) -> np.ndarray:
        """Bake, dilate and threshold the occupancy volume; installs an
        ``AlphaGridMask`` and returns the tight aabb of occupied space in
        world coords (which the trainer ignores, as JAX's does; ``shrink``
        takes it)."""
        gs = self.grid_size if grid_size is None else [int(g) for g in grid_size]
        vol = bake_alpha_mask(self.get_dense_alpha(params, gs), self.cfg.alpha_mask_thres)
        self.alpha_mask = AlphaGridMask(vol, device=vol.device)
        occ = torch.nonzero(vol.permute(2, 1, 0)).cpu().numpy()  # (x, y, z) indices
        print(f"alpha rest %{len(occ) / np.prod(gs) * 100:.2f}")
        if len(occ) == 0:
            return self.aabb
        lo = occ.min(0) / (np.asarray(gs) - 1)
        hi = occ.max(0) / (np.asarray(gs) - 1)
        size = self.aabb[1] - self.aabb[0]
        return np.stack([self.aabb[0] + lo * size, self.aabb[0] + hi * size]).astype(np.float32)

    # ------------------------------------------------------------------
    # ray samplers (JAX tensorf.py:61-110)
    # ------------------------------------------------------------------
    def _box(self, device) -> torch.Tensor:
        t = self._aabb_t.get(device)
        if t is None:
            t = self._aabb_t[device] = torch.as_tensor(self.aabb, device=device)
        return t

    def _in_box(self, pts: torch.Tensor) -> torch.Tensor:
        box = self._box(pts.device)
        return ((pts >= box[0]) & (pts <= box[1])).all(dim=-1)

    def _box_rates(self, rays_o, rays_d):
        """The slab test's ray parameters at the box's two corners."""
        box = self._box(rays_o.device)
        vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
        return (box[1] - rays_o) / vec, (box[0] - rays_o) / vec

    def depths_uniform(self, rays_o, rays_d, n_samples: int, jitter=None) -> torch.Tensor:
        """(R, n) depths of :meth:`sample_ray`: uniform steps of
        ``step_size`` from the aabb entry (clipped to near/far)."""
        near, far = self.near_far
        rate_a, rate_b = self._box_rates(rays_o, rays_d)
        t_min = torch.minimum(rate_a, rate_b).amax(dim=-1).clamp(near, far)
        rng = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device).expand(
            rays_o.shape[0], n_samples)
        if jitter is not None:
            rng = rng + jitter
        return t_min[:, None] + self.step_size * rng

    def depths_ndc(self, rays_o, n_samples: int, jitter=None) -> torch.Tensor:
        """(R, n) depths of :meth:`sample_ray_ndc`."""
        near, far = self.near_far
        interpx = linspace(near, far, n_samples, rays_o.device).expand(rays_o.shape[0],
                                                                       n_samples)
        if jitter is not None:
            interpx = interpx + jitter * ((far - near) / n_samples)
        return interpx

    def depths_exp(self, rays_o, n_samples: int, jitter=None) -> torch.Tensor:
        """(R, n) depths of :meth:`sample_ray_exp`."""
        near, far = self.near_far
        ratio = 1.0 + pi / n_samples
        r0 = max((far - near) * (ratio - 1.0) / (ratio ** n_samples - 1.0), 0.002)
        rng = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device).expand(
            rays_o.shape[0], n_samples)
        if jitter is not None:
            rng = rng + jitter
        csum = torch.cumsum(r0 * torch.pow(ratio, rng), dim=-1)
        return near + torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=-1)

    def _points(self, rays_o, rays_d, z_vals):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        return pts, z_vals, self._in_box(pts)

    def sample_ray(self, rays_o, rays_d, n_samples: int, jitter=None):
        """Uniform steps of ``step_size`` from the aabb entry (clipped to
        near/far); ``jitter`` (R, n_samples) U(0, 1) moves each sample that
        far into its step.  Returns pts (R, n, 3), z (R, n), in_box (R, n)."""
        return self._points(rays_o, rays_d, self.depths_uniform(rays_o, rays_d, n_samples,
                                                                jitter))

    def sample_ray_ndc(self, rays_o, rays_d, n_samples: int, jitter=None):
        """NDC rays (JAX ``tensorf.py:79-91``): ``linspace(near, far, n)``
        (JAX's float32 arithmetic), each sample moved by ``jitter`` (R, n)
        U(0, 1) times (far - near) / n.  Returns pts, z, in_box."""
        return self._points(rays_o, rays_d, self.depths_ndc(rays_o, n_samples, jitter))

    def sample_ray_exp(self, rays_o, rays_d, n_samples: int, jitter=None):
        """Exponential steps with ratio 1 + pi / n from near."""
        return self._points(rays_o, rays_d, self.depths_exp(rays_o, n_samples, jitter))

    def _chart_kernel(self) -> bool:
        """Whether the chart runs through K7s: ``generic_sphere`` under
        ``interval_th``."""
        coords = self.coordinates
        return is_single_sphere(coords) and coords.exp_r and coords.interval_th

    def chart_coords(self, rays_o, rays_d, z_vals, pts=None) -> torch.Tensor:
        """(R, S, 4) normalized coords [a, b, c, 0] of the samples ``pts`` =
        rays_o + rays_d z_vals (formed here if not given): through K7s
        (``ops.chart_sphere``, which forms the points itself) where
        :meth:`_chart_kernel`, every other chart through its plain map (JAX
        ``tensorf.py:193,224``)."""
        coords = self.coordinates
        if self._chart_kernel():
            return self.ops.chart_sphere(rays_o, rays_d, z_vals, coords).reshape(
                *z_vals.shape, 4)
        if pts is None:
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        return F.pad(coords.normalize_coord(coords.from_cartesian(pts)), (0, 1))

    def sample_coords(self, rays_o, rays_d, z_vals):
        """The (R, S, 4) coords of the samples at ``z_vals`` and their (R, S)
        in-box mask: both from K7s's one launch where :meth:`_chart_kernel`
        (no points formed in torch), else the points, their plain chart and
        the samplers' ``in_box``."""
        if self._chart_kernel():
            norm, valid = self.ops.chart_sphere(rays_o, rays_d, z_vals, self.coordinates,
                                                self._box(rays_o.device))
            return norm.reshape(*z_vals.shape, 4), valid.reshape(z_vals.shape)
        pts, _, valid = self._points(rays_o, rays_d, z_vals)
        return self.chart_coords(rays_o, rays_d, z_vals, pts), valid

    # ------------------------------------------------------------------
    # ray filtering (JAX tensorf.py:166-195)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def filtering_rays(self, params, all_rays, all_rgbs, all_depths=None, n_samples=256,
                       chunk=10240 * 5, bbox_only=False):
        """The rays (N, 6+) that touch the box (``bbox_only`` or no mask:
        the slab test) or, with a mask, occupied space along their
        ``n_samples`` uniform samples (K9), computed in chunks of ``chunk``
        rays on the model's device; returns the kept host arrays (rays,
        rgbs and, given, depths) as JAX does.  ``params`` is unused, as in
        JAX (the mask holds what the test reads)."""
        all_rays = np.asarray(all_rays)
        n = all_rays.shape[0]
        masks = []
        for i in range(0, n, chunk):
            rays = torch.as_tensor(all_rays[i:i + chunk], dtype=torch.float32,
                                   device=self.device)
            masks.append(self._filter_chunk(rays, n_samples, bbox_only).cpu().numpy())
        mask = np.concatenate(masks) if masks else np.zeros(0, bool)
        print(f"ray filtering: kept {mask.sum()}/{n}")
        out = [all_rays[mask], np.asarray(all_rgbs)[mask]]
        if all_depths is not None:
            out.append(np.asarray(all_depths)[mask])
        return tuple(out)

    def _filter_chunk(self, rays, n_samples, bbox_only) -> torch.Tensor:
        rays_o, rays_d = rays[:, :3], rays[:, 3:6]
        if bbox_only or self.alpha_mask is None:
            rate_a, rate_b = self._box_rates(rays_o, rays_d)
            t_min = torch.minimum(rate_a, rate_b).amax(dim=-1)
            t_max = torch.maximum(rate_a, rate_b).amin(dim=-1)
            return t_max > t_min
        norm = self.chart_coords(rays_o, rays_d, self.depths_uniform(rays_o, rays_d, n_samples))
        return (self.alpha_mask.sample_alpha(norm, self.ops.alpha) > 0).any(dim=-1)

    # ------------------------------------------------------------------
    # forward (JAX tensorf.py:198-260)
    # ------------------------------------------------------------------
    def forward(self, params, rays: torch.Tensor, key: Optional[StepKey] = None,
                is_train=False, n_coarse=-1, n_fine=0, exp_sampling=False, resampling=False,
                use_coarse_sample=False, pretrain_envmap=False, white_bg=True, ndc_ray=False,
                eval_keep=0, tables: Optional[LookupTables] = None,
                jitter: Optional[torch.Tensor] = None, u=None, with_alpha: bool = False):
        """Render an (R, 6) ray batch with ``n_coarse`` samples a ray
        (``n_samples_auto`` if not positive); ``n_fine``, ``resampling``,
        ``use_coarse_sample`` and ``white_bg`` are accepted and unused, as
        in JAX.  Training (``is_train`` with a ``key``) jitters the depths;
        ``jitter`` (R, n) gives the draws explicitly.  ``ndc_ray`` marches
        [near, far] (:meth:`sample_ray_ndc`) with a zero last distance,
        distances scaled by |d| and the view directions normalised before
        the shader and the envmap (JAX ``tensorf.py:208-214``; only JAX's
        train step passes it, its renderer never).  Returns dict(rgb,
        depth, acc, bg, env), and alpha with ``with_alpha``, as
        ``EgoNeRF.forward``; rgb and alpha are differentiable in
        ``params``.  ``tables`` are :meth:`lookup_tables` for an eval
        render.  Eval callers run under ``torch.no_grad()``."""
        if eval_keep:
            raise NotImplementedError(f"the empty-space cull (eval_keep) on {self.name}, which "
                                      "the JAX package accepts and ignores (ROADMAP.md §3)")
        cfg = self.cfg
        rays_o, rays_d = rays[:, :3], rays[:, 3:6]
        viewdirs = rays_d
        if pretrain_envmap:
            if not cfg.use_envmap:
                raise ValueError("pretrain_envmap needs a model with the envmap")
            return {"env": envmap_radiance(params["envmap"], viewdirs, self.ops)}
        n = n_coarse if n_coarse > 0 else self.n_samples_auto
        n_rays = rays.shape[0]
        if is_train and key is not None and jitter is None:
            jitter = key.rand(n_rays, n, rays.device)

        with torch.no_grad():
            if ndc_ray:
                z_vals = self.depths_ndc(rays_o, n, jitter)
                norm_d = torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True)
                d = z_vals[:, 1:] - z_vals[:, :-1]
                dists = torch.cat([d, torch.zeros_like(d[:, :1])], dim=-1) * norm_d
                viewdirs = viewdirs / norm_d
            else:
                z_vals = (self.depths_exp(rays_o, n, jitter) if exp_sampling
                          else self.depths_uniform(rays_o, rays_d, n, jitter))
                dists = _dists(z_vals)
            # the lookups' coords with the flag of a single grid, and the
            # samples inside the box
            norm, valid = self.sample_coords(rays_o, rays_d, z_vals)
            if self.alpha_mask is not None:
                valid = valid & (self.alpha_mask.sample_alpha(norm, self.ops.alpha) > 0)

        feat, app_feat = self.compute_field(params, norm, tables)
        # the hoist hands MLP_Fea each ray's direction once
        dirs = (viewdirs if _HOIST_DIRS and self.shader.name == "MLP_Fea"
                else viewdirs[:, None, :].expand(n_rays, n, 3))
        rgb = self.shader.apply_params(params, "shader.", dirs, app_feat, self.ops,
                                       pts=norm[..., :3])
        env = (envmap_radiance(params["envmap"], viewdirs, self.ops) if cfg.use_envmap
               else None)
        outs = composite_train(
            feat, dists, z_vals, rgb, rays[:, -1].contiguous(), cfg.density_shift,
            cfg.distance_scale, cfg.fea2dense_act, self.ops.composite, self.ops.composite_bwd,
            env=env, valid=valid, rgb_thres=cfg.ray_march_weight_thres, with_alpha=with_alpha)
        out = {"rgb": outs[0], "depth": outs[1], "acc": outs[2],
               "bg": outs[4] if env is not None else None, "env": env}
        if with_alpha:
            out["alpha"] = with_background(outs[-1], cfg.use_envmap)
        return out

    vector_comp_diffs = EgoNeRF.vector_comp_diffs


class TensorVMSplit(TensorBase):
    """Per-axis plane + line VM decomposition (JAX ``tensorf.py:290-419``):
    each axis's density partial is rectified before the sum."""

    name = "TensorVMSplit"
    # VMSplit rectifies each axis's density partial; TensorVM sums them raw
    _density_relu = True

    def _make_params(self, grid_size) -> None:
        cfg = self.cfg
        self.density_planes, self.density_lines = self._grids(grid_size, cfg.density_n_comp)
        self.app_planes, self.app_lines = self._grids(grid_size, cfg.app_n_comp)
        self.basis = nn.Parameter(torch.zeros(int(sum(cfg.app_n_comp)), cfg.app_dim,
                                              device=self.device))

    def _grids(self, gs, n_comp):
        planes = nn.ParameterList([
            nn.Parameter(torch.zeros(1, gs[MAT_MODE[i][1]], gs[MAT_MODE[i][0]], n_comp[i],
                                     device=self.device)) for i in range(3)])
        return planes, self._lines(gs, n_comp)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> dict:
        """JAX's laws: planes and lines 0.1 * N(0, 1), basis
        U(-1/sqrt(n_app), +), the shader as ``nn.Linear``, the envmap
        U[0, 1); returns :meth:`params`."""
        for p in (*self.density_planes, *self.density_lines, *self.app_planes,
                  *self.app_lines):
            p.copy_(0.1 * torch.randn(p.shape, generator=generator, device=generator.device))
        bound = 1.0 / np.sqrt(self.basis.shape[0])
        u = torch.rand(self.basis.shape, generator=generator, device=generator.device)
        self.basis.copy_((u * 2.0 - 1.0) * bound)
        self.shader.reset_parameters(generator)
        if self.cfg.use_envmap:
            self.envmap.copy_(init_envmap(self.cfg.envmap_res_h, generator))
        return self.params()

    # JAX tensorf.py:386-397: the same resampling on the single grid
    upsample_params = EgoNeRF.upsample_params

    @torch.no_grad()
    def shrink(self, params, new_aabb):
        """Crop the planes and lines to ``new_aabb`` (JAX ``tensorf.py:
        399-419``): the normalized range scaled by the grid size, rounded,
        the far end one past it and within the grid; installs the crops as
        new parameters (rebuild the optimizer after), sets the aabb (also
        the chart's) and the step.  Returns (:meth:`params`, new grid
        size)."""
        lo_n, hi_n = self.coordinates.get_normalized_range(new_aabb)
        gs = np.asarray(self.grid_size)
        t_l = np.round(np.asarray(lo_n) * gs).astype(int)
        b_r = np.minimum(np.round(np.asarray(hi_n) * gs).astype(int) + 1, gs)
        for pk, lk in (("density_planes", "density_lines"), ("app_planes", "app_lines")):
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                v = VEC_MODE[i]
                getattr(self, lk)[i] = nn.Parameter(
                    params[f"{lk}.{i}"][:, t_l[v]:b_r[v], :].detach().contiguous())
                getattr(self, pk)[i] = nn.Parameter(
                    params[f"{pk}.{i}"][:, t_l[m1]:b_r[m1], t_l[m0]:b_r[m0], :]
                    .detach().contiguous())
        new_size = (b_r - t_l).tolist()
        self._set_aabb(new_aabb, new_size)
        return self.params(), new_size

    # ------------------------------------------------------------------
    # field lookups
    # ------------------------------------------------------------------
    fused_tables = EgoNeRF.fused_tables

    def lookup_tables(self, params) -> LookupTables:
        """The bf16 fused tables of ``params`` for an eval render (no coarse
        grid: the family has no coarse pass)."""
        planes, lines = self.fused_tables(params)
        return LookupTables(_bf16(planes), _bf16(lines), [], [])

    def compute_field(self, params, norm_coords: torch.Tensor,
                      tables: Optional[LookupTables] = None):
        """(..., 4) [x, y, z, 0] -> (density_feat (...,), app_feat (...,
        app_dim)): K1 on the single grid, then ``@ basis``.  With
        ``tables`` K1 reads them (eval); without, the lookup runs inside
        the autograd Function on the float32 fused tables (K2 backward)."""
        lead = norm_coords.shape[:-1]
        flat = norm_coords.reshape(-1, 4).contiguous()
        n_d = self.cfg.density_n_comp
        if tables is not None:
            dfeat, feats = self.ops.field(flat, tables.fine_planes, tables.fine_lines, n_d,
                                          self._line_hat(tables.fine_lines, flat.shape[0]),
                                          relu=self._density_relu)
        else:
            planes, lines = self.fused_tables(params)
            dfeat, feats = field_train(flat, planes, lines, n_d,
                                       self._line_hat(lines, flat.shape[0]),
                                       self.ops.field, self.ops.field_bwd, self._density_relu)
        app = torch.matmul(feats, params["basis"])
        return dfeat.reshape(lead), app.reshape(*lead, -1)

    def compute_density_feature_only(self, params, norm_coords: torch.Tensor,
                                     gate_n: Optional[int] = None) -> torch.Tensor:
        """(..., 4) -> (...,) sum_i relu(sum_c plane * line) (TensorVM: the
        raw sums) over the real density channels: K3 on the bf16 density
        tables (float32 line weights: no gate, ``gate_n`` unused)."""
        planes = _bf16(params[f"density_planes.{i}"] for i in range(3))
        lines = _bf16(params[f"density_lines.{i}"] for i in range(3))
        flat = norm_coords.reshape(-1, 4).contiguous()
        return self.ops.density(flat, planes, lines, relu=self._density_relu).reshape(
            norm_coords.shape[:-1])

    def sparsity_density(self, params, generator: Optional[torch.Generator], n_points: int,
                         points: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sigma at ``n_points`` random normalized coords of the grid, for
        the sparsity loss (JAX ``models/tensorf.py:284-287``): (n, 3)
        uniform in [-1, 1) drawn from ``generator`` (the step's, after the
        forward's draws), or the given (n, 3) ``points``.  The density is
        K3's training instantiation (TensorVM: its relu-free one) on the
        float32 density tables, differentiable in them through K2."""
        feat = density_train(self._sparsity_points(generator, n_points, points),
                             [params[f"density_planes.{i}"] for i in range(3)],
                             [params[f"density_lines.{i}"] for i in range(3)],
                             self.ops.density, self.ops.field_bwd, self._density_relu)
        return feature2density(feat, self.cfg)

    # ------------------------------------------------------------------
    # regularizers (JAX tensorf.py:262-287,369-383)
    # ------------------------------------------------------------------
    def density_l1(self, params) -> torch.Tensor:
        return sum(params[f"density_planes.{i}"].abs().mean()
                   + params[f"density_lines.{i}"].abs().mean() for i in range(3))

    def tv_loss_density(self, params) -> torch.Tensor:
        return sum(tv_plane(params[f"density_planes.{i}"]) * 1e-2 for i in range(3))

    def tv_loss_app(self, params) -> torch.Tensor:
        return sum(tv_plane(params[f"app_planes.{i}"]) * 1e-2 for i in range(3))


class TensorVM(TensorVMSplit):
    """TensorVMSplit whose density partials are summed raw, with no relu
    (JAX ``tensorf.py:422-431``: the reference fuses the planes across axes,
    which JAX, and so the port, stores per axis as for VMSplit).  Its K1, K2
    and K3 are their relu-free instantiations."""

    name = "TensorVM"
    _density_relu = False


def tv_line(line: torch.Tensor) -> torch.Tensor:
    """TensorCP's total variation of a (1, L, C) line, with JAX's 1e-3
    (``tensorf.py:495-509``)."""
    diff = ((line[:, 1:] - line[:, :-1]) ** 2).sum()
    return 2.0 * diff / ((line.shape[1] - 1) * line.shape[2]) * 1e-3


class TensorCP(TensorBase):
    """Rank-1 CP decomposition (JAX ``tensorf.py:434-535``): three lines a
    field and no plane; the field is the channel product of the three line
    samples (K17, K17b backward), the density its sum over the density
    channels with no relu, the appearance ``@ basis``.  A list of three
    component counts uses its first entry, as in JAX."""

    name = "TensorCP"

    def _make_params(self, grid_size) -> None:
        nd, na = self.cfg.density_n_comp[0], self.cfg.app_n_comp[0]
        self.density_lines = self._lines(grid_size, (nd,) * 3)
        self.app_lines = self._lines(grid_size, (na,) * 3)
        self.basis = nn.Parameter(torch.zeros(na, self.cfg.app_dim, device=self.device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> dict:
        """JAX's laws: lines 0.2 * N(0, 1), basis U(-1/sqrt(n_app), +), the
        shader as ``nn.Linear``, the envmap U[0, 1); returns :meth:`params`."""
        for p in (*self.density_lines, *self.app_lines):
            p.copy_(0.2 * torch.randn(p.shape, generator=generator, device=generator.device))
        bound = 1.0 / np.sqrt(self.basis.shape[0])
        u = torch.rand(self.basis.shape, generator=generator, device=generator.device)
        self.basis.copy_((u * 2.0 - 1.0) * bound)
        self.shader.reset_parameters(generator)
        if self.cfg.use_envmap:
            self.envmap.copy_(init_envmap(self.cfg.envmap_res_h, generator))
        return self.params()

    @torch.no_grad()
    def upsample_params(self, params, res_target) -> dict:
        """Resample every line onto ``res_target`` (JAX ``tensorf.py:
        511-517``) and install them as the parameters; returns :meth:`params`."""
        for lk in ("density_lines", "app_lines"):
            for i in range(3):
                getattr(self, lk)[i] = nn.Parameter(self.coordinates.up_sampling_VM(
                    params[f"{lk}.{i}"], res_target, ids=[VEC_MODE[i]]).contiguous())
        return self.params()

    @torch.no_grad()
    def shrink(self, params, new_aabb):
        """Crop the lines to ``new_aabb`` as JAX's CP does (``tensorf.py:
        519-535``): the normalized range scaled by grid size - 1, not the
        grid size (the reference's quirk, kept), rounded, the far end one
        past it and within the grid.  Installs the crops, sets the aabb and
        the step; returns (:meth:`params`, new grid size)."""
        lo_n, hi_n = self.coordinates.get_normalized_range(new_aabb)
        gs = np.asarray(self.grid_size)
        t_l = np.round(np.asarray(lo_n) * (gs - 1)).astype(int)
        b_r = np.minimum(np.round(np.asarray(hi_n) * (gs - 1)).astype(int) + 1, gs)
        for lk in ("density_lines", "app_lines"):
            for i in range(3):
                v = VEC_MODE[i]
                getattr(self, lk)[i] = nn.Parameter(
                    params[f"{lk}.{i}"][:, t_l[v]:b_r[v], :].detach().contiguous())
        new_size = (b_r - t_l).tolist()
        self._set_aabb(new_aabb, new_size)
        return self.params(), new_size

    # ------------------------------------------------------------------
    # field lookups
    # ------------------------------------------------------------------
    def fused_lines(self, params):
        """The float32 density + appearance lines fused per axis, (1, L_i,
        n_density + n_app): both share the axis's coordinate and mode."""
        return [torch.cat([params[f"density_lines.{i}"], params[f"app_lines.{i}"]], dim=-1)
                for i in range(3)]

    def lookup_tables(self, params) -> LookupTables:
        """The bf16 fused lines of ``params`` for an eval render."""
        return LookupTables([], _bf16(self.fused_lines(params)), [], [])

    def compute_field(self, params, norm_coords: torch.Tensor,
                      tables: Optional[LookupTables] = None):
        """(..., 4) -> (density_feat (...,), app_feat (..., app_dim)): K17 on
        the fused lines (the bf16 ``tables`` at eval; in training the
        float32 lines inside the autograd Function, K17b backward), then
        ``@ basis``."""
        lead = norm_coords.shape[:-1]
        flat = norm_coords.reshape(-1, 4).contiguous()
        nd = self.cfg.density_n_comp[0]
        if tables is not None:
            lines = tables.fine_lines
            dfeat, feats = self.ops.cp(flat, lines, nd, self._line_hat(lines, flat.shape[0]))
        else:
            lines = self.fused_lines(params)
            dfeat, feats = cp_train(flat, lines, nd, self._line_hat(lines, flat.shape[0]),
                                    self.ops.cp, self.ops.cp_bwd)
        app = torch.matmul(feats, params["basis"])
        return dfeat.reshape(lead), app.reshape(*lead, -1)

    def compute_density_feature_only(self, params, norm_coords: torch.Tensor,
                                     gate_n: Optional[int] = None) -> torch.Tensor:
        """(..., 4) -> (...,) the density sum: K17's density-only form on
        the float32 density lines (read as bf16), in the line modes of
        JAX's call of ``gate_n`` points (by default these): CP's density
        takes the hat under bf16, where VMSplit's takes float32 weights."""
        lines = [params[f"density_lines.{i}"].detach() for i in range(3)]
        flat = norm_coords.reshape(-1, 4).contiguous()
        modes = self._line_hat(lines, flat.shape[0] if gate_n is None else gate_n)
        return self.ops.cp(flat, lines, lines[0].shape[-1], modes)[0].reshape(
            norm_coords.shape[:-1])

    def sparsity_density(self, params, generator: Optional[torch.Generator], n_points: int,
                         points: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sigma at ``n_points`` random normalized coords (or the given (n,
        3) ``points``), for the sparsity loss: K17's density-only form on
        the float32 density lines, differentiable through K17b."""
        coords = self._sparsity_points(generator, n_points, points)
        lines = [params[f"density_lines.{i}"] for i in range(3)]
        feat, _ = cp_train(coords, lines, lines[0].shape[-1],
                           self._line_hat(lines, coords.shape[0]), self.ops.cp, self.ops.cp_bwd)
        return feature2density(feat, self.cfg)

    # ------------------------------------------------------------------
    # regularizers (JAX tensorf.py:489-509)
    # ------------------------------------------------------------------
    def density_l1(self, params) -> torch.Tensor:
        return sum(params[f"density_lines.{i}"].abs().mean() for i in range(3))

    def tv_loss_density(self, params) -> torch.Tensor:
        return sum(tv_line(params[f"density_lines.{i}"]) for i in range(3))

    def tv_loss_app(self, params) -> torch.Tensor:
        return sum(tv_line(params[f"app_lines.{i}"]) for i in range(3))
