"""TensorVMSplit, the TensoRF family's main member: a single Cartesian grid
with a per-axis plane+line VM decomposition (counterpart of
``egonerf_tpu/models/tensorf.py``: ``TensorBase`` + ``TensorVMSplit``).

The parameters keep the JAX layout at the module's public functions:
planes (1, H, W, C), lines (1, L, C), basis (sum(app_n_comp), app_dim),
under ``state_dict`` names as for EgoNeRF.  The lookups are EgoNeRF's
kernels on a stack of one grid: K1 (fine density + appearance, K2
backward) and K3 (density alone, for the bake).  Samples march uniformly
from the aabb entry, ``step_size`` apart; K9 gates them with the alpha
mask once one is baked; the composite (K6, K6b backward) zeroes sigma
outside the box and the mask, and rgb where the weight is not above
``ray_march_weight_thres``.  TensorVM, TensorCP, ``shrink``, ray filtering
and NDC rays wait (ROADMAP.md §1).  Of the JAX module's opt-in forms the
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
from ..coords.cartesian import CartesianCoords
from ..ops import KERNELS
from ..ops.vm_lookup import LINE_HAT as _LINE_HAT
from ..ops.vm_lookup import (HAT, LINEAR, MAT_MODE, VEC_MODE, density_train, field_train,
                             line_hat_ok)
from ..ops.volrend import composite_train
from .alphamask import AlphaGridMask, bake_alpha_mask, dense_alpha
from .egonerf import (EgoNeRF, LookupTables, StepKey, _bf16, _dists, feature2density, tv_plane,
                      with_background)
from .envmap import envmap_radiance, init_envmap
from .shading import _HOIST_DIRS, MLPFea

_LATER = "is not ported yet (ROADMAP.md §1)"


class TensorVMSplit(nn.Module):
    name = "TensorVMSplit"

    def __init__(self, aabb, grid_size, coordinates: CartesianCoords, cfg, near_far=(2.0, 6.0),
                 device="cuda"):
        super().__init__()
        if not isinstance(coordinates, CartesianCoords):
            raise NotImplementedError(f"TensorVMSplit on the {coordinates.name!r} chart {_LATER}")
        if cfg.shading_mode != "MLP_Fea":
            raise NotImplementedError(f"shading mode {cfg.shading_mode!r} {_LATER}")
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
        self.density_planes, self.density_lines = self._grids(grid_size, cfg.density_n_comp)
        self.app_planes, self.app_lines = self._grids(grid_size, cfg.app_n_comp)
        self.basis = nn.Parameter(torch.zeros(int(sum(cfg.app_n_comp)), cfg.app_dim,
                                              device=self.device))
        self.shader = MLPFea(cfg.app_dim, cfg.view_pe, cfg.fea_pe,
                             cfg.feature_c).to(self.device)
        if cfg.use_envmap:
            self.envmap = nn.Parameter(init_envmap(cfg.envmap_res_h, init_strategy="zero",
                                                   device=self.device))
        self.update_step_size(grid_size)

    def _grids(self, gs, n_comp):
        planes = nn.ParameterList([
            nn.Parameter(torch.zeros(1, gs[MAT_MODE[i][1]], gs[MAT_MODE[i][0]], n_comp[i],
                                     device=self.device)) for i in range(3)])
        lines = nn.ParameterList([
            nn.Parameter(torch.zeros(1, gs[VEC_MODE[i]], n_comp[i], device=self.device))
            for i in range(3)])
        return planes, lines

    def update_step_size(self, grid_size) -> None:
        """Grid bookkeeping (JAX ``tensorf.py:52-58``): the march step is
        the mean grid unit times ``step_ratio``, so each upsample shortens
        the ray's reach."""
        self.grid_size = [int(g) for g in grid_size]
        aabb_size = self.aabb[1] - self.aabb[0]
        self.step_size = float(np.mean(aabb_size / (np.asarray(self.grid_size) - 1))
                               * self.cfg.step_ratio)
        self.n_samples_auto = int(float(np.linalg.norm(aabb_size) / 2.0) / self.step_size) + 1

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    params = EgoNeRF.params

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

    # ------------------------------------------------------------------
    # field lookups
    # ------------------------------------------------------------------
    fused_tables = EgoNeRF.fused_tables

    def _line_hat(self, lines, n: int):
        """Each line's mode: the hat path under bf16 compute while its gate
        holds, else float32 weights (JAX's ``sample_line_packed``, also
        under ``EGONERF_LINE_HAT=0``)."""
        hat = self.cfg.compute_dtype == "bfloat16" and _LINE_HAT
        return [HAT if hat and line_hat_ok(l.shape[0] * l.shape[1], n) else LINEAR
                for l in lines]

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
                                          self._line_hat(tables.fine_lines, flat.shape[0]))
        else:
            planes, lines = self.fused_tables(params)
            dfeat, feats = field_train(flat, planes, lines, n_d,
                                       self._line_hat(lines, flat.shape[0]),
                                       self.ops.field, self.ops.field_bwd)
        app = torch.matmul(feats, params["basis"])
        return dfeat.reshape(lead), app.reshape(*lead, -1)

    def compute_density_feature_only(self, params, norm_coords: torch.Tensor) -> torch.Tensor:
        """(..., 4) -> (...,) sum_i relu(sum_c plane * line) over the real
        density channels: K3 on the bf16 density tables."""
        planes = _bf16(params[f"density_planes.{i}"] for i in range(3))
        lines = _bf16(params[f"density_lines.{i}"] for i in range(3))
        flat = norm_coords.reshape(-1, 4).contiguous()
        return self.ops.density(flat, planes, lines).reshape(norm_coords.shape[:-1])

    def sparsity_density(self, params, generator: Optional[torch.Generator], n_points: int,
                         points: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sigma at ``n_points`` random normalized coords of the grid, for
        the sparsity loss (JAX ``models/tensorf.py:284-287``): (n, 3)
        uniform in [-1, 1) drawn from ``generator`` (the step's, after the
        forward's draws), or the given (n, 3) ``points``.  The density is
        K3's training instantiation on the float32 density tables,
        differentiable in them through K2."""
        if points is None:
            points = torch.rand(n_points, 3, generator=generator,
                                device=generator.device) * 2.0 - 1.0
        feat = density_train(F.pad(points, (0, 1)).contiguous(),
                             [params[f"density_planes.{i}"] for i in range(3)],
                             [params[f"density_lines.{i}"] for i in range(3)],
                             self.ops.density, self.ops.field_bwd)
        return feature2density(feat, self.cfg)

    # ------------------------------------------------------------------
    # alpha mask (JAX tensorf.py:123-164)
    # ------------------------------------------------------------------
    def compute_alpha(self, params, norm_coords: torch.Tensor, length: float) -> torch.Tensor:
        sigma = feature2density(self.compute_density_feature_only(params, norm_coords), self.cfg)
        if self.alpha_mask is not None:
            gate = self.alpha_mask.sample_alpha(norm_coords, self.ops.alpha) > 0
            sigma = torch.where(gate, sigma, torch.zeros_like(sigma))
        return 1.0 - torch.exp(-sigma * length)

    @torch.no_grad()
    def get_dense_alpha(self, params, grid_size=None) -> torch.Tensor:
        """Alpha (Dx, Dy, Dz) over the dense normalized grid (K3, and K9
        where a mask is installed)."""
        gs = self.grid_size if grid_size is None else [int(g) for g in grid_size]
        dev = params["density_planes.0"].device
        return dense_alpha(lambda c: self.compute_alpha(params, c, self.step_size), gs, dev)[0]

    @torch.no_grad()
    def update_alpha_mask(self, params, grid_size=None) -> np.ndarray:
        """Bake, dilate and threshold the occupancy volume; installs an
        ``AlphaGridMask`` and returns the tight aabb of occupied space in
        world coords (which the trainer ignores, as JAX's does)."""
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

    def sample_ray(self, rays_o, rays_d, n_samples: int, jitter=None):
        """Uniform steps of ``step_size`` from the aabb entry (clipped to
        near/far); ``jitter`` (R, n_samples) U(0, 1) moves each sample that
        far into its step.  Returns pts (R, n, 3), z (R, n), in_box (R, n)."""
        near, far = self.near_far
        box = self._box(rays_o.device)
        vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
        rate_a = (box[1] - rays_o) / vec
        rate_b = (box[0] - rays_o) / vec
        t_min = torch.minimum(rate_a, rate_b).amax(dim=-1).clamp(near, far)
        rng = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device).expand(
            rays_o.shape[0], n_samples)
        if jitter is not None:
            rng = rng + jitter
        interpx = t_min[:, None] + self.step_size * rng
        pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
        return pts, interpx, self._in_box(pts)

    def sample_ray_exp(self, rays_o, rays_d, n_samples: int, jitter=None):
        """Exponential steps with ratio 1 + pi / n from near."""
        near, far = self.near_far
        ratio = 1.0 + pi / n_samples
        r0 = max((far - near) * (ratio - 1.0) / (ratio ** n_samples - 1.0), 0.002)
        rng = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device).expand(
            rays_o.shape[0], n_samples)
        if jitter is not None:
            rng = rng + jitter
        csum = torch.cumsum(r0 * torch.pow(ratio, rng), dim=-1)
        interpx = near + torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=-1)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
        return pts, interpx, self._in_box(pts)

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
        ``jitter`` (R, n) gives the draws explicitly.  Returns dict(rgb,
        depth, acc, bg, env), and alpha with ``with_alpha``, as
        ``EgoNeRF.forward``; rgb and alpha are differentiable in
        ``params``.  ``tables`` are :meth:`lookup_tables` for an eval
        render.  Eval callers run under ``torch.no_grad()``."""
        if ndc_ray:
            raise NotImplementedError(f"NDC rays {_LATER}")
        if eval_keep:
            raise NotImplementedError("the empty-space cull (eval_keep) on TensorVMSplit, which "
                                      "the JAX package accepts and ignores (ROADMAP.md §3)")
        cfg = self.cfg
        rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
        if pretrain_envmap:
            if not cfg.use_envmap:
                raise ValueError("pretrain_envmap needs a model with the envmap")
            return {"env": envmap_radiance(params["envmap"], viewdirs, self.ops)}
        n = n_coarse if n_coarse > 0 else self.n_samples_auto
        n_rays = rays.shape[0]
        if is_train and key is not None and jitter is None:
            jitter = torch.rand(n_rays, n, generator=key.generator, device=rays.device)

        with torch.no_grad():
            sampler = self.sample_ray_exp if exp_sampling else self.sample_ray
            pts, z_vals, valid = sampler(rays_o, viewdirs, n, jitter)
            dists = _dists(z_vals)
            coords = self.coordinates
            # (x, y, z, 0): the lookups' coords with the flag of a single grid
            norm = F.pad(coords.normalize_coord(coords.from_cartesian(pts)), (0, 1))
            if self.alpha_mask is not None:
                valid = valid & (self.alpha_mask.sample_alpha(norm, self.ops.alpha) > 0)

        feat, app_feat = self.compute_field(params, norm, tables)
        # the hoist hands the shader each ray's direction once
        dirs = viewdirs if _HOIST_DIRS else viewdirs[:, None, :].expand(n_rays, n, 3)
        rgb = self.shader.apply_params(params, "shader.", dirs, app_feat, self.ops)
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

    # ------------------------------------------------------------------
    # regularizers (JAX tensorf.py:262-287,369-383)
    # ------------------------------------------------------------------
    vector_comp_diffs = EgoNeRF.vector_comp_diffs

    def density_l1(self, params) -> torch.Tensor:
        return sum(params[f"density_planes.{i}"].abs().mean()
                   + params[f"density_lines.{i}"].abs().mean() for i in range(3))

    def tv_loss_density(self, params) -> torch.Tensor:
        return sum(tv_plane(params[f"density_planes.{i}"]) * 1e-2 for i in range(3))

    def tv_loss_app(self, params) -> torch.Tensor:
        return sum(tv_plane(params[f"app_planes.{i}"]) * 1e-2 for i in range(3))
