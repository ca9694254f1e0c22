"""EgoNeRF: the yin-yang dual-grid VM-factorized radiance field
(counterpart of ``egonerf_tpu/models/egonerf.py``), the eval and the
training forward.

The module's parameters keep the JAX layout at its public functions:
planes (2, H, W, C), lines (2, L, C), basis (2, sum(app_n_comp), app_dim),
with the leading axis the yin/yang stack.  Functions take a ``params``
mapping in ``state_dict`` naming (``density_planes.0``, ``basis``,
``shader.l1.weight``, ...); :meth:`EgoNeRF.params` is the module's own.

The lookup tables are read in bf16, as the JAX forward reads them;
:meth:`EgoNeRF.lookup_tables` builds them (and the half-resolution coarse
grid) once per render, where JAX rebuilds them per chunk with the same
numbers.  In training the fine field goes through the autograd Function
of ``ops.vm_lookup.field_train`` (K1 forward, K2 backward) on the float32
fused tables, and the composite through ``ops.volrend.composite_train``
(K6, K6b).  Both charts of a forward, the coarse and the fine, are K7.
With ``use_envmap`` the (2h, h, 3) ``envmap`` parameter gives each ray its
background radiance (K8, K8b backward), blended behind the last sample.
The kernels come from ``self.ops`` (``ops.KERNELS``).
"""
from __future__ import annotations

import dataclasses
from math import pi
from typing import List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .._device import full_f32_matmul, resolve_device
from ..coords.expgrid import make_sample_r_grid
from ..coords.yinyang import YinYangSphericalCoords
from ..ops import KERNELS
from ..ops.vm_lookup import MAT_MODE, VEC_MODE, field_train, line_hat_ok
from ..ops.volrend import composite_train, density_activation
from .envmap import envmap_radiance, init_envmap
from .shading import MLPFea

_LATER = "is not ported yet (ROADMAP.md §1)"


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static model hyperparameters: the fields of the JAX ``FieldConfig``
    that the render and training paths read (the alpha-mask, ray-march and
    linear-sampling fields come with their slices; checkpoints carry them
    through ``model_meta``)."""
    density_n_comp: Sequence[int] = (16, 16, 16)
    app_n_comp: Sequence[int] = (48, 48, 48)
    app_dim: int = 27
    shading_mode: str = "MLP_Fea"
    view_pe: int = 2
    fea_pe: int = 2
    feature_c: int = 128
    density_shift: float = -8.0
    distance_scale: float = 25.0
    fea2dense_act: str = "softplus"
    use_envmap: bool = False
    envmap_res_h: int = 1000
    # 'bfloat16': the fine line lookup takes the bf16 hat weights while the
    # JAX gate holds; 'float32': float32 line weights.  Tables are bf16
    # either way, as in JAX.
    compute_dtype: str = "bfloat16"

    @classmethod
    def from_meta(cls, meta: Mapping) -> "FieldConfig":
        """The fields of a checkpoint's ``model_meta`` (which also holds
        JAX-only fields and the model name)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in meta.items() if k in fields}
        return cls(**{**kw, "density_n_comp": tuple(kw["density_n_comp"]),
                      "app_n_comp": tuple(kw["app_n_comp"])})


def feature2density(feat: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    return density_activation(feat, cfg.density_shift, cfg.fea2dense_act)


def _avg_pool_plane(p: torch.Tensor) -> torch.Tensor:
    """(S, H, W, C) -> (S, H//2, W//2, C), mean over 2x2 stride 2."""
    s, h, w, c = p.shape
    p = p[:, : (h // 2) * 2, : (w // 2) * 2, :]
    return p.reshape(s, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _avg_pool_line(l: torch.Tensor) -> torch.Tensor:
    """(S, L, C) -> (S, L//2, C), mean over 2 stride 2."""
    s, n, c = l.shape
    l = l[:, : (n // 2) * 2, :]
    return l.reshape(s, n // 2, 2, c).mean(dim=2)


def _bf16(ts) -> List[torch.Tensor]:
    return [t.detach().to(torch.bfloat16).contiguous() for t in ts]


def _dists(z: torch.Tensor) -> torch.Tensor:
    d = z[..., 1:] - z[..., :-1]
    return torch.cat([d, d[..., -1:]], dim=-1)


class StepKey(NamedTuple):
    """The random draws of one training step (the JAX ``key``): the
    device-side generator of the coarse jitter, and the (seed, step) key of
    K5's counter-based generator."""
    generator: torch.Generator
    seed: int
    step: int


class LookupTables(NamedTuple):
    """bf16 tables of one parameter set: the fine density+appearance planes
    and lines fused per decomposition, and the derived coarse grid."""
    fine_planes: List[torch.Tensor]
    fine_lines: List[torch.Tensor]
    coarse_planes: List[torch.Tensor]
    coarse_lines: List[torch.Tensor]


class EgoNeRF(nn.Module):
    name = "EgoNeRF"

    def __init__(self, aabb, grid_size, coordinates: YinYangSphericalCoords,
                 cfg: FieldConfig, near_far=(0.01, 15.0), device="cuda"):
        super().__init__()
        if not isinstance(coordinates, YinYangSphericalCoords):
            raise TypeError("EgoNeRF requires the yin-yang chart")
        if cfg.shading_mode != "MLP_Fea":
            raise NotImplementedError(f"shading mode {cfg.shading_mode!r} {_LATER}")
        if cfg.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.device = resolve_device(device)
        # full float32 matmuls on the card: the JAX reference is full f32
        full_f32_matmul()
        self.aabb = np.asarray(aabb, np.float32).reshape(2, 3)
        self.coordinates = coordinates
        self.cfg = cfg
        self.near_far = (float(near_far[0]), float(near_far[1]))
        self.ops = KERNELS
        self._sample_grid_cache: dict = {}
        self.grid_size = gs = [int(g) for g in grid_size]

        def planes(n_comp):
            return nn.ParameterList([
                nn.Parameter(torch.zeros(2, gs[MAT_MODE[i][1]], gs[MAT_MODE[i][0]],
                                         n_comp[i], device=self.device))
                for i in range(3)])

        def lines(n_comp):
            return nn.ParameterList([
                nn.Parameter(torch.zeros(2, gs[VEC_MODE[i]], n_comp[i], device=self.device))
                for i in range(3)])

        self.density_planes = planes(cfg.density_n_comp)
        self.density_lines = lines(cfg.density_n_comp)
        self.app_planes = planes(cfg.app_n_comp)
        self.app_lines = lines(cfg.app_n_comp)
        self.basis = nn.Parameter(torch.zeros(2, int(sum(cfg.app_n_comp)), cfg.app_dim,
                                              device=self.device))
        self.shader = MLPFea(cfg.app_dim, cfg.view_pe, cfg.fea_pe,
                             cfg.feature_c).to(self.device)
        if cfg.use_envmap:
            self.envmap = nn.Parameter(init_envmap(cfg.envmap_res_h, init_strategy="zero",
                                                   device=self.device))

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def params(self) -> dict:
        """The module's own parameters as a ``state_dict``-named mapping."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> dict:
        """Draw every parameter with the JAX init's laws (planes and lines
        0.1 * N(0, 1), basis U(-1/sqrt(n_app), +), the shader as
        ``nn.Linear``, the envmap U[0, 1)) from ``generator``; returns
        :meth:`params`."""
        def normal(p, scale):
            z = torch.randn(p.shape, generator=generator, device=generator.device)
            p.copy_(scale * z)

        for planes, lines in ((self.density_planes, self.density_lines),
                              (self.app_planes, self.app_lines)):
            for i in range(3):
                normal(planes[i], 0.1)
                normal(lines[i], 0.1)
        bound = 1.0 / np.sqrt(self.basis.shape[1])
        u = torch.rand(self.basis.shape, generator=generator, device=generator.device)
        self.basis.copy_((u * 2.0 - 1.0) * bound)
        self.shader.reset_parameters(generator)
        if self.cfg.use_envmap:
            self.envmap.copy_(init_envmap(self.cfg.envmap_res_h, generator))
        return self.params()

    # ------------------------------------------------------------------
    # field lookups
    # ------------------------------------------------------------------
    def derive_coarse(self, params: Mapping[str, torch.Tensor]):
        """The half-resolution density grid: 2x2 and x2 average pools of the
        fine density planes and lines, detached (the reference's 'conv'
        rule)."""
        planes = [_avg_pool_plane(params[f"density_planes.{i}"].detach()) for i in range(3)]
        lines = [_avg_pool_line(params[f"density_lines.{i}"].detach()) for i in range(3)]
        return planes, lines

    def fused_tables(self, params: Mapping[str, torch.Tensor]):
        """The float32 density+appearance planes and lines fused per
        decomposition, as JAX's ``_fused_products`` concatenates them."""
        planes = [torch.cat([params[f"density_planes.{i}"], params[f"app_planes.{i}"]], dim=-1)
                  for i in range(3)]
        lines = [torch.cat([params[f"density_lines.{i}"], params[f"app_lines.{i}"]], dim=-1)
                 for i in range(3)]
        return planes, lines

    def coarse_tables(self, params: Mapping[str, torch.Tensor]):
        """The bf16 half-resolution coarse grid."""
        c_planes, c_lines = self.derive_coarse(params)
        return _bf16(c_planes), _bf16(c_lines)

    def lookup_tables(self, params: Mapping[str, torch.Tensor]) -> LookupTables:
        fine_planes, fine_lines = self.fused_tables(params)
        return LookupTables(_bf16(fine_planes), _bf16(fine_lines), *self.coarse_tables(params))

    def _line_hat(self, lines, n: int):
        return [self.cfg.compute_dtype == "bfloat16" and line_hat_ok(l.shape[0] * l.shape[1], n)
                for l in lines]

    def compute_field(self, params, norm_coords: torch.Tensor,
                      tables: Optional[LookupTables] = None):
        """(..., 4) -> (density_feat (...,), app_feat (..., app_dim)): K1,
        then the per-chart basis matmul.  With ``tables`` K1 reads the
        prepared bf16 tables (eval); without, it runs inside the autograd
        Function on the float32 fused tables, so density and appearance are
        differentiable in every parameter (K2 backward)."""
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
        basis = params["basis"]
        yin = feats @ basis[0]
        yang = feats @ basis[1]
        app = torch.where(flat[:, 3:4] == 0, yin, yang)
        return dfeat.reshape(lead), app.reshape(*lead, -1)

    def compute_density_feature(self, planes, lines, norm_coords: torch.Tensor) -> torch.Tensor:
        """(..., 4) -> (...,) raw density sum_i relu(sum_c plane*line) on
        the float32 ``planes`` and ``lines`` (read as bf16): K3."""
        return self._density(_bf16(planes), _bf16(lines), norm_coords)

    def _density(self, planes, lines, norm_coords):
        flat = norm_coords.reshape(-1, 4).contiguous()
        return self.ops.density(flat, planes, lines).reshape(norm_coords.shape[:-1])

    # ------------------------------------------------------------------
    # ray sampling
    # ------------------------------------------------------------------
    def _base_sample_grid(self, n_samples: int, device) -> torch.Tensor:
        key = (n_samples, device)
        grid = self._sample_grid_cache.get(key)
        if grid is None:
            near, far = self.near_far
            grid = torch.as_tensor(
                make_sample_r_grid(self.coordinates.r0, far - near, n_samples), device=device)
            self._sample_grid_cache[key] = grid
        return grid

    def sample_depths_exp(self, n_rays: int, n_samples: int, dev,
                          jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n_rays, n_samples) exponentially spaced depths (the ``interpx``
        of JAX's ``sample_ray_exp``; K7 makes the points); with ``jitter``
        (R, n_samples) U(0, 1) draws, each depth moves that far into its
        interval (training)."""
        near, far = self.near_far
        if self.coordinates.interval_th:
            base = self._base_sample_grid(n_samples, dev)
            r = base.expand(n_rays, n_samples)
            if jitter is not None:
                interval = _dists(base)
                r = r + interval[None] * jitter
            interpx = near + r
        else:
            ratio = 1.0 + (pi / 2.0) / n_samples
            r0 = (far - near) * (ratio - 1.0) / (ratio ** n_samples - 1.0)
            rng = torch.arange(n_samples, dtype=torch.float32, device=dev).expand(n_rays,
                                                                                 n_samples)
            if jitter is not None:
                rng = rng + jitter
            steps = r0 * torch.pow(ratio, rng)
            csum = torch.cumsum(steps, dim=-1)
            interpx = near + torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=-1)
        return interpx

    def sample_ray_linear(self, rays_o, rays_d, n_samples: int):
        raise NotImplementedError(f"linear ray sampling {_LATER}")

    def update_alpha_mask(self, params, grid_size=None):
        raise NotImplementedError(f"the alpha mask {_LATER}")

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, params, rays: torch.Tensor, key: Optional[StepKey] = None,
                is_train=False, n_coarse=128, n_fine=128, exp_sampling=True, resampling=True,
                use_coarse_sample=True, pretrain_envmap=False, white_bg=True,
                ndc_ray=False, eval_keep=0, tables: Optional[LookupTables] = None,
                jitter: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None):
        """Render an (R, 6) ray batch.  Returns dict(rgb (R, 3), depth (R,),
        acc (R,), bg, env); with the envmap, env (R, 3) is each ray's
        background radiance and bg (R, 3) = its transmittance times env,
        else both are None.  ``pretrain_envmap`` returns dict(env) alone,
        the envmap's radiance (its pretrain phase).  ``white_bg`` is
        accepted and unused, as in JAX.

        Training (``is_train`` with a ``key``) jitters the coarse depths and
        draws K4's ``u`` from K5; ``jitter`` (R, n_coarse) and ``u``
        (R, n_fine, sorted) give those draws explicitly instead.  Without
        draws the depths are the eval ones.  rgb is differentiable in
        ``params``; depth and acc are not (JAX stops depth's gradient).
        ``tables`` are :meth:`lookup_tables` of ``params`` for an eval
        render; without them the fine field runs through its autograd
        Function.  Eval callers run under ``torch.no_grad()``."""
        if ndc_ray:
            raise NotImplementedError("NDC rays are not supported by the egocentric model")
        cfg = self.cfg
        rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
        if pretrain_envmap:
            if not cfg.use_envmap:
                raise ValueError("pretrain_envmap needs a model with the envmap")
            return {"env": envmap_radiance(params["envmap"], viewdirs, self.ops)}
        if eval_keep:
            raise NotImplementedError(f"the empty-space cull {_LATER}")
        coords = self.coordinates
        n_rays, dev = rays.shape[0], rays.device
        if is_train and key is not None:
            if jitter is None:
                jitter = torch.rand(n_rays, n_coarse, generator=key.generator, device=dev)
            if u is None and resampling:
                u = self.ops.sorted_uniform(n_rays, n_fine, key.seed, key.step, dev)

        with torch.no_grad():
            # 1) coarse depths
            if not exp_sampling:
                self.sample_ray_linear(rays_o, viewdirs, n_coarse)
            coarse_z = self.sample_depths_exp(n_rays, n_coarse, dev, jitter)
            coarse_dists = _dists(coarse_z)

            # 2) coarse chart + half-res normalization (K7)
            coarse_norm = self.ops.chart(rays_o, viewdirs, coarse_z, coords,
                                         2).reshape(n_rays, n_coarse, 4)

            if resampling:
                # 3) coarse density (K3) on the detached grid -> weights,
                # inverse CDF at u, merge (K4)
                c_planes, c_lines = (self.coarse_tables(params) if tables is None
                                     else (tables.coarse_planes, tables.coarse_lines))
                c_feat = self._density(c_planes, c_lines, coarse_norm)
                z_vals, dists = self.ops.resample(
                    c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample,
                    cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
                norm = self.ops.chart(rays_o, viewdirs, z_vals, coords).reshape(
                    n_rays, z_vals.shape[1], 4)
            else:
                z_vals, dists, norm = coarse_z, coarse_dists, coarse_norm

        # 4) fine field (K1, K2 backward) + shading
        feat, app_feat = self.compute_field(params, norm, tables)
        dirs = viewdirs[:, None, :].expand(*norm.shape[:-1], 3)
        rgb = self.shader.apply_params(params, "shader.", dirs, app_feat)

        # 5) the envmap's radiance (K8, K8b backward), then the composite with
        # the background as a last sample of alpha 1 (K6, K6b backward)
        env = (envmap_radiance(params["envmap"], viewdirs, self.ops) if cfg.use_envmap
               else None)
        outs = composite_train(
            feat, dists, z_vals, rgb, rays[:, -1].contiguous(), cfg.density_shift,
            cfg.distance_scale, cfg.fea2dense_act, self.ops.composite, self.ops.composite_bwd,
            env=env)
        return {"rgb": outs[0], "depth": outs[1], "acc": outs[2],
                "bg": outs[4] if env is not None else None, "env": env}
