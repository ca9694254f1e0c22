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
(K6, K6b).  The coarse chart of a forward is K7; the fine one runs in
K4's epilogue (``ops.resample_chart``), or is K7 without resampling and
under the empty-space cull (``eval_keep``, ``train_keep``: K4c scores the
merged samples in its epilogue, K13 keeps the K highest, and K7 takes the
chart of the kept depths).  In training K4 and K4c draw K5's sorted
uniforms in their prologue, so no K5 is launched.
With ``use_envmap`` the (2h, h, 3) ``envmap`` parameter gives each ray its
background radiance, looked up inside the composite (K6e; K8b gives the
table its gradient) and blended behind the last sample; the pretrain
phase looks it up alone (K8).
The kernels come from ``self.ops`` (``ops.KERNELS``).

The regularizers (L1, TV, Ortho), the sparsity loss's density
(:meth:`EgoNeRF.sparsity_density`: K3's training instantiation, K2 behind
it) and the alpha-mask bake are here as in JAX; the forward never reads
the mask, in JAX as here.  For the entropy loss the training forward
returns each sample's alpha (``with_alpha``, K6's training
instantiation).

The JAX module's opt-in forms, from the environment at import with JAX's
names and defaults: ``EGONERF_MIXED_MM=1`` takes the shader's products and
the basis products through K10 (bf16 operands, float32 sums), decided when
the model is built and only under ``compute_dtype = "bfloat16"``;
``EGONERF_LINE_HAT=0`` takes the fine lines off the hat path (float32
weights, and K2's bf16 corner cotangents while JAX's one-hot gate holds);
``EGONERF_HOIST_DIRS=1`` hands the shader unexpanded (R, 3) viewdirs.  The
shader's own switches are in ``models/shading.py``.
"""
from __future__ import annotations

import dataclasses
import os
from math import pi
from typing import List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .._device import full_f32_matmul, resolve_device
from ..coords.expgrid import make_sample_r_grid
from ..coords.yinyang import YinYangSphericalCoords
from ..ops import KERNELS
from ..ops.mm import mixed_matmul
from ..ops.vm_lookup import LINE_HAT as _vm_lookup_line_hat
from ..ops.vm_lookup import (HAT, LINEAR, LINEAR_BF16_GRAD, MAT_MODE, VEC_MODE, density_train,
                             field_train, line_hat_ok, line_onehot_ok)
from ..ops.cull import dilate, gumbel_perturb, train_tiebreak
from ..ops.volrend import composite_train, density_activation, raw2alpha
from .alphamask import YinYangAlphaGridMask, bake_alpha_mask, dense_alpha
from .envmap import envmap_radiance, init_envmap
from .shading import _HOIST_DIRS, make_shader

_MIXED_MM = os.environ.get("EGONERF_MIXED_MM", "0") == "1"
_LINE_HAT = _vm_lookup_line_hat


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static model hyperparameters: every field of the JAX ``FieldConfig``
    (``pos_pe`` is the MLP_PE shader's; the other modes ignore it)."""
    density_n_comp: Sequence[int] = (16, 16, 16)
    app_n_comp: Sequence[int] = (48, 48, 48)
    app_dim: int = 27
    shading_mode: str = "MLP_Fea"
    pos_pe: int = 6
    view_pe: int = 2
    fea_pe: int = 2
    feature_c: int = 128
    density_shift: float = -8.0
    distance_scale: float = 25.0
    fea2dense_act: str = "softplus"
    # TensoRF's rgb gate: a sample's rgb counts where its weight is above
    ray_march_weight_thres: float = 1e-4
    # the alpha-mask bake's threshold
    alpha_mask_thres: float = 1e-3
    # march step = mean grid unit x step_ratio (TensoRF's linear sampler,
    # the bake's alpha length)
    step_ratio: float = 0.5
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


def tv_plane(plane: torch.Tensor) -> torch.Tensor:
    """Squared-difference total variation of (S, H, W, C) planes, as JAX's
    ``_tv`` normalizes it."""
    s, h, w, c = plane.shape
    h_tv = ((plane[:, 1:] - plane[:, :-1]) ** 2).sum()
    w_tv = ((plane[:, :, 1:] - plane[:, :, :-1]) ** 2).sum()
    return 2.0 * (h_tv / ((h - 1) * w * c) + w_tv / (h * (w - 1) * c)) / s


def vector_diffs(lines) -> torch.Tensor:
    """The Ortho term: per (S, L, C) line and grid, the mean |off-diagonal|
    of the C x C Gram matrix of its components (JAX ``_vector_diffs``)."""
    total = 0.0
    for l in lines:
        for s in range(l.shape[0]):
            v = l[s].T
            gram = v @ v.T
            n = gram.shape[0]
            off = gram.abs() * (1.0 - torch.eye(n, dtype=gram.dtype, device=gram.device))
            total = total + off.sum() / (n * (n - 1))
    return total


def _bf16(ts) -> List[torch.Tensor]:
    return [t.detach().to(torch.bfloat16).contiguous() for t in ts]


def _dists(z: torch.Tensor) -> torch.Tensor:
    d = z[..., 1:] - z[..., :-1]
    return torch.cat([d, d[..., -1:]], dim=-1)


class StepKey(NamedTuple):
    """The random draws of one training step (the JAX ``key``): the
    device-side generator of the coarse jitter, and the (seed, step) key of
    K5's counter-based generator, whose sorted uniforms K4 and K4c draw in
    their prologue.  Under data parallelism the forward's batch is the
    shard of a global batch of ``n_global`` rays that starts at ray
    ``ray0``: the generator's draws are taken for the global batch and
    sliced (:meth:`rand`), and K5's are keyed by the global ray index, so
    a shard draws what the global batch draws for its rays."""
    generator: torch.Generator
    seed: int
    step: int
    ray0: int = 0
    n_global: int = 0

    def rand(self, n_rays: int, n: int, device) -> torch.Tensor:
        """(n_rays, n) uniforms of this batch's rays: the (n_global, n)
        draw's rows from ``ray0`` (the whole draw without a global batch)."""
        total = self.n_global or n_rays
        u = torch.rand(total, n, generator=self.generator, device=device)
        return u if total == n_rays else u[self.ray0:self.ray0 + n_rays]


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
        # the shader's and the basis products through K10 (JAX's self._mm)
        self.mixed_mm = _MIXED_MM and cfg.compute_dtype == "bfloat16"
        self._sample_grid_cache: dict = {}
        self.alpha_mask: Optional[YinYangAlphaGridMask] = None
        self.update_step_size(grid_size)
        gs = self.grid_size

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
        self.shader = make_shader(cfg.shading_mode, cfg.app_dim, cfg.pos_pe, cfg.view_pe,
                                  cfg.fea_pe, cfg.feature_c).to(self.device)
        if cfg.use_envmap:
            self.envmap = nn.Parameter(init_envmap(cfg.envmap_res_h, init_strategy="zero",
                                                   device=self.device))

    def update_step_size(self, grid_size) -> None:
        """Grid bookkeeping (JAX ``update_step_size``): the grid size and the
        march step, mean grid unit x ``step_ratio`` (the bake's alpha
        length)."""
        self.grid_size = [int(g) for g in grid_size]
        units = (self.aabb[1] - self.aabb[0]) / (np.asarray(self.grid_size) - 1)
        self.step_size = float(np.mean(units) * self.cfg.step_ratio)
        self._sample_grid_cache.clear()

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
        """Each fine line's mode (``ops.vm_lookup``) for ``n`` samples, as
        JAX's ``_fused_products`` picks the line function: under bf16
        compute the hat path (``EGONERF_LINE_HAT``, the default) or
        ``sample_line_packed_fastgrad``, each while its gate holds."""
        if self.cfg.compute_dtype != "bfloat16":
            return [LINEAR] * len(lines)
        mode, ok = (HAT, line_hat_ok) if _LINE_HAT else (LINEAR_BF16_GRAD, line_onehot_ok)
        return [mode if ok(l.shape[0] * l.shape[1], n) else LINEAR for l in lines]

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
        if self.mixed_mm:
            # both charts' products in one K10 launch, reading feats once
            both = mixed_matmul(feats, torch.cat([basis[0], basis[1]], dim=1), self.ops.mm,
                                self.ops.mm_da, self.ops.mm_db)
            yin, yang = both.split(basis.shape[-1], dim=1)
        else:
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

    def sample_depths_linear(self, rays_o: torch.Tensor, rays_d: torch.Tensor, n_samples: int,
                             jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(R, n_samples) depths in uniform steps of ``step_size`` from each
        ray's entry into the aabb, clipped to near/far (the ``interpx`` of
        JAX's ``sample_ray_linear``, ``models/egonerf.py:322-336``; exact
        zeros of ``rays_d`` divide as 1e-6); with ``jitter`` (R, n_samples)
        U(0, 1) draws, each depth moves that many steps further
        (training)."""
        near, far = self.near_far
        dev = rays_o.device
        key = ("aabb", dev)
        aabb = self._sample_grid_cache.get(key)
        if aabb is None:
            aabb = self._sample_grid_cache[key] = torch.as_tensor(self.aabb, device=dev)
        vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
        rate_a = (aabb[1] - rays_o) / vec
        rate_b = (aabb[0] - rays_o) / vec
        t_min = torch.minimum(rate_a, rate_b).amax(dim=-1).clamp(near, far)
        rng = torch.arange(n_samples, dtype=torch.float32, device=dev).expand(
            rays_o.shape[0], n_samples)
        if jitter is not None:
            rng = rng + jitter
        return t_min[:, None] + self.step_size * rng

    @torch.no_grad()
    def upsample_params(self, params, res_target) -> dict:
        """Resample every plane and line onto ``res_target`` at the chart's
        axis positions (r-aware on an exponential radius; JAX
        ``models/egonerf.py:559-577``) and install them as the module's
        parameters; returns :meth:`params`.  The caller then sets the
        chart's resolution, calls :meth:`update_step_size` and rebuilds
        Adam.  Nothing cached depends on the grid: the coarse grid, the
        lookup tables and the line modes are derived from the parameters at
        each use, and the chart's constants follow its resolution."""
        up = self.coordinates.up_sampling_VM
        for pk, lk in (("density_planes", "density_lines"), ("app_planes", "app_lines")):
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                getattr(self, pk)[i] = nn.Parameter(
                    up(params[f"{pk}.{i}"], res_target, ids=[m1, m0]).contiguous())
                getattr(self, lk)[i] = nn.Parameter(
                    up(params[f"{lk}.{i}"], res_target, ids=[VEC_MODE[i]]).contiguous())
        return self.params()

    # ------------------------------------------------------------------
    # alpha mask and regularizers (JAX models/egonerf.py:503-542,579-630)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def update_alpha_mask(self, params, grid_size=None):
        """Bake both occupancy volumes: alpha = 1 - exp(-sigma step_size)
        over the dense normalized grid of each chart (K3 on the stacked
        density tables), dilated and thresholded; installs a
        ``YinYangAlphaGridMask`` and returns the unchanged aabb."""
        gs = self.grid_size if grid_size is None else [int(g) for g in grid_size]
        planes = _bf16(params[f"density_planes.{i}"] for i in range(3))
        lines = _bf16(params[f"density_lines.{i}"] for i in range(3))

        def alpha_of(coords):
            sigma = feature2density(self.ops.density(coords, planes, lines), self.cfg)
            return 1.0 - torch.exp(-sigma * self.step_size)

        yin, yang = dense_alpha(alpha_of, gs, planes[0].device, n_grids=2)
        vols = [bake_alpha_mask(a, self.cfg.alpha_mask_thres) for a in (yin, yang)]
        self.alpha_mask = YinYangAlphaGridMask(*vols, device=planes[0].device)
        total = int(vols[0].sum() + vols[1].sum())
        print(f"alpha rest %{total / (2 * np.prod(gs)) * 100:.2f}")
        return self.aabb

    def vector_comp_diffs(self, params) -> torch.Tensor:
        return (vector_diffs([params[f"density_lines.{i}"] for i in range(3)])
                + vector_diffs([params[f"app_lines.{i}"] for i in range(3)]))

    def sparsity_density(self, params, generator: Optional[torch.Generator], n_points: int,
                         points: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sigma at ``n_points`` random normalized coords on either chart,
        for the sparsity loss (JAX ``models/egonerf.py:547-557``): (n, 3)
        uniform in [-1, 1) and a Bernoulli(1/2) chart flag, drawn from
        ``generator`` (the step's, after the forward's draws), or the given
        (n, 4) ``points``.  The density is K3's training instantiation on
        the float32 density tables, differentiable in them through K2."""
        if points is None:
            dev = generator.device
            xyz = torch.rand(n_points, 3, generator=generator, device=dev) * 2.0 - 1.0
            flag = (torch.rand(n_points, 1, generator=generator, device=dev) < 0.5).float()
            points = torch.cat([xyz, flag], dim=-1)
        feat = density_train(points.contiguous(),
                             [params[f"density_planes.{i}"] for i in range(3)],
                             [params[f"density_lines.{i}"] for i in range(3)],
                             self.ops.density, self.ops.field_bwd)
        return feature2density(feat, self.cfg)

    def density_l1(self, params) -> torch.Tensor:
        """Per grid means summed, as JAX's separate yin and yang terms (x2)."""
        return sum(params[f"density_planes.{i}"].abs().mean() * 2
                   + params[f"density_lines.{i}"].abs().mean() * 2 for i in range(3))

    def tv_loss_density(self, params) -> torch.Tensor:
        return sum(tv_plane(params[f"density_planes.{i}"]) * 2.0 * 1e-2 for i in range(3))

    def tv_loss_app(self, params) -> torch.Tensor:
        return sum(tv_plane(params[f"app_planes.{i}"]) * 2.0 * 1e-2 for i in range(3))

    def _oracle_score(self, params, rays_o, viewdirs, z_vals, dists) -> torch.Tensor:
        """The cull's ORACLE scorer (JAX ``models/egonerf.py:417-443``, an
        instrument): the full-resolution weights of all S merged samples,
        dilated as K12 dilates the coarse ones; K7's chart of every merged
        depth, K3 on the fine density tables, raw2alpha's weights."""
        cfg = self.cfg
        norm = self.ops.chart(rays_o, viewdirs, z_vals, self.coordinates)
        planes = [params[f"density_planes.{i}"] for i in range(3)]
        lines = [params[f"density_lines.{i}"] for i in range(3)]
        feat = self.compute_density_feature(planes, lines, norm).reshape(z_vals.shape)
        _, w, _ = raw2alpha(feature2density(feat, cfg), dists * cfg.distance_scale)
        return dilate(w)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, params, rays: torch.Tensor, key: Optional[StepKey] = None,
                is_train=False, n_coarse=128, n_fine=128, exp_sampling=True, resampling=True,
                use_coarse_sample=True, pretrain_envmap=False, white_bg=True,
                ndc_ray=False, eval_keep=0, train_keep=0, train_cull_tau=0.0,
                eval_keep_score="coarse", tables: Optional[LookupTables] = None,
                jitter: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                cull_u: Optional[torch.Tensor] = None, with_alpha: bool = False):
        """Render an (R, 6) ray batch.  Returns dict(rgb (R, 3), depth (R,),
        acc (R,), bg, env), and with ``with_alpha`` (the entropy loss's
        input) also alpha: each kept sample's alpha (R, S), differentiable
        in ``params`` (K6's and K6b's training instantiations), with JAX's
        column of ones appended under the envmap (its cotangent dropped).
        With the envmap, env (R, 3) is each ray's
        background radiance and bg (R, 3) = its transmittance times env,
        else both are None; both come out of the composite (K6e) and take
        no gradient (the table's flows through rgb).  ``pretrain_envmap``
        returns dict(env) alone, the envmap's radiance (its pretrain phase,
        K8 with K8b behind it), differentiable in the table.  ``white_bg`` is
        accepted and unused, as in JAX.

        ``exp_sampling`` takes the exponential coarse depths, else the
        linear ones (:meth:`sample_depths_linear`).
        Training (``is_train`` with a ``key``) jitters the coarse depths and
        K4 (or K4c) draws its ``u``, K5's sorted uniforms for (seed, step),
        in its prologue; ``jitter`` (R, n_coarse) and ``u`` (R, n_fine,
        sorted) give those draws explicitly instead.  Without
        draws the depths are the eval ones.  rgb is differentiable in
        ``params``; depth and acc are not (JAX stops depth's gradient).
        ``tables`` are :meth:`lookup_tables` of ``params`` for an eval
        render; without them the fine field runs through its autograd
        Function.  Eval callers run under ``torch.no_grad()``.

        The empty-space cull (JAX ``ops/cull.py``): with resampling and
        ``keep`` = ``train_keep`` in training, else ``eval_keep``, in
        (0, S) for S merged samples, K4c scores the merged samples by the
        coarse weights in K4's epilogue (K12's function; with
        ``eval_keep_score = "oracle"`` at eval, the depths of K4's weights
        instantiation scored by the full-resolution weights of all S
        samples),
        training with a key or ``cull_u`` (R, S) uniforms perturbs the
        scores (``gumbel_perturb`` at ``train_cull_tau`` > 0, else
        ``train_tiebreak``), K13 keeps the ``keep`` highest with their
        original dists, and K7 takes the chart of the kept depths.  The kept
        depths are constants for autograd, as in JAX."""
        if ndc_ray:
            raise NotImplementedError("NDC rays are not supported by the egocentric model "
                                      "(reference: models/EgoNeRF.py:504), as in JAX")
        cfg = self.cfg
        rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
        if pretrain_envmap:
            if not cfg.use_envmap:
                raise ValueError("pretrain_envmap needs a model with the envmap")
            return {"env": envmap_radiance(params["envmap"], viewdirs, self.ops)}
        coords = self.coordinates
        n_rays, dev = rays.shape[0], rays.device
        # the draw key goes only to a resampling op that draws (a given u,
        # or eval's linspace, takes none)
        draw = {}
        if is_train and key is not None:
            if jitter is None:
                jitter = key.rand(n_rays, n_coarse, dev)
            if u is None and resampling:
                draw = {"draw": (key.seed, key.step), "ray0": key.ray0}

        with torch.no_grad():
            # 1) coarse depths; the chart's radial mode (K7, K4's epilogue)
            # is the chart's own, whichever sampling gave the depths
            coarse_z = (self.sample_depths_exp(n_rays, n_coarse, dev, jitter) if exp_sampling
                        else self.sample_depths_linear(rays_o, viewdirs, n_coarse, jitter))
            coarse_dists = _dists(coarse_z)

            # 2) coarse chart + half-res normalization (K7)
            coarse_norm = self.ops.chart(rays_o, viewdirs, coarse_z, coords,
                                         2).reshape(n_rays, n_coarse, 4)

            if resampling:
                # 3) coarse density (K3) on the detached grid -> weights,
                # inverse CDF at u, merge, and the fine chart of the merged
                # depths in K4's epilogue; under the cull (JAX
                # models/egonerf.py:412-460) K4c scores the merged samples
                # in that epilogue instead, K13 keeps and K7 charts the kept
                c_planes, c_lines = (self.coarse_tables(params) if tables is None
                                     else (tables.coarse_planes, tables.coarse_lines))
                c_feat = self._density(c_planes, c_lines, coarse_norm)
                act = (cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
                keep = int(train_keep if is_train else eval_keep)
                n_merged = n_coarse + n_fine if use_coarse_sample else n_fine
                if 0 < keep < n_merged:
                    resampled = (c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample,
                                 *act)
                    if not is_train and eval_keep_score == "oracle":
                        z_vals, dists, _ = self.ops.resample_weights(*resampled)
                        score = self._oracle_score(params, rays_o, viewdirs, z_vals, dists)
                    else:
                        z_vals, dists, score = self.ops.resample_score(*resampled, **draw)
                    if is_train and (key is not None or cull_u is not None):
                        if cull_u is None:
                            cull_u = key.rand(n_rays, n_merged, dev)
                        score = (gumbel_perturb(score, cull_u, float(train_cull_tau))
                                 if train_cull_tau > 0 else train_tiebreak(score, cull_u))
                    z_vals, dists = self.ops.select_top_k(z_vals, dists, score, keep)
                    norm = self.ops.chart(rays_o, viewdirs, z_vals, coords)
                else:
                    z_vals, dists, norm = self.ops.resample_chart(
                        c_feat, coarse_z, coarse_dists, n_fine, u, use_coarse_sample, *act,
                        rays_o, viewdirs, coords, **draw)
                norm = norm.reshape(n_rays, z_vals.shape[1], 4)
            else:
                z_vals, dists, norm = coarse_z, coarse_dists, coarse_norm

        # 4) fine field (K1, K2 backward) + shading of the normalized coords
        feat, app_feat = self.compute_field(params, norm, tables)
        # the hoist hands MLP_Fea each ray's direction once
        dirs = (viewdirs if _HOIST_DIRS and self.shader.name == "MLP_Fea"
                else viewdirs[:, None, :].expand(*norm.shape[:-1], 3))
        rgb = self.shader.apply_params(params, "shader.", dirs, app_feat, self.ops,
                                       self.mixed_mm, pts=norm[..., :3])

        # 5) the composite (K6, K6b backward); with the envmap, K6e looks up
        # each ray's radiance and blends it as a last sample of alpha 1, and
        # the table's gradient is K8b of K6b's d env
        envmap = params["envmap"] if cfg.use_envmap else None
        outs = composite_train(
            feat, dists, z_vals, rgb, rays[:, -1].contiguous(), cfg.density_shift,
            cfg.distance_scale, cfg.fea2dense_act, self.ops.composite, self.ops.composite_bwd,
            envmap=envmap, viewdirs=viewdirs if cfg.use_envmap else None,
            env_bwd=self.ops.envmap_bwd, with_alpha=with_alpha)
        out = {"rgb": outs[0], "depth": outs[1], "acc": outs[2],
               "bg": outs[4] if envmap is not None else None,
               "env": outs[5] if envmap is not None else None}
        if with_alpha:
            out["alpha"] = with_background(outs[-1], cfg.use_envmap)
        return out


def with_background(alpha: torch.Tensor, envmap: bool) -> torch.Tensor:
    """The forward's alpha as JAX returns it: with the envmap a column of
    ones (the background's alpha) after the samples."""
    if not envmap:
        return alpha
    return torch.cat([alpha, torch.ones_like(alpha[:, :1])], dim=-1)
