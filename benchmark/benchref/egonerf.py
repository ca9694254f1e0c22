"""The plain reference of EgoNeRF's training step and render, in PyTorch
with autograd, float32, no kernels, no batching across rays.

It follows the published model (Choi et al., CVPR 2023) as the shipped
configs run it: the yin-yang chart with an exponential radius under
``interval_th``, exponentially spaced coarse depths (jittered in
training), the coarse density on the half-resolution average-pooled
density grid, inverse-CDF resampling of the interior coarse weights merged
with the coarse depths, the VM-factorized field (planes times lines, a relu
per decomposition for the density, the basis matrix of the sample's chart
for the appearance), the MLP_Fea shader, alpha compositing (with the
environment map behind the last sample), the MSE with the TV terms, and
Adam.  Its departures from float32 arithmetic are the model's own: the
lookup tables are read as bfloat16 (their gradient passes straight to the
float32 tables), a line sample's tent weights are rounded to bfloat16 and
so is the cotangent of a line sample, and the training step's fine draws
are the counter-based Philox draws of ``philox.py``.

It imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from math import pi, sqrt
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .philox import sorted_uniform

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


@dataclass
class RefConfig:
    """The sizes and constants of one configuration, as its file states
    them."""
    n_lamb_sigma: Sequence[int]
    n_lamb_sh: Sequence[int]
    app_dim: int
    view_pe: int
    fea_pe: int
    feature_c: int
    density_shift: float
    distance_scale: float
    near: float
    far: float
    r0: float
    n_voxel: int
    n_coarse: int
    n_fine: int
    batch_size: int
    envmap_h: int
    tv_density: float
    tv_app: float
    iter_ignore_tv: int
    lr_init: float
    lr_basis: float
    lr_envmap: float
    lr_decay_target_ratio: float
    decay_iters: int

    @classmethod
    def from_overrides(cls, o: dict) -> "RefConfig":
        decay = o["lr_decay_iters"] if o["lr_decay_iters"] > 0 else o["n_iters"]
        return cls(
            n_lamb_sigma=list(o["n_lamb_sigma"]), n_lamb_sh=list(o["n_lamb_sh"]),
            app_dim=int(o["data_dim_color"]), view_pe=int(o["view_pe"]),
            fea_pe=int(o["fea_pe"]), feature_c=int(o["featureC"]),
            density_shift=float(o["density_shift"]),
            distance_scale=float(o["distance_scale"]), near=float(o["near_far"][0]),
            far=float(o["near_far"][1]), r0=float(o["r0"]), n_voxel=int(o["N_voxel_init"]),
            n_coarse=int(o["n_coarse"]), n_fine=int(o["n_fine"]),
            batch_size=int(o["batch_size"]),
            envmap_h=(int(o["envmap_res_H"] / o["downsample_train"]) if o.get("use_envmap")
                      else 0),
            tv_density=float(o["TV_weight_density"]), tv_app=float(o["TV_weight_app"]),
            iter_ignore_tv=int(o["iter_ignore_TV"]), lr_init=float(o["lr_init"]),
            lr_basis=float(o["lr_basis"]), lr_envmap=float(o["lr_envmap"]),
            lr_decay_target_ratio=float(o["lr_decay_target_ratio"]), decay_iters=int(decay))


# ---------------------------------------------------------------------------
# the chart
# ---------------------------------------------------------------------------
def grid_size(n_voxels: int) -> List[int]:
    """(n_r, n_theta, n_phi) of the yin-yang grid for a voxel budget."""
    n_r = int(n_voxels ** (1.0 / 3.0) / 2.0)
    n_theta = int(n_r * 2.0 * sqrt(3.0) / 3.0)
    n_phi = n_theta * 3
    return [n + n % 2 for n in (n_r, n_theta, n_phi)]


def _index2r(r0: float, ratio: float, index) -> np.ndarray:
    idx = np.asarray(index, dtype=np.float32)
    return np.where(idx > 0, r0 * ratio ** (idx - 1.0), 0.0).astype(np.float32)


def _exp_ratio(r0: float, far: float, n: int) -> float:
    return float(np.exp(np.log(far / r0) / (n - 1)))


def _interval_th(grid: np.ndarray, r0: float) -> np.ndarray:
    """Constant spacing r0 for the leading intervals not wider than r0,
    the exponential tail shifted to stay continuous (float32)."""
    grid = np.asarray(grid, dtype=np.float32).copy()
    r0 = np.float32(r0)
    m = int(np.sum((grid[1:] - grid[:-1]) <= r0))
    out = grid.copy()
    out[: m + 1] = np.arange(m + 1, dtype=np.float32) * r0
    if m < len(grid) - 1:
        out[m + 1:] = grid[m + 1:] + (m * r0 - grid[m])
    return out


def sample_r_grid(r0: float, span: float, n: int) -> np.ndarray:
    return _interval_th(_index2r(r0, _exp_ratio(r0, span, n), np.arange(n)), r0)


class Chart:
    """World points -> normalized [r, theta, phi, flag] on the yin-yang
    grid centred on the scene box."""

    def __init__(self, aabb, n_r: int, r0: float, device, dtype=torch.float32):
        aabb = np.asarray(aabb, np.float32).reshape(2, 3)
        center = aabb.sum(0) / 2.0
        idx = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(-1, 3)
        corners = aabb[idx, np.arange(3)]
        max_r = float(np.linalg.norm(corners - center, axis=-1).max())
        near = np.array([0.0, pi / 4.0, -3.0 * pi / 4.0], dtype=np.float32)
        far = np.array([max_r, 3.0 * pi / 4.0, 3.0 * pi / 4.0], dtype=np.float32)
        grid = _interval_th(_index2r(r0, _exp_ratio(r0, max_r, n_r), np.arange(n_r + 1)), r0)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)  # noqa: E731,E501
        self.center, self.near, self.inv = as_t(center), as_t(near), as_t(1.0 / (far - near))
        self.grid = as_t(grid)

    @staticmethod
    def _acos(num, r):
        ratio = torch.where(r > 0, num / r.clamp_min(1e-12), torch.zeros_like(r))
        return torch.acos(ratio.clamp(-1.0, 1.0))

    def __call__(self, rays_o, viewdirs, z) -> torch.Tensor:
        """(R, 3), (R, 3), (R, S) -> (R * S, 4)."""
        xyz = rays_o[:, None, :] + viewdirs[:, None, :] * z[..., None]
        d = xyz - self.center
        dx, dy, dz = d.unbind(-1)
        r = torch.sqrt(dx * dx + dy * dy + dz * dz)
        theta_n = self._acos(dz, r)
        phi_n = torch.atan2(dy, dx)
        yin = ((pi / 4.0 <= theta_n) & (theta_n <= 3.0 * pi / 4.0)
               & (-3.0 * pi / 4.0 <= phi_n) & (phi_n <= 3.0 * pi / 4.0))
        theta = torch.where(yin, theta_n, self._acos(dy, r))
        phi = torch.where(yin, phi_n, torch.atan2(dz, -dx))
        n_r = self.grid.shape[0] - 1
        rr = (r - self.near[0]).contiguous()
        hi = torch.searchsorted(self.grid, rr, right=True).clamp(1, n_r)
        g_lo, g_hi = self.grid[hi - 1], self.grid[hi]
        norm_r = ((hi - 1).to(r.dtype) + (rr - g_lo) / (g_hi - g_lo)) / n_r * 2.0 - 1.0
        tp = torch.stack([theta, phi], -1)
        norm_tp = (tp - self.near[1:3]) * self.inv[1:3] * 2.0 - 1.0
        flag = (~yin).to(r.dtype)
        return torch.cat([norm_r[..., None], norm_tp, flag[..., None]], -1).reshape(-1, 4)


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------
def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t's bfloat16 values in float32; the gradient passes to t unchanged."""
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t.detach())


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the cotangent rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _cells(coord: torch.Tensor, size: int):
    """[-1, 1] -> (clamped cell, weight of it, weight of the next):
    align_corners with zeros outside."""
    p = (coord + 1.0) * 0.5 * (size - 1)
    i0f = torch.floor(p)
    t = p - i0f
    i0 = i0f.to(torch.int64)
    v0 = (i0 >= 0) & (i0 <= size - 1)
    v1 = (i0 + 1 >= 0) & (i0 + 1 <= size - 1)
    w0 = torch.where(i0 == -1, t, (1.0 - t) * v0)
    w1 = t * (v1 & (i0 >= 0))
    return i0.clamp(0, size - 1), w0, w1


def sample_plane(plane, x, y, sel):
    """Bilinear sample of (2, H, W, C) planes at (x, y) on chart ``sel``."""
    s, h, w, c = plane.shape
    x0, wx0, wx1 = _cells(x, w)
    y0, wy0, wy1 = _cells(y, h)
    x1, y1 = (x0 + 1).clamp_max(w - 1), (y0 + 1).clamp_max(h - 1)
    flat = plane.reshape(s * h * w, c)
    base = sel * (h * w)
    out = None
    for yy, xx, wt in ((y0, x0, wy0 * wx0), (y0, x1, wy0 * wx1), (y1, x0, wy1 * wx0),
                       (y1, x1, wy1 * wx1)):
        term = wt[:, None] * flat[base + yy * w + xx]
        out = term if out is None else out + term
    return out


def sample_line(line, coord, sel):
    """Linear sample of (2, L, C) lines, float32 weights."""
    s, n, c = line.shape
    i0, w0, w1 = _cells(coord, n)
    flat = line.reshape(s * n, c)
    return (w0[:, None] * flat[sel * n + i0]
            + w1[:, None] * flat[sel * n + (i0 + 1).clamp_max(n - 1)])


def sample_line_hat(line, coord, sel):
    """Linear sample of (2, L, C) lines with tent weights rounded to
    bfloat16, within the sample's own chart's rows."""
    s, n, c = line.shape
    pos = (coord + 1.0) * 0.5 * (n - 1) + sel.to(coord.dtype) * n
    jf = torch.floor(pos)
    first = sel * n
    flat = line.reshape(s * n, c)
    out = None
    for jj in (jf, jf + 1.0):
        tent = (1.0 - (pos - jj).abs()).clamp_min(0.0)
        j = jj.to(torch.int64)
        inside = (j >= first) & (j <= first + n - 1)
        wt = torch.where(inside, tent, torch.zeros_like(tent)).to(torch.bfloat16).to(tent.dtype)
        term = wt[:, None] * flat[j.clamp(first, first + n - 1)]
        out = term if out is None else out + term
    return out


def hat_lines(n_rows: int, n_points: int) -> bool:
    """Whether a fine line of ``n_rows`` stacked rows is sampled with the
    bfloat16 tent weights at ``n_points`` points (the model's gate: at most
    1,152 rows and a 3e9-byte one-hot matrix)."""
    return n_rows <= 1152 and n_rows * n_points * 2 <= 3e9


def field(coords, planes, lines, n_density, train: bool):
    """(N, 4) coords on fused (density | appearance) tables -> density
    feature (N,) and appearance (N, sum of appearance channels)."""
    xyz, sel = coords[:, :3], coords[:, 3].to(torch.int64)
    dens, parts = None, []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        pv = sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
        ln = lines[i]
        if hat_lines(ln.shape[0] * ln.shape[1], coords.shape[0]):
            lv = sample_line_hat(ln, xyz[:, VEC_MODE[i]], sel)
            if train:
                lv = _RoundGrad.apply(lv)
        else:
            lv = sample_line(ln, xyz[:, VEC_MODE[i]], sel)
        prod = pv * lv
        part = torch.relu(prod[:, : n_density[i]].sum(-1))
        dens = part if dens is None else dens + part
        parts.append(prod[:, n_density[i]:])
    return dens, torch.cat(parts, dim=-1)


def coarse_density(coords, planes, lines):
    """The half-resolution density feature (N,) of bfloat16 tables."""
    xyz, sel = coords[:, :3], coords[:, 3].to(torch.int64)
    dens = None
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        prod = (sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
                * sample_line(lines[i], xyz[:, VEC_MODE[i]], sel))
        part = torch.relu(prod.sum(-1))
        dens = part if dens is None else dens + part
    return dens


def _pool_plane(p):
    s, h, w, c = p.shape
    p = p[:, : (h // 2) * 2, : (w // 2) * 2, :]
    return p.reshape(s, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _pool_line(l):
    s, n, c = l.shape
    return l[:, : (n // 2) * 2, :].reshape(s, n // 2, 2, c).mean(dim=2)


def coarse_tables(p):
    """The bfloat16 (as float32) half-resolution density grid."""
    bf = lambda t: t.detach().to(torch.bfloat16).to(t.dtype)  # noqa: E731
    return ([bf(_pool_plane(p[f"density_planes.{i}"].detach())) for i in range(3)],
            [bf(_pool_line(p[f"density_lines.{i}"].detach())) for i in range(3)])


def fine_tables(p):
    """The fused (density | appearance) planes and lines, read as
    bfloat16."""
    planes = [_bf16(torch.cat([p[f"density_planes.{i}"], p[f"app_planes.{i}"]], -1))
              for i in range(3)]
    lines = [_bf16(torch.cat([p[f"density_lines.{i}"], p[f"app_lines.{i}"]], -1))
             for i in range(3)]
    return planes, lines


# ---------------------------------------------------------------------------
# sampling, shading, compositing
# ---------------------------------------------------------------------------
def softplus_shift(feat, shift):
    x = feat + shift
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _dists(z):
    d = z[:, 1:] - z[:, :-1]
    return torch.cat([d, d[:, -1:]], dim=-1)


def _transmittance(alpha):
    """(weights alpha * exclusive transmittance, transmittance of the
    whole ray (R, 1))."""
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return alpha * excl, trans[:, -1:]


def linspace01(n: int, device, dtype=torch.float32) -> torch.Tensor:
    """0, 1/(n-1), ..., 1 as i times the float32 reciprocal, then 1."""
    recip = float(np.float32(1.0) / np.float32(n - 1))
    step = torch.arange(n - 1, dtype=dtype, device=device) * recip
    return torch.cat([step, torch.ones(1, dtype=dtype, device=device)])


def sample_pdf(bins, weights, u):
    """Inverse-CDF depths at ``u`` of the piecewise-constant pdf of
    ``weights`` + 1e-5 over the ``bins`` edges."""
    x = weights + 1e-5
    pdf = x / x.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], dim=1)
    b = cdf.shape[1]
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = (inds - 1).clamp_min(0)
    above = torch.where(inds < b, inds, below)
    c_lo, c_hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b_lo, b_hi = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = c_hi - c_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b_lo + (u - c_lo) / denom * (b_hi - b_lo)


def positional_encoding(x, freqs: int):
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def shade(p, feats, viewdirs, cfg: RefConfig):
    """MLP_Fea: sigmoid of three layers over [features, viewdirs,
    pe(features), pe(viewdirs)]."""
    x = torch.cat([feats, viewdirs, positional_encoding(feats, cfg.fea_pe),
                   positional_encoding(viewdirs, cfg.view_pe)], dim=-1)
    h = F.relu(F.linear(x, p["shader.l1.weight"], p["shader.l1.bias"]))
    h = F.relu(F.linear(h, p["shader.l2.weight"], p["shader.l2.bias"]))
    return torch.sigmoid(F.linear(h, p["shader.l3.weight"], p["shader.l3.bias"]))


def envmap_radiance(table, dirs):
    """sigmoid of the bilinear sample of the (2h, h, 3) table at the
    direction's (cos theta, phi) texel."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    norm = torch.sqrt(x * x + y * y + z * z)
    u = (z / norm + 1.0) * 0.5
    v = (torch.atan2(y / norm, x / norm) + pi) * float(np.float32(1.0) / np.float32(2.0 * pi))
    h = table.shape[1]
    flat = table.reshape(-1, 3)

    def corner(c, size):
        q = (c * 2.0 - 1.0 + 1.0) * 0.5 * (size - 1)
        i0f = torch.floor(q)
        t = q - i0f
        i0 = i0f.to(torch.int64)
        i1 = i0 + 1
        return (i0.clamp(0, size - 1), i1.clamp(0, size - 1), t,
                (i0 >= 0) & (i0 <= size - 1), (i1 >= 0) & (i1 <= size - 1))

    x0, x1, tx, vx0, vx1 = corner(u, h)
    y0, y1, ty, vy0, vy1 = corner(v, 2 * h)
    ax, ay = 1.0 - tx, 1.0 - ty
    raw = None
    for idx, wt in ((y0 * h + x0, ay * ax * (vy0 & vx0)), (y0 * h + x1, ay * tx * (vy0 & vx1)),
                    (y1 * h + x0, ty * ax * (vy1 & vx0)), (y1 * h + x1, ty * tx * (vy1 & vx1))):
        term = flat[idx] * wt[:, None]
        raw = term if raw is None else raw + term
    return torch.sigmoid(raw)


def forward(p, rays, chart: Chart, cfg: RefConfig, coarse, fine, jitter=None, u=None,
            train=False) -> Dict[str, torch.Tensor]:
    """Render (R, 6) rays; ``coarse`` and ``fine`` are the
    :func:`coarse_tables` and :func:`fine_tables` of ``p``.  Training passes
    the coarse ``jitter`` (R, n_coarse) and the fine draws ``u``; without
    them the depths are the evaluation's."""
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    n, dev, dt = rays.shape[0], rays.device, rays.dtype
    with torch.no_grad():
        base = torch.as_tensor(sample_r_grid(cfg.r0, cfg.far - cfg.near, cfg.n_coarse),
                               device=dev).to(dt)
        r = base.expand(n, cfg.n_coarse)
        if jitter is not None:
            r = r + _dists(base[None])[0][None] * jitter
        coarse_z = cfg.near + r
        c_feat = coarse_density(chart(rays_o, viewdirs, coarse_z), *coarse).reshape(n, -1)
        sigma = softplus_shift(c_feat, cfg.density_shift)
        alpha = 1.0 - torch.exp(-sigma * (_dists(coarse_z) * cfg.distance_scale))
        weights, _ = _transmittance(alpha)
        z_mid = 0.5 * (coarse_z[:, 1:] + coarse_z[:, :-1])
        u = (linspace01(cfg.n_fine, dev, dt).expand(n, cfg.n_fine) if u is None
             else u.to(dt))
        fine_z = sample_pdf(z_mid, weights[:, 1:-1], u)
        z_vals = torch.sort(torch.cat([coarse_z, fine_z], -1), dim=-1).values
        dists = _dists(z_vals)
        norm = chart(rays_o, viewdirs, z_vals)
    s = z_vals.shape[1]
    feat, app = field(norm, fine[0], fine[1], cfg.n_lamb_sigma, train)
    basis = p["basis"]
    app = torch.where(norm[:, 3:4] == 0, app @ basis[0], app @ basis[1])
    rgb = shade(p, app, viewdirs[:, None, :].expand(n, s, 3).reshape(-1, 3), cfg)
    sigma = softplus_shift(feat.reshape(n, s), cfg.density_shift)
    alpha = 1.0 - torch.exp(-sigma * (dists * cfg.distance_scale))
    weight, bg_weight = _transmittance(alpha)
    acc = weight.sum(-1)
    x = (weight[..., None] * rgb.reshape(n, s, 3)).sum(-2)
    out = {"depth": ((weight * z_vals).sum(-1) + (1.0 - acc) * rays[:, -1]).detach(),
           "acc": acc.detach()}
    if cfg.envmap_h:
        bg = bg_weight * envmap_radiance(p["envmap"], viewdirs)
        x = x + bg
        out["bg"] = bg.detach()
    out["rgb"] = x.clamp(0.0, 1.0)
    return out


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products in full float32, or in TF32 (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# training and rendering
# ---------------------------------------------------------------------------
def _tv_plane(plane):
    s, h, w, c = plane.shape
    h_tv = ((plane[:, 1:] - plane[:, :-1]) ** 2).sum()
    w_tv = ((plane[:, :, 1:] - plane[:, :, :-1]) ** 2).sum()
    return 2.0 * (h_tv / ((h - 1) * w * c) + w_tv / (h * (w - 1) * c)) / s


def tv_weights(cfg: RefConfig, iteration: int):
    """(density, app) TV weights at ``iteration``: decayed by the lr factor
    once a step, in float32; 0 from ``iter_ignore_TV`` on."""
    if iteration >= cfg.iter_ignore_tv:
        return 0.0, 0.0
    factor = cfg.lr_decay_target_ratio ** (1.0 / cfg.decay_iters)
    n_dec = max(min(iteration, cfg.iter_ignore_tv - 1) + 1, 0)
    f = float(np.float32(factor) ** np.float32(n_dec))
    return cfg.tv_density * f, cfg.tv_app * f


def lr_group(name: str) -> str:
    if name == "envmap":
        return "envmap"
    return "network" if name == "basis" or name.startswith("shader.") else "grid"


class TrainResult:
    """What a run of the first steps leaves: each step's MSE, the first
    step's gradient of every leaf, and every leaf after the last step."""

    def __init__(self, losses, grads, params):
        self.losses, self.grads, self.params = losses, grads, params


def train_steps(weights: Dict[str, torch.Tensor], rays_of_ids, n_rays: int, chart: Chart,
                cfg: RefConfig, seed: int, n_steps: int, tf32: bool = False,
                dtype=torch.float32) -> TrainResult:
    """``n_steps`` training steps from ``weights`` (copied): each step
    draws ``batch_size`` ray ids uniformly with replacement from a
    generator seeded ``seed + 2`` on the weights' device, then the coarse
    jitter from it, and the fine draws of (``seed``, step);
    ``rays_of_ids(ids)`` gives the (B, 6) rays and (B, 3) colours.  The
    arithmetic is ``dtype``'s (float64 only for the witness, ``witness.py``);
    the draws are the same in either."""
    dev = next(iter(weights.values())).device
    p = {k: w.detach().to(dtype).clone().requires_grad_(True) for k, w in weights.items()}
    groups: Dict[str, list] = {}
    for k, t in p.items():
        groups.setdefault(lr_group(k), []).append(t)
    base_lr = {"grid": cfg.lr_init, "network": cfg.lr_basis, "envmap": cfg.lr_envmap}
    opt = torch.optim.Adam([{"params": v, "lr": base_lr[g], "group": g}
                            for g, v in groups.items()], betas=(0.9, 0.99), eps=1e-8)
    factor = cfg.lr_decay_target_ratio ** (1.0 / cfg.decay_iters)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    losses, grads = [], None
    with matmul_precision(tf32):
        for it in range(n_steps):
            ids = torch.randint(0, n_rays, (cfg.batch_size,), generator=gen, device=dev)
            rays, rgbs = (t.to(dtype) for t in rays_of_ids(ids))
            jitter = torch.rand(cfg.batch_size, cfg.n_coarse, generator=gen,
                                device=dev).to(dtype)
            u = sorted_uniform(cfg.batch_size, cfg.n_fine, seed, it, dev)
            out = forward(p, rays, chart, cfg, coarse_tables(p), fine_tables(p), jitter, u,
                          train=True)
            mse = torch.mean((out["rgb"] - rgbs) ** 2)
            total = mse
            tv_d, tv_a = tv_weights(cfg, it)
            if tv_d > 0:
                total = total + tv_d * sum(_tv_plane(p[f"density_planes.{i}"]) * 2e-2
                                           for i in range(3))
            if tv_a > 0:
                total = total + tv_a * sum(_tv_plane(p[f"app_planes.{i}"]) * 2e-2
                                           for i in range(3))
            opt.zero_grad(set_to_none=True)
            total.backward()
            if it == 0:
                grads = {k: t.grad.detach().clone() for k, t in p.items()}
            for g in opt.param_groups:
                g["lr"] = base_lr[g["group"]] * factor ** it
            opt.step()
            losses.append(float(mse.detach()))
    return TrainResult(losses, grads, {k: t.detach() for k, t in p.items()})


@torch.no_grad()
def render_rays(weights: Dict[str, torch.Tensor], rays: torch.Tensor, chart: Chart,
                cfg: RefConfig, chunk: int, tf32: bool = False,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """rgb, depth (and bg with the envmap) of (N, 6) rays, ``chunk`` rays
    at a time, in ``dtype``'s arithmetic."""
    weights = {k: w.to(dtype) for k, w in weights.items()}
    rays = rays.to(dtype)
    coarse, fine = coarse_tables(weights), fine_tables(weights)
    outs = []
    with matmul_precision(tf32):
        for c in range(0, rays.shape[0], chunk):
            outs.append(forward(weights, rays[c:c + chunk], chart, cfg, coarse, fine))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
