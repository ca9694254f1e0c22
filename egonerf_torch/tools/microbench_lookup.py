"""The VM-grid lookup's forms on the card, at the production fine grid
(counterpart of ``egonerf_tpu/tools/microbench_lookup.py``).

JAX times TPU formulations of the lookups (a one-hot MXU line lookup, a
sorted plane scatter, a rank merge).  The port times its own forms of the
same operations, on the tables of ``presets.production_model`` (N_voxel
27e6, grid [150, 172, 516], 16 + 48 channels a decomposition, bf16) with
seeded random weights, over the ray-coherent sample stream of
:func:`ray_coherent_coords` (4096 rays x 256 exponentially spaced samples
through the yin-yang chart, JAX's draws):

* the line forward: K16 (``ops/grid_sample.py::sample_line``, float32
  lines), K15 (``sample_line_nograd``, bf16), and K1 with the hat lines
  beside K1 with the float32 pair (the line mode is K1's only change);
* the plane forward: K15 (``sample_plane_nograd``);
* the backward: K2 in line modes 0, 1 and 2;
* the merge of two sorted halves: K4 with given uniforms (no draw), merged
  and unmerged, beside ``torch.sort`` of the concatenation.

Each form is first held against its plain version at the kernel table's
limits (``PERF.md`` §6: rel 1e-5 of max|plain|; K2 per cell 1e-4 of the
sum of its absolute terms; K4's depths 1e-5 of far, and its merge equal to
``torch.sort``'s bit for bit); a miss raises.  Then each is timed with CUDA
events, ``REPS`` launches behind a device-side sleep after a warm launch,
beside its plain version and, where one PyTorch call computes the same
function, that call (``F.grid_sample``; ``torch.sort``).

    python -m egonerf_torch.tools.microbench_lookup

runs on the card and writes ``docs/torch/results_microbench_lookup.json``
(with ``device``, the card's name and power limit).
"""
from __future__ import annotations

import json
import sys

import numpy as np

from . import device_name, write_results

B, S = 4096, 256
N = B * S
# coarse and fine samples a ray of the merge (the production 128 + 128)
N_COARSE = N_FINE = 128
REPS = 20
PLAIN_REPS = 5
# about 0.1 s of device spin on an NVIDIA H100 80GB HBM3 at 700 W: longer
# than the host takes to queue one timed run
SLEEP_CYCLES = 200_000_000
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# the kernel table's limits (PERF.md §6)
REL_TOL = 1e-5
K2_TOL = 1e-4
K4_TOL = 1e-5


def ray_coherent_rays(seed: int = 0):
    """JAX's draws: B unit directions from a normal, origins in
    [-0.2, 0.2]^3, S depths geometric over [0.06, 8.4]; numpy float32
    (o (B, 3), d (B, 3), t (S,))."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(B, 3)).astype(np.float32)
    t = np.geomspace(0.06, 8.4, S).astype(np.float32)
    return o, d, t


def ray_coherent_coords(seed: int = 0, device="cpu"):
    """The sample stream of JAX's ``ray_coherent_coords``: the points of
    :func:`ray_coherent_rays` normalized on the yin-yang chart (exp radius,
    N_voxel 27e6, r0 0.05, interval_th); (r, theta, phi) float32 and the
    chart flag int64, each (B * S,) on ``device``."""
    import torch

    from ..coords.yinyang import YinYangSphericalCoords

    aabb = np.array([[-8.5, -8.5, -8.5], [8.5, 8.5, 8.5]], np.float32)
    coords = YinYangSphericalCoords(aabb, exp_r=True, N_voxel=27_000_000, r0=0.05,
                                    interval_th=True)
    o, d, t = ray_coherent_rays(seed)
    xyz = o[:, None, :] + d[:, None, :] * t[None, :, None]
    norm = coords.normalize_coord(coords.from_cartesian(torch.as_tensor(xyz, device=device)))
    flat = norm.reshape(-1, 4)
    return (flat[:, 0].contiguous(), flat[:, 1].contiguous(), flat[:, 2].contiguous(),
            flat[:, 3].to(torch.int64))


def library_grid_sample(table, u, v, sel):
    """``F.grid_sample`` (bilinear, zeros, align_corners) computing a K15 /
    K16 lookup on a channel-first float32 copy of ``table``: a plane (S, H,
    W, C) at (x = ``u``, y = ``v``), or a line (S, L, C) as an (S, L, 1)
    image at (0, ``v``); with ``sel`` 3-D, the chart 2 sel - 1 as the depth
    (it lands on its plane with weight 1, the other with 0), without it 2-D
    on grid 0.  Returns a callable giving (C, N)."""
    import torch
    import torch.nn.functional as F

    n = v.shape[0]
    table = table.float()
    if table.dim() == 3:
        table, u = table.unsqueeze(2), torch.zeros_like(v)
    c = table.shape[-1]
    img = table.permute(3, 0, 1, 2).unsqueeze(0).contiguous()        # (1, C, S, H, W)
    if sel is not None:
        grid = torch.stack([u, v, (2.0 * sel - 1.0).float()], -1).view(1, 1, 1, n, 3)
    else:
        img, grid = img[:, :, 0], torch.stack([u, v], -1).view(1, 1, n, 2)
    kw = dict(mode="bilinear", padding_mode="zeros", align_corners=True)
    return lambda: F.grid_sample(img, grid, **kw).reshape(c, n)


def time_ms(fn, reps: int = REPS) -> float:
    """Device ms of one ``fn`` call: after a warm call, ``reps`` calls
    between two CUDA events, queued behind a device-side sleep so that the
    host's launches stay outside them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(n_bytes: float, n_ops: float) -> tuple:
    b = n_bytes / PEAK_BYTES_PER_S * 1e3
    o = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def _rel(outs, refs) -> tuple:
    """(max abs error, that over max|ref|) over matching outputs."""
    abs_err = rel = 0.0
    for o, r in zip(outs, refs):
        e = float((o.float() - r.float()).abs().max())
        abs_err = max(abs_err, e)
        rel = max(rel, e / max(float(r.abs().max()), 1e-30))
    return abs_err, rel


class _Forms:
    """The timed forms and their record rows."""

    def __init__(self):
        self.rows = []

    def add(self, form, kernel, fn, plain, n_bytes, n_ops, err, ok, tol, library=None,
            **extra):
        if not ok:
            raise SystemExit(f"microbench_lookup: {form} ({kernel}) misses its plain version: "
                             f"error {err:.3e} ({tol})")
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        row = {"form": form, "kernel": kernel, "ms": time_ms(fn),
               "plain_ms": time_ms(plain, PLAIN_REPS), "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by, "max_err": err, "tol": tol, **extra}
        if library is not None:
            row["library_ms"] = time_ms(library)
        self.rows.append(row)
        lib = "" if row["library_ms"] is None else f", library {row['library_ms']:.4f}"
        print(f"{form:44s} {kernel:6s} {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}{lib}, "
              f"bound {bound_ms:.4f} {bound_by}); err {err:.2e} ({tol})", flush=True)


def _k2_worst(got, ref, mag) -> tuple:
    """K2's tables against the plain version's float32 terms summed in
    float64: (max abs error, max per cell |error| / sum|terms|)."""
    abs_err = worst = 0.0
    for g, r, m in zip(got[0] + got[1], ref[0] + ref[1], mag[0] + mag[1]):
        d = (g.double() - r).abs()
        abs_err = max(abs_err, float(d.max()))
        worst = max(worst, float((d / (m + 1e-30)).max()))
    return abs_err, worst


def _run(device="cuda", seed: int = 0) -> dict:
    import torch

    from .._device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("microbench_lookup times the card")
    with torch.no_grad():
        return _measure(dev, seed)


def _measure(dev, seed: int) -> dict:
    import torch

    from ..ops import KERNELS, grid_sample, pdf, vm_lookup
    from ..ops.pdf import _dists
    from ..presets import production_model

    model = production_model(device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    tables = model.lookup_tables(params)
    planes, lines = tables.fine_planes, tables.fine_lines
    lines32 = [t.float().contiguous() for t in lines]
    n_d = model.cfg.density_n_comp
    r, th, ph, sel = ray_coherent_coords(seed, dev)
    xyz = (r, th, ph)
    coords = torch.stack([r, th, ph, sel.float()], -1).contiguous()
    n = coords.shape[0]
    forms = _Forms()

    # the line and plane forwards of each decomposition
    for i in range(3):
        m0, m1 = vm_lookup.MAT_MODE[i]
        z = xyz[vm_lookup.VEC_MODE[i]]
        s, l, c = lines[i].shape
        out_bytes = 4 * n * c
        for kern, name, table, tag in ((grid_sample.sample_line, "K16", lines32[i], "float32"),
                                       (vm_lookup.sample_line_nograd, "K15", lines[i], "bf16")):
            plain = {"K16": grid_sample.sample_line_plain,
                     "K15": vm_lookup.sample_line_nograd_plain}[name]
            got, ref = kern(table, z, sel), plain(table, z, sel)
            lib = library_grid_sample(table, None, z, sel)
            err, rel = _rel([got], [ref])
            lib_err = float((lib().t() - got).abs().max())
            ok = rel <= REL_TOL and lib_err <= REL_TOL * float(got.abs().max())
            forms.add(f"line {i} ({s}, {l}, {c}) {tag} forward", name,
                      lambda k=kern, t=table, z=z: k(t, z, sel),
                      lambda p=plain, t=table, z=z: p(t, z, sel),
                      _nbytes(table, z, sel) + out_bytes, n * (3 * c + 15), err, ok,
                      f"rel {REL_TOL:.0e} of max|plain|; the library within it", library=lib,
                      library_err=lib_err)
        _, h, w, c = planes[i].shape
        x, y = xyz[m0], xyz[m1]
        got = vm_lookup.sample_plane_nograd(planes[i], x, y, sel)
        ref = vm_lookup.sample_plane_nograd_plain(planes[i], x, y, sel)
        lib = library_grid_sample(planes[i], x, y, sel)
        err, rel = _rel([got], [ref])
        lib_err = float((lib().t() - got).abs().max())
        forms.add(f"plane {i} ({s}, {h}, {w}, {c}) bf16 forward", "K15",
                  lambda p=planes[i], x=x, y=y: vm_lookup.sample_plane_nograd(p, x, y, sel),
                  lambda p=planes[i], x=x, y=y: vm_lookup.sample_plane_nograd_plain(p, x, y, sel),
                  _nbytes(planes[i], x, y, sel) + out_bytes, n * (4 * 2 * c + 30), err,
                  rel <= REL_TOL and lib_err <= REL_TOL * float(got.abs().max()),
                  f"rel {REL_TOL:.0e} of max|plain|; the library within it", library=lib,
                  library_err=lib_err)

    # K1 with the hat lines and with the float32 pair: the whole fused field
    n_app = sum(model.cfg.app_n_comp)
    field_bytes = _nbytes(coords, *planes, *lines) + n * (1 + n_app) * 4
    field_ops = n * sum(p.shape[-1] for p in planes) * 11
    modes = {"linear (0)": vm_lookup.LINEAR, "hat (1)": vm_lookup.HAT,
             "linear, bf16 corner gradient (2)": vm_lookup.LINEAR_BF16_GRAD}
    for label in ("hat (1)", "linear (0)"):
        mode = [modes[label]] * 3
        got = vm_lookup.field_fwd(coords, planes, lines, n_d, mode)
        ref = vm_lookup.field_fwd_plain(coords, planes, lines, n_d, mode)
        err, rel = _rel(got, ref)
        forms.add(f"field forward, lines {label}", "K1",
                  lambda m=mode: vm_lookup.field_fwd(coords, planes, lines, n_d, m),
                  lambda m=mode: vm_lookup.field_fwd_plain(coords, planes, lines, n_d, m),
                  field_bytes, field_ops, err, rel <= REL_TOL, f"rel {REL_TOL:.0e} of max|plain|")

    # K2 in the three line modes, on cotangents from the seed
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    d_dens = torch.randn(n, generator=gen, device=dev)
    d_app = torch.randn(n, n_app, generator=gen, device=dev)
    n_ch = sum(p.shape[-1] for p in planes)
    for label, m in modes.items():
        mode = [m] * 3
        mask = vm_lookup.field_fwd(coords, planes, lines, n_d, mode, with_mask=True)[2]
        args = (coords, planes, lines, d_dens, d_app, mask, n_d, mode)
        got = vm_lookup.field_bwd(*args)
        ref = vm_lookup.field_bwd_plain(*args, accumulate=torch.float64)
        mag = vm_lookup.field_bwd_plain(*args, magnitude=True, accumulate=torch.float64)
        err, worst = _k2_worst(got, ref, mag)
        del ref, mag
        forms.add(f"field backward, line mode {label}", "K2",
                  lambda a=args: vm_lookup.field_bwd(*a),
                  lambda a=args: vm_lookup.field_bwd_plain(*a),
                  _nbytes(coords, *planes, *lines, d_dens, d_app, mask)
                  + sum(4 * t.numel() for t in planes + lines), n * n_ch * 18, err,
                  worst <= K2_TOL, f"per cell {K2_TOL:.0e} x sum|terms|", per_cell=worst)

    # the merge: K4 on the production coarse pass of the stream's rays (K7
    # and K3 make its inputs), with sorted uniforms given (no draw)
    o, d, _ = (torch.as_tensor(a, device=dev) for a in ray_coherent_rays(seed))
    coarse_z = model.sample_depths_exp(B, N_COARSE, dev)
    c_norm = KERNELS.chart(o, d, coarse_z, model.coordinates, 2)
    c_feat = KERNELS.density(c_norm, tables.coarse_planes, tables.coarse_lines).reshape(
        B, N_COARSE)
    coarse_dists = _dists(coarse_z)
    u = torch.sort(torch.rand(B, N_FINE, generator=gen, device=dev), -1).values
    act = (model.cfg.density_shift, model.cfg.distance_scale, model.cfg.fea2dense_act)
    far = model.near_far[1]
    k4_bytes = _nbytes(c_feat, coarse_z, coarse_dists, u)
    for merge in (True, False):
        args = (c_feat, coarse_z, coarse_dists, N_FINE, u, merge, *act)
        got = pdf.resample(*args)
        ref = pdf.resample_plain(*args)
        err = _rel(got, ref)[0]
        n_out = got[0].shape[1]
        extra = {}
        library = None
        ok = err <= K4_TOL * far
        if merge:
            fine = pdf.resample(c_feat, coarse_z, coarse_dists, N_FINE, u, False, *act)[0]
            library = (lambda f=fine: torch.sort(torch.cat([coarse_z, f], -1), -1))
            same = bool(torch.equal(library().values, got[0]))
            extra["merge_equals_sort"] = same
            ok = ok and same
        forms.add(f"resample, {'merged' if merge else 'unmerged'} ({N_COARSE} + {N_FINE})",
                  "K4", lambda a=args: pdf.resample(*a), lambda a=args: pdf.resample_plain(*a),
                  k4_bytes + 2 * 4 * B * n_out, B * (N_COARSE * 30 + n_out * 20), err, ok,
                  f"depths {K4_TOL:.0e} x far; merged = torch.sort bit for bit", library=library,
                  **extra)
    return {"n_points": n, "rays": B, "samples": S, "grid": model.grid_size,
            "planes": [list(p.shape) for p in planes], "lines": [list(t.shape) for t in lines],
            "reps": REPS, "platform": dev.type, "device": device_name(dev),
            "forms": forms.rows}


def main(argv=None):
    from .._device import resolve_device

    del argv  # JAX's tool takes no arguments
    resolve_device("cuda")
    rec = _run()
    write_results("microbench_lookup", rec)
    print(json.dumps(rec, indent=1), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
