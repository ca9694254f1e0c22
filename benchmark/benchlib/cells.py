"""The two traffic mixes' driver: a closed loop with one client that
trains (``train``) or renders full views (``render``) through the
program's own entry points, then holds what the timed path produced
against the plain reference.

A run: set-up (the scene written from the seed, then the kernels' build
or load, the program's trainer or model, the benchmark's weights installed,
the first steps or a warm view), the window of ``seconds``, with
``trace`` a profiled segment after it, then the program's state freed and
the reference's check.  The program is ``egonerf_torch``; everything else
here is the benchmark's own.
"""
from __future__ import annotations

import gc
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

from benchlib import check, costs, scene, trace, weights
from benchlib.spec import Cell, families
from benchref import egonerf as ref

ADAM_BETA1 = 0.9


def cfg_seed(seed: int) -> int:
    """The program's seed for the benchmark's: its counter-based draws key
    on 32 bits."""
    return int(seed) % 2 ** 31


class Spans:
    """The benchmark's own spans around its calls into the program, in
    seconds by name."""

    def __init__(self):
        self.s: Dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stamps:
    """Completion times of the window's units: CUDA events recorded on the
    stream after each unit (the device's clock), or the host's clock on the
    CPU, which only the tests use."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> np.ndarray:
        m = self.marks
        if self.cuda:
            return np.array([a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])])
        return np.array([(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])])


def overrides(cell: Cell, seed: int, datadir: str, basedir: str) -> dict:
    """The program's configuration: the configuration file's keys with the
    scene's folder, a log folder and the seed."""
    return {**cell.config["overrides"], "datadir": datadir, "basedir": basedir,
            "expname": cell.name, "seed": cfg_seed(seed)}


def ref_config(cell: Cell) -> ref.RefConfig:
    return ref.RefConfig.from_overrides(cell.config["overrides"])


def shapes(cell: Cell, train: bool) -> costs.Shapes:
    o = cell.config["overrides"]
    rc = ref_config(cell)
    n_in = 2 * rc.view_pe * 3 + 2 * rc.fea_pe * rc.app_dim + 3 + rc.app_dim
    return costs.Shapes(
        rays=int(o["batch_size"] if train else o["eval_chunk"]), n_coarse=rc.n_coarse,
        n_fine=rc.n_fine, grid=tuple(ref.grid_size(rc.n_voxel)), n_sigma=tuple(rc.n_lamb_sigma),
        n_app=tuple(rc.n_lamb_sh), app_dim=rc.app_dim, n_shader_in=n_in,
        feature_c=rc.feature_c, envmap_h=rc.envmap_h, train=train)


def draw_weights(cell: Cell, seed: int, dev) -> Dict[str, torch.Tensor]:
    s = shapes(cell, True)
    w = cell.config["weights"]
    leaf = weights.shapes(s.grid, s.n_sigma, s.n_app, s.app_dim, s.n_shader_in, s.feature_c,
                          s.envmap_h)
    return weights.draw(leaf, seed, dev, float(w["density_std"]), float(w["app_std"]))


def _train_poses(cell: Cell, seed: int) -> np.ndarray:
    sc = cell.config["scene"]
    n_test = int(sc["n_test"])
    return scene.trajectory(sc["layout"], int(sc["n_train"]) + n_test, seed)[n_test:]


def first_gradient(adam: torch.optim.Adam, names: Dict[int, str]) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient as Adam took it in its first step, from its
    first moment (1 - beta1) g; zero where Adam holds no state."""
    out = {}
    for g in adam.param_groups:
        for p in g["params"]:
            m = adam.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = (torch.zeros_like(p) if m is None
                                 else m.detach() / (1.0 - ADAM_BETA1))
    return out


class Result:
    """A run's readings: the end-to-end metrics, the set-up's spans, the
    window's counts, the traced segment, the check's numbers, and what the
    check compared of the program's (``compared``: the shared inputs and
    the timed path's outputs)."""

    def __init__(self):
        self.metrics: Dict[str, float] = {}
        self.spans = Spans()
        self.counters: Dict[str, float] = {}
        self.trace: Optional[trace.Trace] = None
        self.numbers: Dict[str, float] = {}
        self.compared: Dict[str, object] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.scene_s = 0.0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def run_train(cell: Cell, seed: int, seconds: float, traced: bool, dev: torch.device,
              t_proc: float, tmp: str) -> Result:
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    res, tr = Result(), cell.traffic
    sc = cell.config["scene"]
    t = time.perf_counter()
    scn = scene.write_scene(os.path.join(tmp, "scene"), sc["layout"], int(sc["n_train"]),
                            int(sc["n_test"]), int(sc["height"]), int(sc["width"]), seed)
    res.scene_s = time.perf_counter() - t
    spans = res.spans
    if dev.type == "cuda":
        from egonerf_torch import _build

        with spans("build_s"):
            _build.build_all()
    cfg = load_config(overrides=overrides(cell, seed, scn.root, os.path.join(tmp, "log")))
    with spans("trainer_init_s"):
        trainer = Trainer(cfg, device=dev)
    w = draw_weights(cell, seed, dev)
    weights.install(trainer.params, w)
    names = {id(p): k for k, p in trainer.params.items()}
    refresh = int(cfg.progress_refresh_rate)

    def step(it: int):
        mse = trainer.train_step(it)
        if it % refresh == 0:
            mse.item()
        return mse

    # the first steps, through the window's own call, for the check
    n_check = int(tr["check_steps"])
    losses, grads = [], None
    for it in range(n_check):
        losses.append(step(it))
        if it == 0:
            grads = first_gradient(trainer.optimizer.adam, names)
    after = {k: p.detach().clone() for k, p in trainer.params.items()}
    it = n_check
    for _ in range(int(tr["warmup_steps"])):
        step(it)
        it += 1
    _sync(dev)
    res.metrics["setup_s"] = time.perf_counter() - t_proc - res.scene_s

    # the window
    stamps = Stamps(dev)
    t0 = time.perf_counter()
    n = 0
    while True:
        mse = trainer.train_step(it)
        stamps.mark()
        if it % refresh == 0:
            mse.item()
        it += 1
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    gaps = stamps.gaps_ms()
    batch = int(cfg.batch_size)
    res.attempted = n
    res.metrics["train_rays_per_s"] = batch * n / window_s
    res.counters.update(steps=n, window_s=window_s, step_ms_p50=float(np.percentile(gaps, 50)),
                        step_ms_p95=float(np.percentile(gaps, 95)), rays=batch * n)

    if traced:
        start_it = it

        def segment() -> int:
            for k in range(int(tr["trace_steps"])):
                with torch.profiler.record_function("bench.train_step"):
                    mse = trainer.train_step(start_it + k)
                if (start_it + k) % refresh == 0:
                    with torch.profiler.record_function("bench.read_loss"):
                        mse.item()
            return int(tr["trace_steps"])

        res.trace = trace.capture(segment, families(), dev.type)

    losses = [float(x) for x in losses]
    if dev.type == "cuda":
        res.memory_peak = int(torch.cuda.max_memory_allocated(dev))
    del trainer, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, from the same weights, scene and seed
    res.compared = {"scene": scn, "weights": w, "losses": losses, "grads": grads,
                    "after": after}
    r = reference_train(cell, scn, w, seed, ref_config(cell), dev)
    res.numbers = train_numbers(cell, res.compared, r)
    return res


def train_numbers(cell: Cell, prog: dict, r: ref.TrainResult) -> Dict[str, float]:
    """The cell's training numbers of ``prog`` (a run's ``compared``)
    against the reference's steps ``r``."""
    w = prog["weights"]
    nums = check.train_numbers(prog["losses"], r.losses, prog["grads"], r.grads,
                               {k: prog["after"][k] - w[k] for k in w},
                               {k: r.params[k] - w[k].to(r.params[k].dtype) for k in w})
    return {k: v for k, v in nums.items() if k in cell.limits}


def reference_train(cell: Cell, scn: scene.Scene, w, seed: int, rc: ref.RefConfig, dev,
                    tf32: bool = False, dtype=torch.float32) -> ref.TrainResult:
    """The reference's first steps on the scene's training rays."""
    h, wd = int(cell.config["scene"]["height"]), int(cell.config["scene"]["width"])
    dirs = torch.as_tensor(scene.ray_directions_360(h, wd).reshape(-1, 3), device=dev)
    poses = torch.as_tensor(scn.train_poses, device=dev)
    pixels = torch.as_tensor(scn.train_pixels(), device=dev)
    per = h * wd

    def rays_of_ids(ids):
        f, q = ids // per, ids % per
        rot = poses[f, :3, :3]
        d = torch.einsum("bij,bj->bi", rot, dirs[q])
        rays = torch.cat([poses[f, :3, 3], d], dim=-1)
        return rays, pixels[f, q].float() / 255.0

    chart = ref.Chart(scene.scene_aabb(scn.train_poses, rc.far), ref.grid_size(rc.n_voxel)[0],
                      rc.r0, dev, dtype)
    return ref.train_steps(w, rays_of_ids, len(scn.train_idx) * per, chart, rc, cfg_seed(seed),
                           int(cell.traffic["check_steps"]), tf32=tf32, dtype=dtype)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------
def run_render(cell: Cell, seed: int, seconds: float, traced: bool, dev: torch.device,
               t_proc: float, tmp: str) -> Result:
    from egonerf_torch.coords import make_coordinates
    from egonerf_torch.models import build_model
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.train.config import load_config

    res, tr = Result(), cell.traffic
    sc = cell.config["scene"]
    h, wd = int(sc["height"]), int(sc["width"])
    spans = res.spans
    if dev.type == "cuda":
        from egonerf_torch import _build

        with spans("build_s"):
            _build.build_all()
    cfg = load_config(overrides=overrides(cell, seed, os.path.join(tmp, "scene"),
                                          os.path.join(tmp, "log")))
    aabb = scene.scene_aabb(_train_poses(cell, seed), float(cfg.near_far[1]))
    poses = scene.view_poses(sc["layout"], int(tr["max_views"]), seed)
    dirs = scene.ray_directions_360(h, wd)
    w = draw_weights(cell, seed, dev)
    with spans("model_init_s"):
        coords = make_coordinates(cfg.coordinates_name, aabb, exp_r=cfg.exp_sampling,
                                  N_voxel=cfg.N_voxel_init, r0=cfg.r0,
                                  interval_th=cfg.interval_th)
        reso = coords.resolution or coords.N_to_reso(cfg.N_voxel_init)
        model = build_model(cfg, aabb, reso, coords, cfg.near_far, device=dev)
        params = model.params()
        weights.install(params, w)
        renderer = Renderer.from_config(model, cfg, False)
        # a warm view of two chunks: every shape the window uses
        renderer.set_directions(dirs.reshape(-1, 3)[: 2 * renderer.chunk])
        for v in renderer.render_view(params, poses[0]).values():
            v.cpu()
        renderer.set_directions(dirs)
        _sync(dev)
    res.metrics["setup_s"] = time.perf_counter() - t_proc

    def view(k: int) -> Dict[str, torch.Tensor]:
        out = renderer.render_view(params, poses[k % len(poses)])
        return {key: v.cpu() for key, v in out.items()}

    def traced_view(k: int) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function("bench.render_view"):
            out = renderer.render_view(params, poses[k % len(poses)])
        with torch.profiler.record_function("bench.copy_to_host"):
            return {key: v.cpu() for key, v in out.items()}

    outs = []
    t0 = time.perf_counter()
    while True:
        outs.append(view(len(outs)))
        done = time.perf_counter() - t0
        if done >= seconds:
            break
    res.attempted = len(outs)
    res.metrics["view_s"] = done / len(outs)
    res.counters.update(views=len(outs), window_s=done, rays=h * wd * len(outs))

    if traced:
        n_tr = int(tr["trace_views"])

        def segment() -> int:
            for k in range(n_tr):
                traced_view(k)
            return n_tr

        res.trace = trace.capture(segment, families(), dev.type)
    if dev.type == "cuda":
        res.memory_peak = int(torch.cuda.max_memory_allocated(dev))
    del model, renderer, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out, rays = sample_rays(outs, poses, dirs, int(tr["check_rays"]), seed, dev)
    res.compared = {"aabb": aabb, "weights": w, "rays": rays,
                    "out": {k: v.to(dev) for k, v in out.items()}}
    r = reference_render(cell, aabb, w, rays, dev)
    res.numbers = render_numbers(cell, res.compared["out"], r)
    return res


def reference_render(cell: Cell, aabb, w, rays, dev, tf32: bool = False,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's render of ``rays`` at the cell's chunk."""
    rc = ref_config(cell)
    chart = ref.Chart(aabb, ref.grid_size(rc.n_voxel)[0], rc.r0, dev, dtype)
    return ref.render_rays(w, rays, chart, rc, int(cell.config["overrides"]["eval_chunk"]),
                           tf32=tf32, dtype=dtype)


def render_numbers(cell: Cell, out, r) -> Dict[str, float]:
    """The cell's render numbers of ``out`` against the reference's ``r``."""
    nums = check.render_numbers(out, r)
    return {k: v for k, v in nums.items() if k in cell.limits}


def sample_rays(outs, poses, dirs, n: int, seed: int, dev):
    """``n`` rays of the window's views drawn from the seed, grouped by
    view: the program's outputs there, and the rays made from the poses and
    the directions."""
    rng = np.random.default_rng([seed, 2])
    v = np.sort(rng.integers(0, len(outs), n))
    q = rng.integers(0, dirs.shape[0] * dirs.shape[1], n)
    idx = [torch.as_tensor(q[v == a]) for a in range(len(outs))]
    out = {k: torch.cat([outs[a][k][idx[a]] for a in range(len(outs))]) for k in outs[0]}
    pose = torch.as_tensor(poses[v % len(poses)], device=dev)
    d = torch.as_tensor(dirs.reshape(-1, 3)[q], device=dev)
    rays_d = torch.einsum("bj,bij->bi", d, pose[:, :3, :3])
    return out, torch.cat([pose[:, :3, 3], rays_d], dim=-1)
