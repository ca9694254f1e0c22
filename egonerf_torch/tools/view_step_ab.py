"""Render and training-step times of one checkout, on one CUDA card, for
comparing two revisions in turns (a, b, b, a), each in its own process:

    python3 egonerf_torch/tools/view_step_ab.py <checkout root> [label]

The checkout's own package and ``chip_smoke`` are imported (so an
archive of another revision measures that revision) and its kernels
built.  Measured, with seeded random weights as ``chip_smoke`` makes them:
three 2000x1000 views (s/image by the host clock around a synchronised
``Renderer.render_view``, after a warm one) and 20 training steps (CUDA
events, after 5 warm ones; median, min, max) at the indoor production
shape, then its steps culled at train_keep 128 with the tie-break
(``chip_smoke``'s phase 6c) and under ``theta_importance`` with the
device sampler (the procedural scene's flat layout), the same views and
steps at the outdoor shape on the procedural scene with its background at
infinity, and three 1000x500 views and 20 steps of the TensoRF
``tensorf_bench`` shape with a 128^3 mask of half occupancy.  Each step
kind is also profiled over 5 steps: its device operations (kernels,
copies, sets) and busy ms a step, the device ms a step of the torch ops in
the sampler's range (the draws and the gather; a kernel launched through
``ctypes`` is attributed to no range), and the ms a launch of the
resampling, draw and theta kernels.
Every line starts with ``AB <label>``; the last names the card and its
power limit.
"""
import os
import sys
import time

# the resampling, draw and theta sampler kernels, by their device names
DRAW_KERNELS = ("resample_kernel", "resample_score_kernel", "sorted_uniform_kernel",
                "theta_ids_kernel", "theta_batch_kernel")


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    tag = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from egonerf_torch import _build, presets
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.data.ray_utils import get_ray_directions_360
    from egonerf_torch.models.alphamask import AlphaGridMask
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("view_step_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    _build.build_all()
    runs = os.path.join(root, "build", "view_step_ab")
    c2w = np.eye(4, dtype=np.float32)[:3]

    def views(label, renderer, params, dirs, n=3):
        renderer.set_directions(dirs)
        with torch.no_grad():
            renderer.render_view(params, c2w)
            torch.cuda.synchronize()
            ts = []
            for _ in range(n):
                t0 = time.time()
                renderer.render_view(params, c2w)
                torch.cuda.synchronize()
                ts.append(time.time() - t0)
        print(f"AB {tag} {label} s/image: " + " ".join(f"{t:.4f}" for t in ts), flush=True)

    def steps(label, trainer, n=20, warm=5):
        for i in range(1, warm + 1):
            trainer.train_step(i)
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
        for k, (a, b) in enumerate(ev):
            a.record()
            trainer.train_step(warm + 1 + k)
            b.record()
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(b) for a, b in ev)
        print(f"AB {tag} {label} step ms: median {ms[n // 2]:.4f} min {ms[0]:.4f} max "
              f"{ms[-1]:.4f}", flush=True)
        profiled(label, trainer)

    def profiled(label, trainer, n=5):
        from torch.profiler import ProfilerActivity, profile, record_function

        s = trainer.sampler
        draw = s.next_batch

        def ranged():
            with record_function("sampler"):
                return draw()
        s.next_batch = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for k in range(n):
                    trainer.train_step(10 ** 4 + k)
                torch.cuda.synchronize()
        finally:
            del s.next_batch
        cuda = torch.autograd.DeviceType.CUDA
        rows = [e for e in prof.key_averages() if e.device_type == cuda
                and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
        ranges = [e for e in prof.events() if e.name == "sampler"
                  and e.device_type == torch.autograd.DeviceType.CPU]
        sampler_us = sum(e.device_time_total for e in ranges)
        kernels = "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3 / e.count:.4f} ms x{e.count / n:g}"
            for e in rows if any(k in e.key for k in DRAW_KERNELS))
        print(f"AB {tag} {label} profile: {sum(e.count for e in rows) / n:.1f} device "
              f"operations a step, busy {sum(e.self_device_time_total for e in rows) / 1e3 / n:.3f}"
              f" ms a step, the sampler's torch ops {sampler_us / 1e3 / n:.4f} ms a step; "
              f"{kernels}", flush=True)

    def trainer_of(overrides, name):
        return Trainer(load_config(overrides=overrides(
            basedir=runs, expname=name, n_iters=10 ** 9, N_vis=0,
            progress_refresh_rate=10 ** 9)), device=dev)

    dirs = get_ray_directions_360(*cs.IMAGE_HW).reshape(-1, 3)
    model = presets.production_model(device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(cs.SEED))
    views("indoor", Renderer(model, chunk=presets.EVAL_CHUNK, **presets.RENDER), params, dirs)
    del model, params
    indoor = trainer_of(presets.production_overrides, "indoor")
    steps("indoor", indoor)
    indoor.cfg.train_keep = cs.CULL_TRAIN_KEEP
    steps(f"culled (train_keep {cs.CULL_TRAIN_KEEP}, tie-break)", indoor)
    del indoor
    torch.cuda.empty_cache()
    steps("theta", trainer_of(lambda **kw: presets.production_overrides(
        sampling_method="theta_importance", theta_importance_lambda=cs.THETA_LAMBDA, **kw),
        "theta"))
    torch.cuda.empty_cache()

    out = trainer_of(presets.outdoor_overrides, "outdoor")
    scene = dict(cs.ENV_SCENE, near_far=out.cfg.near_far)
    out.set_datasets(SyntheticEgoDataset(split="train", **scene),
                     SyntheticEgoDataset(split="test", is_stack=True, **scene))
    views("outdoor", Renderer(out.model, chunk=presets.EVAL_CHUNK, **presets.RENDER),
          out.params, dirs)
    steps("outdoor", out)
    del out
    torch.cuda.empty_cache()

    tf = trainer_of(presets.tensorf_mask_overrides, "tensorf")
    tf_scene = dict(presets.TENSORF_BENCH_SCENE, near_far=tf.cfg.near_far)
    tf.set_datasets(SyntheticEgoDataset(split="train", **tf_scene),
                    SyntheticEgoDataset(split="test", is_stack=True, **tf_scene))
    tf.model.alpha_mask = AlphaGridMask(cs.half_mask(cs.TF_MASK_RESO, dev), device=dev)
    views("tensorf", Renderer.from_config(tf.model, tf.cfg, tf.white_bg), tf.params,
          get_ray_directions_360(*cs.TF_IMAGE_HW).reshape(-1, 3))
    steps("tensorf", tf)
    print(f"AB {tag} card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
