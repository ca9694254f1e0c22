"""The port's data parallelism (``egonerf_torch/parallel/mesh.py``) on two
CPU processes over gloo, against the JAX package's single-device step of
tests/test_parallel.py and against the port's own single-process step,
render and trainer.

Every worker gets a timeout of its own, so that a hang fails its test.
Shapes are those of tests/test_parallel.py's ``setup()``: N_voxel 24^3,
n_lamb 4/8, app_dim 12, featureC 32, 64 rays of 16 + 16 samples, Adam at
1e-2 (optax.adam's defaults)."""
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egonerf_tpu.ops.merge import sorted_uniform as jax_sorted_uniform
from egonerf_tpu.train import checkpoint as jax_ckpt
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.models import EgoNeRF, FieldConfig, StepKey, params_from_jax
from egonerf_torch.ops import merge
from egonerf_torch.render.renderer import Renderer
from egonerf_torch.train.config import load_config
from egonerf_torch.train.trainer import Trainer

from test_parallel import make_step, setup
from test_torch_train import _tiny_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AABB = np.array([[-4.0] * 3, [4.0] * 3], np.float32)
SHAPE = dict(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12, view_pe=2, fea_pe=2,
             feature_c=32)
N_STEPS = 3
WORLD = 2
# the port's own draws: the step generator's seed, K5's key seed
GEN_SEED, KEY_SEED = 11, 7
# the culled variants of tests/test_parallel.py: keep 24 of 32, the
# tie-break, and the Gumbel keep with a full step every other step
VARIANTS = {"unculled": {}, "culled": dict(train_keep=24),
            "gumbel": dict(train_keep=24, train_cull_tau=1.0)}
RENDER_RAYS = 70  # not a multiple of chunk x world: the padded tail

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and the CPU's scatter-adds are in a fixed order on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, port, repo, job, data = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, repo)
torch.set_num_threads(1)
from egonerf_torch.parallel import mesh as pm
if job == "trainer":
    # as under torch.distributed.run: the group from RANK, WORLD_SIZE, ...
    assert pm.launched() and pm.init_from_env("cpu") and pm.process_count() == 2
else:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)

if job == "steps":
    from egonerf_torch.coords.yinyang import YinYangSphericalCoords
    from egonerf_torch.models import EgoNeRF, FieldConfig, StepKey, params_from_jax
    from egonerf_torch.render.renderer import Renderer
    cfg = json.loads(open(os.path.join(data, "cfg.json")).read())
    inp = dict(np.load(os.path.join(data, "inputs.npz")))
    aabb = np.asarray(cfg["aabb"], np.float32)
    coords = YinYangSphericalCoords(aabb, exp_r=True, N_voxel=24 ** 3, r0=0.05, interval_th=True)
    model = EgoNeRF(aabb, coords.resolution, coords, FieldConfig(**cfg["shape"]),
                    near_far=(0.05, 4.0), device="cpu")
    flat = {k[2:]: v for k, v in inp.items() if k.startswith("p:")}
    mesh = pm.make_mesh()
    assert mesh.world == 2 and mesh.rank == rank and pm.is_lead_process() == (rank == 0)
    rays, target = torch.from_numpy(inp["rays"]), torch.from_numpy(inp["target"])
    lo, hi = mesh.shard(rays.shape[0])
    out = {}

    def run(name, forward_kw):
        model.load_state_dict(params_from_jax(flat, device="cpu"))
        params = model.params()
        mesh.broadcast_(list(params.values()))
        opt = torch.optim.Adam(params.values(), lr=1e-2)
        gen = torch.Generator().manual_seed(cfg["gen_seed"])
        losses = []
        for i in range(cfg["n_steps"]):
            kw = forward_kw(i, gen)
            res = model.forward(params, rays[lo:hi], is_train=True, n_coarse=16, n_fine=16,
                                **kw)
            loss = torch.mean((res["rgb"] - target[lo:hi]) ** 2)
            opt.zero_grad()
            loss.backward()
            loss = loss.detach().clone()
            mesh.mean_(pm.grads_of(params) + [loss])
            opt.step()
            losses.append(float(loss))
        out[f"{name}:losses"] = np.asarray(losses)
        for k, p in params.items():
            out[f"{name}:{k}"] = p.detach().numpy().copy()

    # JAX's draws of the global batch, fed: this rank's rows
    run("jax", lambda i, gen: dict(jitter=torch.from_numpy(inp[f"jitter{i}"][lo:hi]),
                                   u=torch.from_numpy(inp[f"u{i}"][lo:hi])))
    # the port's own draws, keyed by the global batch
    for name, cull in cfg["variants"].items():
        def kw(i, gen, cull=cull):
            c = dict(cull)
            if c.get("train_cull_tau") and i % 2 == 0:
                c = {}
            return dict(key=StepKey(gen, cfg["key_seed"], i, ray0=lo, n_global=rays.shape[0]),
                        **c)
        run(name, kw)

    # the sharded renders, on the initial weights
    model.load_state_dict(params_from_jax(flat, device="cpu"))
    params = model.params()
    r = Renderer(model, chunk=32, mesh=mesh, n_coarse=16, n_fine=16)
    with torch.no_grad():
        o = r.render_rays(params, inp["render_rays"])
        r.set_directions(inp["render_rays"][:, 3:6])
        v = r.render_view(params, inp["c2w"])
    for k in ("rgb", "depth"):
        out[f"rays:{k}"] = o[k].numpy()
        out[f"view:{k}"] = v[k].numpy()
    np.savez(os.path.join(data, f"out{rank}.npz"), **out)
else:
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer
    cfg = load_config(overrides=json.loads(open(os.path.join(data, "cfg.json")).read()))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.mesh is not None and trainer.mesh.world == 2
    assert trainer.lead == (rank == 0) and trainer.log.enabled == trainer.lead
    trainer.train()
    np.savez(os.path.join(data, f"out{rank}.npz"),
             **{k: p.detach().numpy() for k, p in trainer.params.items()})
    print(f"TRAINER_OK rank={rank} reso={tuple(trainer.reso_cur)}", flush=True)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, job: str, data, timeout: float):
    """The worker as ranks 0 and 1; each is killed at ``timeout`` s, which
    fails the test."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(WORLD))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), REPO, job,
                               str(data)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {job} worker did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs, [dict(np.load(os.path.join(data, f"out{r}.npz"))) for r in range(WORLD)]


def _port_model(flat):
    coords = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=24 ** 3, r0=0.05,
                                    interval_th=True)
    model = EgoNeRF(AABB, coords.resolution, coords, FieldConfig(**SHAPE),
                    near_far=(0.05, 4.0), device="cpu")
    model.load_state_dict(params_from_jax(flat, device="cpu"))
    return model


def _single_process(flat, rays, target, forward_kw):
    """The port's unsharded step on the whole batch: (losses, params)."""
    model = _port_model(flat)
    params = model.params()
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    gen = torch.Generator().manual_seed(GEN_SEED)
    losses = []
    for i in range(N_STEPS):
        out = model.forward(params, torch.from_numpy(rays), is_train=True, n_coarse=16,
                            n_fine=16, **forward_kw(i, gen))
        loss = torch.mean((out["rgb"] - torch.from_numpy(target)) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return np.asarray(losses), {k: p.detach().numpy() for k, p in params.items()}


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Two gloo ranks run every sharded step and render of this file once:
    JAX's fed draws, the port's own draws in the three cull variants, and
    the renders.  Also JAX's single-device steps on the same draws."""
    tmp = tmp_path_factory.mktemp("pod")
    model, params, rays, target = setup()
    flat = jax_ckpt._flatten(params)
    inp = {f"p:{k}": np.asarray(v) for k, v in flat.items()}
    inp.update(rays=rays, target=target)
    for i in range(N_STEPS):
        k_coarse, k_pdf = jax.random.split(jax.random.PRNGKey(i))
        inp[f"jitter{i}"] = np.asarray(jax.random.uniform(k_coarse, (64, 16)))
        inp[f"u{i}"] = np.asarray(jax_sorted_uniform(k_pdf, (64, 16)))
    rng = np.random.default_rng(5)
    d = rng.normal(size=(RENDER_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, (RENDER_RAYS, 3)).astype(np.float32)
    inp["render_rays"] = np.concatenate([o, d], -1)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = [0.1, -0.05, 0.02]
    inp["c2w"] = c2w
    np.savez(tmp / "inputs.npz", **inp)
    (tmp / "cfg.json").write_text(json.dumps(dict(
        aabb=AABB.tolist(), shape=SHAPE, gen_seed=GEN_SEED, key_seed=KEY_SEED,
        n_steps=N_STEPS, variants=VARIANTS)))
    _, outs = _run_pair(tmp, "steps", tmp, timeout=240)

    # JAX's single-device steps (tests/test_parallel.py), key PRNGKey(i)
    tx = optax.adam(1e-2)
    step = jax.jit(make_step(model, tx))
    p, s = params, tx.init(params)
    jax_losses = []
    for i in range(N_STEPS):
        p, s, loss = step(p, s, jnp.asarray(rays), jnp.asarray(target), jax.random.PRNGKey(i))
        jax_losses.append(float(loss))
    return dict(inp=inp, flat=flat, outs=outs, jax_losses=np.asarray(jax_losses),
                jax_params=jax_ckpt._flatten(p))


def _params_of(out, name):
    return {k[len(name) + 1:]: v for k, v in out.items()
            if k.startswith(name + ":") and k != name + ":losses"}


@pytest.mark.parametrize("name", ["jax"] + sorted(VARIANTS))
def test_ranks_hold_identical_parameters(pod, name):
    """After the all-reduce every rank applies the same update to the same
    values: the ranks' parameters and losses are bit-identical."""
    a, b = (_params_of(o, name) for o in pod["outs"])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(pod["outs"][0][f"{name}:losses"],
                                  pod["outs"][1][f"{name}:losses"])


def test_sharded_step_matches_jax_single_device(pod):
    """Two ranks of 32 rays on JAX's draws of the 64-ray batch against JAX's
    single-device step (tests/test_parallel.py's setup and step, three
    steps): the losses within rtol 2e-4 and the parameters within atol
    5e-3, the limits JAX holds its own sharded step to (float32 sums in
    another order, bf16 plane gradients scatter-added in JAX, and Adam's
    normalisation of near-zero moments)."""
    out = pod["outs"][0]
    np.testing.assert_allclose(out["jax:losses"], pod["jax_losses"], rtol=2e-4)
    got = _params_of(out, "jax")
    from egonerf_torch.models import params_to_jax

    got = params_to_jax({k: torch.from_numpy(v) for k, v in got.items()})
    for k, want in pod["jax_params"].items():
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=0, atol=5e-3, err_msg=k)


def _port_draws(cull):
    def kw(i, gen):
        c = dict(cull)
        if c.get("train_cull_tau") and i % 2 == 0:
            c = {}
        return dict(key=StepKey(gen, KEY_SEED, i), **c)
    return kw


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_sharded_step_matches_single_process(pod, name):
    """Two ranks on the port's own draws (the generator's drawn for the
    global batch and sliced, K5's keyed by the global ray index) against
    the port's single-process step on all 64 rays: unculled, culled to 24
    (tie-break) and the Gumbel keep with a full step every other step.  The
    draws are the same, so only the sum's order differs (two half-batch
    means averaged, and GEMMs of 32 rows blocked otherwise than of 64),
    which Adam's normalisation carries to the parameters of near-zero
    moments: losses rtol 1e-6, parameters atol 1e-5, a thousandth of the
    learning rate (observed: 1e-7 and up to 2.4e-6)."""
    inp = pod["inp"]
    losses, params = _single_process(pod["flat"], inp["rays"], inp["target"],
                                     _port_draws(VARIANTS[name]))
    out = pod["outs"][0]
    np.testing.assert_allclose(out[f"{name}:losses"], losses, rtol=1e-6)
    got = _params_of(out, name)
    for k, want in params.items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5, err_msg=k)


def test_shard_draws_are_the_global_batch_rows():
    """A shard's key draws the global batch's rows: the jitter and cull
    uniforms of the step's generator, and K5's sorted uniforms at the
    shard's ray offset; the generator ends in the same state."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    whole = StepKey(g1, 5, 9).rand(64, 16, "cpu")
    part = StepKey(g2, 5, 9, ray0=32, n_global=64).rand(32, 16, "cpu")
    assert torch.equal(part, whole[32:])
    assert torch.equal(g1.get_state(), g2.get_state())
    for k in (1, 17, 32):
        np.testing.assert_array_equal(merge.exp_draws(64 - k, 9, 5, 9, "cpu", ray0=k).numpy(),
                                      merge.exp_draws(64, 9, 5, 9, "cpu")[k:].numpy())
        assert torch.equal(merge.sorted_uniform(64 - k, 8, 5, 9, "cpu", ray0=k),
                           merge.sorted_uniform(64, 8, 5, 9, "cpu")[k:])


@pytest.mark.parametrize("kind", ["rays", "view"])
def test_sharded_render_matches_single_process(pod, kind):
    """``render_rays`` and ``render_view`` with each rank rendering its
    chunks (70 rays, chunk 32, padded to 128) and the outputs gathered: on
    every rank, bit for bit the single-process render (the same chunks
    through the same deterministic forward)."""
    inp = pod["inp"]
    model = _port_model(pod["flat"])
    params = model.params()
    r = Renderer(model, chunk=32, n_coarse=16, n_fine=16)
    with torch.no_grad():
        if kind == "rays":
            want = r.render_rays(params, inp["render_rays"])
        else:
            r.set_directions(inp["render_rays"][:, 3:6])
            want = r.render_view(params, inp["c2w"])
    for out in pod["outs"]:
        for k in ("rgb", "depth"):
            np.testing.assert_array_equal(out[f"{kind}:{k}"], want[k].numpy(), err_msg=k)


def test_trainer_across_an_upsample(tmp_path):
    """The whole ``Trainer`` on two ranks, crossing an upsample (16^3 ->
    24^3 at step 3) and an alpha-mask bake: the ranks end with
    bit-identical parameters, within atol 1e-4 of the single-process
    trainer (Adam on sums in another order over 8 steps), and the lead
    alone writes the log folder (``pod.npz``, ``metrics.jsonl``)."""
    over = _tiny_cfg(tmp_path / "log", expname="pod", n_coarse=12, n_fine=12, batch_size=256,
                     n_iters=8, N_voxel_init=16 ** 3, N_voxel_final=24 ** 3,
                     upsamp_list="[3]", update_AlphaMask_list="[5]", N_vis=0,
                     eval_chunk=256, progress_refresh_rate=2)
    data = tmp_path / "data"
    data.mkdir()
    (data / "cfg.json").write_text(json.dumps(over))
    logs, outs = _run_pair(data, "trainer", data, timeout=240)
    for r, log in enumerate(logs):
        assert re.search(rf"TRAINER_OK rank={r} reso=\(", log), log[-2000:]
    assert sorted(outs[0]) == sorted(outs[1])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    logdir = tmp_path / "log" / "pod"
    assert (logdir / "pod.npz").exists() and (logdir / "metrics.jsonl").exists()
    assert sorted(os.listdir(tmp_path / "log")) == ["pod"]

    alone = Trainer(load_config(overrides=dict(over, basedir=str(tmp_path / "alone"))),
                    device="cpu")
    alone.train()
    for k, p in alone.params.items():
        np.testing.assert_allclose(outs[0][k], p.detach().numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
    lines = [json.loads(l) for l in open(logdir / "metrics.jsonl")]
    want = [json.loads(l) for l in open(tmp_path / "alone" / "pod" / "metrics.jsonl")]
    assert [(l["tag"], l["step"]) for l in lines] == [(l["tag"], l["step"]) for l in want]
    np.testing.assert_allclose([l["value"] for l in lines], [l["value"] for l in want],
                               rtol=1e-4)


def test_shard_losses_average_to_the_batch_loss(tmp_path):
    """``Trainer.loss`` on the two halves of a batch, each with the batch's
    count of nonzero depths and ``shards=2``, averages to the loss of the
    whole batch: the MSE and entropy are means over the rays, the depth
    term a ratio of sums that takes the global count (some depths are 0,
    and the halves hold different numbers of them).  rel 1e-6: float32
    sums in another order."""
    trainer = Trainer(load_config(overrides=_tiny_cfg(
        tmp_path, use_depth=True, depth_lambda=0.5, entropy_weight=1e-2, iter_ignore_entropy=0,
        L1_weight_initial=1e-3)), device="cpu")
    rng = np.random.default_rng(2)
    n, s = 64, 12
    out = {"rgb": torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32)),
           "depth": torch.from_numpy(rng.uniform(0.5, 3.0, n).astype(np.float32)),
           "alpha": torch.from_numpy(rng.uniform(size=(n, s)).astype(np.float32))}
    rgbs = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    depth = torch.from_numpy(np.where(np.arange(n) % 3 == 0, 0.0,
                                      rng.uniform(0.5, 3.0, n)).astype(np.float32))
    depth[:5] = 0.0  # the first half holds more zeros than the second
    it = 3
    assert trainer.entropy_on(it) and trainer.depth_weight_at(it) > 0
    whole, whole_mse = trainer.loss(out, rgbs, it, depth)
    count = torch.sum((depth != 0).float())
    halves = [trainer.loss({k: v[lo:lo + 32] for k, v in out.items()}, rgbs[lo:lo + 32], it,
                           depth[lo:lo + 32], depth_count=count, shards=2)
              for lo in (0, 32)]
    assert float(sum(h[0] for h in halves) / 2) == pytest.approx(float(whole), rel=1e-6)
    assert float(sum(h[1] for h in halves) / 2) == pytest.approx(float(whole_mse), rel=1e-6)


def test_launch_environment(monkeypatch):
    """What ``python -m torch.distributed.run`` sets decides the launch:
    without RANK, WORLD_SIZE and LOCAL_RANK there is none and no group is
    joined; with them ``cuda`` means ``cuda:LOCAL_RANK``, the CPU stays the
    CPU, and the backend is NCCL on a card and gloo on the CPU."""
    from egonerf_torch.parallel import mesh as pm

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not pm.launched() and pm.init_from_env("cpu") is False
    assert pm.rank_device("cuda") == torch.device("cuda") and pm.process_count() == 1
    assert pm.is_lead_process() and pm.make_mesh(None) is None and pm.make_mesh([1]) is None
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pm.launched()
    assert pm.rank_device("cuda") == torch.device("cuda", 1)
    assert pm.rank_device("cuda:0") == torch.device("cuda", 0)
    assert pm.rank_device("cpu") == torch.device("cpu")
    assert pm.backend_for("cuda:1") == "nccl" and pm.backend_for("cpu") == "gloo"
    assert pm.pad_to_multiple(70, 64) == 128 and pm.pad_to_multiple(64, 64) == 64
