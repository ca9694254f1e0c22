"""The profiler hook (``profile_dir``) against the JAX trainer's, on the
CPU at the tiny shape of tests/test_torch_train.py: the window opens 16
steps after the start step and holds ``PROFILE_TRACE_ITERS`` steps, or
ends with the run; the trace and ``traced_steps.json`` are written into
``profile_dir``.  JAX's count comes from its own trainer run at one step a
call (its trace calls replaced by no-ops: the XPlane trace is not compared,
the port writes torch's format)."""
import json
import os

import jax
import pytest
import torch

from egonerf_tpu.train import trainer as jax_trainer
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch.train import trainer as port_trainer
from egonerf_torch.train.config import load_config

from test_torch_train import _tiny_cfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, name, n_iters):
    return _tiny_cfg(tmp_path, expname=name, n_iters=n_iters, batch_size=64, N_vis=0,
                     render_test=0, steps_per_call=1, progress_refresh_rate=10 ** 6,
                     profile_dir=str(tmp_path / name / "trace"))


def _jax_count(monkeypatch, tmp_path, n_iters) -> int:
    calls = []

    def start_trace(d):  # the real one makes the folder it writes into
        os.makedirs(d, exist_ok=True)
        calls.append(("start", d))

    monkeypatch.setattr(jax.profiler, "start_trace", start_trace)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls.append(("stop",)))
    cfg = jax_load_config(overrides=_cfg(tmp_path, "jax", n_iters))
    jax_trainer.Trainer(cfg).train()
    assert [c[0] for c in calls] == ["start", "stop"]
    with open(os.path.join(cfg.profile_dir, "traced_steps.json")) as f:
        return json.load(f)["steps"]


@pytest.mark.parametrize("n_iters", [44, 22], ids=["full_window", "ends_mid_window"])
def test_profile_dir_writes_trace_and_jax_count(monkeypatch, tmp_path, n_iters):
    """A run of 44 steps traces steps 16-39 (24, the whole window); one of
    22 ends inside the window and traces steps 16-21 (6).  The port writes
    a Chrome trace whose events name the port's ops and JAX's count."""
    want = _jax_count(monkeypatch, tmp_path, n_iters)
    assert want == min(port_trainer.PROFILE_TRACE_ITERS, n_iters - 16)
    cfg = load_config(overrides=_cfg(tmp_path, "port", n_iters))
    trainer = port_trainer.Trainer(cfg, device="cpu")
    steps = []
    step = trainer.train_step
    monkeypatch.setattr(trainer, "train_step", lambda it: steps.append(it) or step(it))
    trainer.train()
    assert steps == list(range(n_iters))
    with open(os.path.join(cfg.profile_dir, "traced_steps.json")) as f:
        assert json.load(f) == {"steps": want}
    with open(os.path.join(cfg.profile_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the plain versions' ops on the CPU: the composite's cumprod and Adam
    assert any(n.startswith("aten::") for n in names)
    assert any("Optimizer.step" in n for n in names)


def test_no_window_before_sixteen_steps(tmp_path):
    """A run shorter than 16 steps past its start never opens the window,
    as in JAX: no trace and no count."""
    cfg = load_config(overrides=_cfg(tmp_path, "short", 12))
    port_trainer.Trainer(cfg, device="cpu").train()
    assert not os.path.exists(cfg.profile_dir)
