"""The head-to-head run (``tools/headtohead_reference``) against the JAX
package's, on the CPU.

Both tools train the upstream PyTorch EgoNeRF beside their own model, so
each runs here on a stand-in upstream checkout (``tests/upstream_standin.py``)
whose ``EgoNeRF`` records what it is handed: the constructor's arguments,
the state the parameter copy leaves, every ray batch and keyword of its
forward, the Adam lr of each group at every forward, and the coarse grid's
updates.  JAX's ``main`` and the port's ``run`` go through it at two tiny
presets (one with the envmap's pretrain and handoff), from the same
initial weights: the port's, carried into JAX's parameter tree by the
port's converter.  The stand-in holds the upstream's layout, not its
numerics, so what is held here is what each tool feeds the upstream, bit
for bit; and the port's own half, whose PSNR curve follows JAX's within a
stated tolerance.  Mirrors on the real upstream skip without a checkout
at ``REF``.

Every import of the stand-in and every stub the tools put into
``sys.modules`` is taken out again after each run, as is the stand-in's
place on ``sys.path``.
"""
import contextlib
import copy
import functools
import io
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import egonerf_tpu.models.egonerf as jax_egonerf
import egonerf_tpu.train.optim as jax_optim
from egonerf_tpu.tools import headtohead_reference as jax_mod
from egonerf_tpu.train.checkpoint import unflatten_params
from egonerf_torch.models import params_to_jax
from egonerf_torch.models.egonerf import EgoNeRF
from egonerf_torch.tools import headtohead_reference as port_mod
from egonerf_torch.train.optim import Optimizer
from upstream_standin import restored_modules, write_checkout

torch.set_num_threads(1)

# tiny presets: JAX's preset keys at a 16^3 grid, a 2-view 32x16 scene and
# 300 of its 512 test rays (the eval subsample), 30 steps scored at 10, 20, 30
TINY = dict(n_iters=30, batch=256, n_coarse=16, n_fine=16, n_voxel=16 ** 3, eval_every=10,
            d_comp=(2, 2, 2), a_comp=(4, 4, 4), app_dim=6, feature_c=16, pretrain=0,
            eval_rays=300, dataset=dict(n_train=2, n_test=1, height=16, width=32))
TINY_ENV = dict(TINY, pretrain=3, envmap_res_h=8,
                dataset=dict(TINY["dataset"], background="env"))
PRESETS = {"tiny": TINY, "tiny_env": TINY_ENV}
# the PSNR curves of the two halves part by the jitter and the K4 draws,
# which come from torch's generators in the port and from jax.random in
# JAX (the port does not replay JAX's random stream), and JAX prints its
# curve to 0.01 dB.  At these presets the port's points lie within 0.005
# dB of JAX's printed ones (tiny 5.426, 5.468, 5.496 against 5.43, 5.47,
# 5.50; tiny_env 9.796, 9.850, 9.877 against 9.80, 9.85, 9.88), so 0.02 dB
# holds them; the port's half with 3x the lrs, with no optimizer step or
# with a 1e-3 decay ratio leaves the band by 0.02-2 dB at one point or more
CURVE_TOL_DB = 0.02
CURVE = re.compile(r"^\[ours \] iter (\d+): test PSNR ([0-9.]+)", re.M)


def _record():
    """A copy of the stand-in's RECORD; None where no upstream was imported
    or the upstream is the real one."""
    record = getattr(sys.modules.get("models.EgoNeRF"), "RECORD", None)
    return copy.deepcopy(record) if record is not None else None


@contextlib.contextmanager
def _patched(checkout, name):
    """Both tools' presets with ``name``, their REF at ``checkout``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_mod.PRESETS, name, PRESETS[name])
        mp.setitem(port_mod.PRESETS, name, PRESETS[name])
        mp.setattr(jax_mod, "REF", checkout)
        mp.setattr(port_mod, "REF", checkout)
        yield mp


def _run_port(checkout, name, reference=True):
    """The port's run on the CPU: (table, stdout, RECORD or None, its
    initial parameters, each Optimizer's arguments, each step's lrs)."""
    inits, builds, steps = [], [], []
    init, init_opt, step = EgoNeRF.init_params, Optimizer.__init__, Optimizer.step

    def record_init(self, generator):
        params = init(self, generator)
        inits.append({k: v.detach().clone() for k, v in params.items()})
        return params

    def record_build(self, params, lr_grid, lr_network, lr_envmap=0.0,
                     decay_target_ratio=0.1, decay_iters=None):
        builds.append((lr_grid, lr_network, lr_envmap, decay_target_ratio, decay_iters))
        init_opt(self, params, lr_grid, lr_network, lr_envmap, decay_target_ratio,
                 decay_iters)

    def record_step(self):
        step(self)
        steps.append({g["group"]: g["lr"] for g in self.adam.param_groups})

    out = io.StringIO()
    with restored_modules(), _patched(checkout, name) as mp:
        mp.setattr(EgoNeRF, "init_params", record_init)
        mp.setattr(Optimizer, "__init__", record_build)
        mp.setattr(Optimizer, "step", record_step)
        with contextlib.redirect_stdout(out):
            table = port_mod.run(name, device="cpu", reference=reference)
        record = _record()
    return dict(table=table, out=out.getvalue(), record=record, init=inits[0],
                builds=builds, steps=steps)


def _jax_init_from(port_init):
    """JAX's ``init_params`` replaced by the port's initial parameters in
    JAX's tree (the port's converter; the tree's structure from
    ``jax.eval_shape``, which compiles nothing)."""
    orig = jax_egonerf.EgoNeRF.init_params
    flat = params_to_jax(port_init)

    def init_params(self, key):
        shapes = jax.eval_shape(functools.partial(orig, self), key)
        tree = unflatten_params(shapes, flat)
        for want, got in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(tree)):
            assert want.shape == got.shape and want.dtype == got.dtype
        return tree
    return init_params


def _run_jax(checkout, name, port_init, out_json):
    """JAX's main on the CPU from the port's initial parameters: (the
    table it wrote or None, stdout, RECORD or None, each make_optimizer's
    arguments, the exception it raised or None)."""
    builds = []
    make = jax_optim.make_optimizer

    def record_make(params, lr_grid, lr_network, lr_envmap, decay_target_ratio=0.1,
                    decay_iters=None):
        builds.append((lr_grid, lr_network, lr_envmap, decay_target_ratio, decay_iters))
        return make(params, lr_grid, lr_network, lr_envmap, decay_target_ratio, decay_iters)

    out, raised = io.StringIO(), None
    with restored_modules(), _patched(checkout, name) as mp:
        mp.setattr(jax_egonerf.EgoNeRF, "init_params", _jax_init_from(port_init))
        mp.setattr(jax_optim, "make_optimizer", record_make)
        with contextlib.redirect_stdout(out):
            try:
                jax_mod.main(name, out_json)
            except ModuleNotFoundError as e:  # the missing checkout's late refusal
                raised = e
        record = _record()
    table = None
    if raised is None:
        with open(out_json) as f:
            table = json.load(f)
    return dict(table=table, out=out.getvalue(), record=record, builds=builds, raised=raised)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return write_checkout(tmp_path_factory.mktemp("upstream"))


@pytest.fixture(scope="module")
def runs(checkout, tmp_path_factory):
    """Each tiny preset through the port's run, then JAX's main from the
    port's initial parameters, both on the stand-in."""
    tmp = tmp_path_factory.mktemp("headtohead")
    out = {}
    for name in PRESETS:
        port = _run_port(checkout, name)
        out[name] = (port, _run_jax(checkout, name, port["init"], str(tmp / f"{name}.json")))
    return out


def _train_calls(record):
    return [c for c in record["calls"] if c["kwargs"]["is_train"]]


def _eval_calls(record):
    return [c for c in record["calls"] if not c["kwargs"]["is_train"]]


# ---------------------------------------------------------------------------
# the tool's constants
# ---------------------------------------------------------------------------
def test_constants_match_jax():
    """REF, the presets, the learning rates, the decay, the eval chunk and
    psnr are JAX's, value for value."""
    assert port_mod.REF == jax_mod.REF
    assert port_mod.PRESETS == jax_mod.PRESETS
    for k in ("DECAY_RATIO", "EVAL_CHUNK", "LR_GRID", "LR_NET", "LR_ENVMAP_PRETRAIN",
              "LR_ENVMAP"):
        assert getattr(port_mod, k) == getattr(jax_mod, k), k
    rng = np.random.default_rng(3)
    a, b = rng.random((50, 3)), rng.random((50, 3))
    assert port_mod.psnr(a, b) == jax_mod.psnr(a, b)
    assert port_mod.psnr(a, a) == jax_mod.psnr(a, a) == pytest.approx(120.0)


# ---------------------------------------------------------------------------
# what each tool feeds the upstream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_constructor_matches_jax(runs, name):
    """The upstream chart and EgoNeRF are built with JAX's arguments: the
    aabb, the grid, the device, the chart's, the field's keywords."""
    port, jax_run = runs[name]
    got, want = port["record"]["init"], jax_run["record"]["init"]
    assert len(got) == len(want) == 1
    assert got == want
    kw = got[0]["kwargs"]
    assert got[0]["device"] == "cpu" and got[0]["chart"] == "YinYangSphericalCoords"
    assert kw["use_envmap"] == (PRESETS[name]["pretrain"] > 0)
    assert kw["density_n_comp"] == list(PRESETS[name]["d_comp"])


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_copied_tensors_match_jax_bit_for_bit(runs, name):
    """The upstream state_dict the parameter copy leaves (at its coarse
    grid update) is JAX's, tensor for tensor, bit for bit, and holds the
    port's initial parameters in the upstream layout."""
    port, jax_run = runs[name]
    got, want = port["record"]["copied"], jax_run["record"]["copied"]
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    init = port["init"]
    assert torch.equal(got["density_plane_yang.1"],
                       init["density_planes.1"][1].permute(2, 0, 1)[None])
    assert torch.equal(got["app_line_yin.2"], init["app_lines.2"][0].T[None, :, :, None])
    assert torch.equal(got["basis_mat_yang.weight"], init["basis"][1].T)
    assert torch.equal(got["renderModule.mlp.2.weight"], init["shader.l2.weight"])
    if "envmap" in init:
        assert torch.equal(got["envmap.emission"], init["envmap"].permute(2, 0, 1))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_batches_match_jax(runs, name):
    """Every training forward of the upstream (pretrain first, then each
    step) takes JAX's ray batch bit for bit, with JAX's keywords."""
    port, jax_run = runs[name]
    got, want = _train_calls(port["record"]), _train_calls(jax_run["record"])
    p = PRESETS[name]
    assert len(got) == len(want) == p["pretrain"] + p["n_iters"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["rays"].dtype == w["rays"].dtype == np.float32
        np.testing.assert_array_equal(g["rays"], w["rays"], err_msg=f"batch {i}")
        assert g["rays"].shape == (p["batch"], 6)
        assert (g["kwargs"], g["pretrain_envmap"], g["grad"]) == (
            w["kwargs"], w["pretrain_envmap"], w["grad"]), i
    assert [c["pretrain_envmap"] for c in got] == [True] * p["pretrain"] + [False] * p["n_iters"]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_lrs_match_jax(runs, name):
    """The upstream's Adam groups are built with JAX's lrs (and rebuilt at
    the handoff), and each group's lr at every training forward is JAX's.
    The port's own optimizer is built with the arguments JAX's
    ``make_optimizer`` gets, and its per-step lrs are the upstream's
    (rel 1e-12: a power against a running product)."""
    port, jax_run = runs[name]
    p = PRESETS[name]
    got = [g["lrs"] for g in port["record"]["groups"]]
    want = [g["lrs"] for g in jax_run["record"]["groups"]]
    assert got == want
    handoff = [(port_mod.LR_GRID, port_mod.LR_NET, port_mod.LR_ENVMAP)] if p["pretrain"] else []
    assert got == [(port_mod.LR_GRID, port_mod.LR_NET, port_mod.LR_ENVMAP_PRETRAIN)] + handoff
    up = [c["lrs"] for c in _train_calls(port["record"])]
    assert up == [c["lrs"] for c in _train_calls(jax_run["record"])]
    assert port["builds"] == jax_run["builds"]
    assert len(port["steps"]) == len(up)
    for i, (mine, theirs) in enumerate(zip(port["steps"], up)):
        groups = ["grid", "network"] + (["envmap"] if p["pretrain"] else [])
        assert sorted(mine) == sorted(groups)
        for g, lr in zip(groups, theirs):
            assert mine[g] == pytest.approx(lr, rel=1e-12), (i, g)
    # the handoff: constant lrs through pretrain, the decay from the base
    # lr again after it
    if p["pretrain"]:
        assert port["steps"][p["pretrain"]] == {"grid": port_mod.LR_GRID,
                                                "network": port_mod.LR_NET,
                                                "envmap": port_mod.LR_ENVMAP}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_eval_rays_match_jax(runs, name):
    """The upstream's evaluations take JAX's test rays (the seeded
    subsample) bit for bit, without gradients, once every eval_every."""
    port, jax_run = runs[name]
    got, want = _eval_calls(port["record"]), _eval_calls(jax_run["record"])
    p = PRESETS[name]
    assert len(got) == len(want) == p["n_iters"] // p["eval_every"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["rays"], w["rays"])
        assert g["rays"].shape == (p["eval_rays"], 6)
        assert not g["grad"] and not w["grad"] and g["kwargs"] == w["kwargs"]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_table_matches_jax(runs, name):
    """The table has JAX's keys and ``device``; its preset, iterations and
    config are JAX's, and so is the stand-in's PSNR curve (the same
    upstream calls on the same inputs); the coarse grid is updated once
    after the copy and once a step, as in JAX."""
    port, jax_run = runs[name]
    got, want = port["table"], jax_run["table"]
    assert sorted(got) == sorted([*want, "device"]) and got["device"] == "cpu"
    for k in ("preset", "iters", "config", "reference_psnr"):
        assert got[k] == want[k], k
    assert got["iters"] == [10, 20, 30]
    assert port["record"]["updates"] == jax_run["record"]["updates"] == 1 + PRESETS[name]["n_iters"]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_port_curve_follows_jax(runs, name):
    """The port's half against the curve JAX's half prints: the same
    iterations, each PSNR within CURVE_TOL_DB (the jitter and K4's draws
    differ by the rule on randomness); both print the pretrain line where
    there is one, and the port's printed curve is its table's."""
    port, jax_run = runs[name]
    want = {int(i): float(v) for i, v in CURVE.findall(jax_run["out"])}
    printed = {int(i): float(v) for i, v in CURVE.findall(port["out"])}
    got = dict(zip(port["table"]["iters"], port["table"]["ours_psnr"]))
    assert sorted(got) == sorted(want) == sorted(printed)
    for it in want:
        assert np.isfinite(got[it]) and abs(got[it] - want[it]) <= CURVE_TOL_DB, (it, got, want)
        assert printed[it] == pytest.approx(got[it], abs=0.005)
    pretrain = "[ours ] envmap pretrain done"
    assert (pretrain in port["out"]) == (pretrain in jax_run["out"]) == bool(
        PRESETS[name]["pretrain"])


def test_port_half_alone(runs):
    """``reference=False`` trains the port's half alone, with no checkout:
    the same curve as with the upstream (the port's draws do not depend on
    it), no upstream output, an empty reference curve."""
    alone = _run_port("/nonexistent/checkout", "tiny", reference=False)
    with_ref = runs["tiny"][0]["table"]
    assert alone["table"]["reference_psnr"] == [] and "[torch]" not in alone["out"]
    assert alone["table"]["iters"] == with_ref["iters"] == [10, 20, 30]
    assert alone["table"]["ours_psnr"] == with_ref["ours_psnr"]
    assert alone["steps"] == runs["tiny"][0]["steps"]


# ---------------------------------------------------------------------------
# refusals and the command line
# ---------------------------------------------------------------------------
def test_missing_checkout_refused_before_training(runs, tmp_path, monkeypatch):
    """No checkout: the port's run raises ``ModuleNotFoundError`` for
    ``models`` before it builds any data; JAX's main raises the same type
    only after its whole half has trained and printed its curve (the one
    it printed with the checkout present)."""
    missing = str(tmp_path / "no_checkout")
    import egonerf_torch.data.datasets as datasets

    def no_data(*a, **k):
        raise AssertionError("the port built data before refusing")
    monkeypatch.setattr(datasets, "SyntheticEgoDataset", no_data)
    with _patched(missing, "tiny"), pytest.raises(ModuleNotFoundError) as info:
        port_mod.run("tiny", device="cpu")
    assert info.value.name == "models" and missing in str(info.value)
    monkeypatch.undo()

    late = _run_jax(missing, "tiny", runs["tiny"][0]["init"], str(tmp_path / "j.json"))
    assert isinstance(late["raised"], ModuleNotFoundError) and late["raised"].name == "models"
    assert late["table"] is None and late["record"] is None
    assert CURVE.findall(late["out"]) == CURVE.findall(runs["tiny"][1]["out"])
    assert len(CURVE.findall(late["out"])) == 3


def test_main_needs_a_card(monkeypatch, tmp_path):
    """The port's main (and run's default device) raise without a card
    before any work, checkout or none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_mod, "REF", str(tmp_path / "no_checkout"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mod.main("tiny", str(tmp_path / "t.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mod.run("small")
    assert not os.listdir(tmp_path)


def test_main_writes_the_table(checkout, tmp_path, monkeypatch, capsys):
    """``main`` writes the table to ``build/headtohead_<preset>.json`` by
    default (JAX: /tmp) and prints it as its last line; the cuts are
    checked."""
    with restored_modules(), _patched(checkout, "tiny") as mp:
        mp.setitem(port_mod.PRESETS, "tiny", dict(TINY, n_iters=4, eval_every=2))
        mp.setattr(port_mod, "RUNS_DIR", str(tmp_path / "build"))
        mp.setattr(port_mod, "run", functools.partial(port_mod.run, device="cpu"))
        port_mod.main("tiny")
    lines = capsys.readouterr().out.strip().splitlines()
    with open(tmp_path / "build" / "headtohead_tiny.json") as f:
        table = json.load(f)
    assert json.loads(lines[-1]) == table and table["preset"] == "tiny"
    assert table["iters"] == [2, 4] and len(table["reference_psnr"]) == 2
    with pytest.raises(TypeError, match="cuts only"):
        port_mod.run("tiny", device="cpu", reference=False, batch=64)


# ---------------------------------------------------------------------------
# the real upstream checkout, where it is present
# ---------------------------------------------------------------------------
needs_reference = pytest.mark.skipif(
    not os.path.isfile(os.path.join(jax_mod.REF, "models", "EgoNeRF.py")),
    reason="reference checkout not present")


@needs_reference
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_real_upstream_half_matches_jax(tmp_path, name):
    """Both tools' upstream halves on the real checkout, on the CPU, from
    the port's initial parameters and one torch seed: the same upstream
    code on the same inputs gives JAX's reference curve (within 1e-3 dB,
    the table's rounding), and the port's own curve follows JAX's as on
    the stand-in."""
    torch.manual_seed(0)
    port = _run_port(jax_mod.REF, name)
    torch.manual_seed(0)
    jax_run = _run_jax(jax_mod.REF, name, port["init"], str(tmp_path / "j.json"))
    assert jax_run["raised"] is None
    got, want = port["table"], jax_run["table"]
    assert got["iters"] == want["iters"] and got["config"] == want["config"]
    np.testing.assert_allclose(got["reference_psnr"], want["reference_psnr"], atol=1e-3)
    np.testing.assert_allclose(got["ours_psnr"], want["ours_psnr"], atol=CURVE_TOL_DB)
