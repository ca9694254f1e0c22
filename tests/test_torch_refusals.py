"""The port's refusals against the JAX package's own, on the CPU: the model
registry's unknown name and the notice of a checkpoint's family, the
refusals of ``metric_only`` and of the ``samp`` coarse-grid rule (which
JAX refuses itself), and the converter's message for a parameter key it
does not know."""
import numpy as np
import pytest

from egonerf_tpu.coords.yinyang import YinYangSphericalCoords as JaxYinYang
from egonerf_tpu.models import build_model as jax_build_model
from egonerf_tpu.train import trainer as jax_trainer
from egonerf_tpu.train.config import load_config as jax_load_config
from egonerf_torch.coords.yinyang import YinYangSphericalCoords
from egonerf_torch.models import build_model, model_class, model_meta, params_from_jax
from egonerf_torch.train import trainer as port_trainer
from egonerf_torch.train.config import load_config

AABB = np.array([[-2.0] * 3, [2.0] * 3], np.float32)
TINY = dict(n_lamb_sigma="[4,4,4]", n_lamb_sh="[8,8,8]", data_dim_color=12,
            shadingMode="MLP_Fea", featureC=32, view_pe=2, fea_pe=2)


def _raised(fn) -> BaseException:
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("name", ["NeRF", "tensorvmsplit", ""])
def test_unknown_model_is_jax_value_error(name):
    """An unknown family: JAX's ``ValueError(f"unknown model {name}")``,
    the same type and text."""
    cfg = jax_load_config(overrides=dict(TINY, model_name=name))
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=16 ** 3, r0=0.05, interval_th=True)
    want = _raised(lambda: jax_build_model(cfg, AABB, jc.resolution, jc, (0.05, 2.0)))
    got = _raised(lambda: model_class(name))
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want)


def test_checkpoint_family_notice_is_jax(capsys):
    """A checkpoint whose ``model_name`` differs from the config's builds
    the checkpoint's family with JAX's notice, word for word."""
    tc = YinYangSphericalCoords(AABB, exp_r=True, N_voxel=16 ** 3, r0=0.05, interval_th=True)
    cfg = load_config(overrides=dict(TINY, model_name="EgoNeRF"))
    meta = model_meta(cfg, build_model(cfg, AABB, tc.resolution, tc, (0.05, 2.0), device="cpu"))
    capsys.readouterr()
    other = load_config(overrides=dict(TINY, model_name="TensorVMSplit"))
    model = build_model(other, AABB, tc.resolution, tc, (0.05, 2.0), meta=meta, device="cpu")
    got = capsys.readouterr().out
    jc = JaxYinYang(AABB, exp_r=True, N_voxel=16 ** 3, r0=0.05, interval_th=True)
    jax_build_model(jax_load_config(overrides=dict(TINY, model_name="TensorVMSplit")), AABB,
                    jc.resolution, jc, (0.05, 2.0), meta=meta)
    want = capsys.readouterr().out
    assert type(model).__name__ == "EgoNeRF"
    assert got == want and "config's 'TensorVMSplit' is ignored" in got
    # the same family: no notice on either side
    build_model(cfg, AABB, tc.resolution, tc, (0.05, 2.0), meta=meta, device="cpu")
    assert capsys.readouterr().out == ""


def test_metric_only_is_refused_with_jax_message():
    """``--evaluation 1 --metric_only 1``: JAX's ``NotImplementedError``
    and its reason, before any dataset is read."""
    want = _raised(lambda: jax_trainer.render_test(jax_load_config(overrides=dict(
        metric_only=1))))
    got = _raised(lambda: port_trainer.render_test(load_config(overrides=dict(metric_only=1)),
                                                   device="cpu"))
    assert type(got) is type(want) is NotImplementedError
    assert str(got) == str(want)


def test_samp_rule_is_refused_with_jax_reason():
    """The ``samp`` coarse-grid rule: JAX's ``NotImplementedError`` with its
    reason (the text up to the ';'; after it JAX says where its 'conv' rule
    runs, inside its compiled step), raised before anything is built."""
    overrides = dict(coarse_sigma_grid_update_rule="samp")
    want = _raised(lambda: jax_trainer.Trainer(jax_load_config(overrides=overrides)))
    got = _raised(lambda: port_trainer.check_supported(load_config(overrides=overrides)))
    assert type(got) is type(want) is NotImplementedError
    assert str(got).split(";")[0] == str(want).split(";")[0]
    assert "ROADMAP" not in str(got) and "yet" not in str(got)
    got = _raised(lambda: port_trainer.Trainer(load_config(overrides=overrides), device="cpu"))
    assert str(got) == port_trainer.SAMP_REFUSAL


def test_unknown_parameter_key_names_no_pending_port():
    """Every JAX parameter key has a counterpart, so a key the converter
    does not know is refused without a promise of a later port."""
    got = _raised(lambda: params_from_jax({"density_planes/0/x": np.zeros(1, np.float32)},
                                          device="cpu"))
    assert type(got) is NotImplementedError
    assert str(got) == "parameter 'density_planes/0/x' has no counterpart in the port"
