"""Configuration system (a copy of ``egonerf_tpu/train/config.py``, which
the port may not import).

Reads the reference's ``key = value`` .txt config dialect with recursive
``include =`` chaining (deeper files override shallower ones, CLI overrides
all — reference: opt.py:6-25) into a typed dataclass covering the same ~80
flags (reference: opt.py:28-206).  No configargparse dependency: the parser
is self-contained and also accepts unambiguous key prefixes, which the
reference relied on implicitly (its configs say ``coordinates = yinyang``
for the flag ``--coordinates_name``).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional


@dataclass
class Config:
    # bookkeeping
    config: Optional[str] = None
    include: Optional[str] = None
    expname: str = "exp"
    basedir: str = "./log"
    add_timestamp: int = 0
    datadir: str = "./data/llff/fern"
    progress_refresh_rate: int = 10

    downsample_train: float = 1.0
    downsample_test: float = 1.0
    test_skip: int = 1

    model_name: str = "EgoNeRF"  # EgoNeRF | TensorVMSplit | TensorVM | TensorCP

    # loader
    batch_size: int = 4096
    n_iters: int = 30000
    dataset_name: str = "omniblender"
    localization_method: str = "colmap"
    near_far: List[float] = field(default_factory=lambda: [0.1, 15.0])
    roi: List[float] = field(default_factory=lambda: [0.0, 1.0, 0.0, 1.0])

    # learning rates
    lr_init: float = 0.005
    lr_basis: float = 1e-3
    lr_envmap_pretrain: float = 0.02
    lr_envmap: float = 0.005
    lr_decay_iters: int = -1
    lr_decay_target_ratio: float = 0.1
    lr_upsample_reset: int = 1

    # loss weights
    L1_weight_initial: float = 0.0
    L1_weight_rest: float = 0.0
    Ortho_weight: float = 0.0
    TV_weight_density: float = 0.0
    TV_weight_app: float = 0.0
    entropy_weight: float = 0.0
    iter_ignore_entropy: int = 0
    iter_ignore_TV: int = 100000

    # volume options
    n_lamb_sigma: List[int] = field(default_factory=lambda: [16, 16, 16])
    n_lamb_sh: List[int] = field(default_factory=lambda: [48, 48, 48])
    data_dim_color: int = 27

    # shading decoder
    shadingMode: str = "MLP_PE"
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    featureC: int = 128

    ckpt: Optional[str] = None
    evaluation: int = 0
    metric_only: int = 0
    render_test: int = 0
    render_train: int = 0
    render_path: int = 0
    export_mesh: int = 0

    # rendering options
    lindisp: bool = False
    perturb: float = 1.0
    accumulate_decay: float = 0.998
    fea2denseAct: str = "softplus"
    ndc_ray: int = 0
    nSamples: int = 1_000_000
    step_ratio: float = 0.5
    exp_sampling: bool = False
    resampling: bool = False
    n_coarse: int = 128
    n_fine: int = 64
    ray_weight_th: float = 0.01  # dead flag kept for config parity (reference: opt.py:129)
    use_coarse_sample: bool = False

    # coarse sigma grid
    coarse_sigma_grid_update_rule: Optional[str] = None  # conv | samp
    pivotal_sample_th: float = 0.0
    iter_ignore_resampling: int = -1
    update_AlphaMask_list: Optional[List[int]] = None
    rm_weight_mask_thre: float = 1e-4
    alpha_mask_thre: float = 1e-4
    distance_scale: float = 25.0
    density_shift: float = -10.0

    # envmap
    use_envmap: bool = False
    envmap_res_H: int = 1000
    iter_pretrain_envmap: int = 0

    white_bkgd: bool = False
    filter_ray: bool = False
    N_voxel_init: int = 100**3
    N_voxel_final: int = 300**3
    upsamp_list: Optional[List[int]] = None
    idx_view: int = 0

    # logging / saving
    N_vis: int = -1
    vis_every: int = 10000
    vis_list: Optional[List[int]] = None
    i_weights: int = 5000

    # depth supervision
    use_depth: bool = False
    depth_lambda: float = 0.1
    depth_step_size: int = 5000
    depth_rate: float = 1.0
    depth_end_iter: Optional[int] = None
    use_gt_depth: bool = False

    # coordinates
    coordinates_name: str = "xyz"
    r0: Optional[float] = None
    interval_th: bool = False

    # sparsity loss
    sparsity_lambda: float = 0.1
    N_sparsity_points: int = 10000
    sparsity_length: float = 0.2

    # ray sampler
    sampling_method: str = "simple"
    theta_importance_lambda: float = 5.0

    # -- extensions of the JAX package (no reference counterpart); the
    # port's Trainer raises on the ones it does not carry yet ------------
    seed: int = 20221028
    compute_dtype: str = "bfloat16"  # float32 = conservative opt-out
    # rays per eval chunk
    eval_chunk: int = 4096
    mesh_shape: Optional[List[int]] = None  # data-parallel mesh, None = all devices
    profile_dir: Optional[str] = None       # profiler trace output
    # JAX fuses this many steps into one dispatch to amortise the TPU's
    # dispatch cost; the port accepts it and it has no effect (eager
    # PyTorch queues each step's kernels without waiting for the card)
    steps_per_call: int = 48
    device_sampling: bool = True  # draw ray ids on the device
    # the empty-space cull (ops/cull.py; EgoNeRF only): keep the K highest-
    # scored merged samples a ray at eval / in training, 0 = off; an
    # unculled step every train_keep_full_every; Gumbel-top-K at
    # train_cull_tau > 0, else the tie-break
    eval_keep: int = 0
    train_keep: int = 0
    train_keep_full_every: int = 0
    train_cull_tau: float = 0.0


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}
_LIST_FIELDS = {name for name, f in _FIELDS.items()
                if "List" in str(f.type) or "list" in str(f.type)}


def _resolve_key(key: str) -> str:
    """Exact match, else unique-prefix match (argparse abbreviation rule the
    reference's configs depend on, e.g. 'coordinates' -> 'coordinates_name')."""
    if key in _FIELDS:
        return key
    matches = [name for name in _FIELDS if name.startswith(key)]
    if len(matches) == 1:
        return matches[0]
    if len(matches) > 1:
        raise KeyError(f"ambiguous config key '{key}': {matches}")
    raise KeyError(f"unknown config key '{key}'")


def _coerce(name: str, raw):
    """Parse a raw string to the field's python type."""
    f = _FIELDS[name]
    t = str(f.type)
    if not isinstance(raw, str):
        return raw
    raw = raw.strip()
    if raw.lower() in ("none", "null"):
        # must run before the list branch: 'upsamp_list = None' means the
        # Optional default, not [None] (which would crash the scheduler)
        return None
    if name in _LIST_FIELDS or raw.startswith("["):
        val = ast.literal_eval(raw)
        return list(val) if isinstance(val, (list, tuple)) else [val]
    if "bool" in t:
        return raw.lower() in ("1", "true", "yes", "on", "")
    if "int" in t:
        if raw.lower() in ("true", "false"):
            # bare flag lines / valueless CLI flags produce the 'True'
            # placeholder; several reference flags are 0/1 ints
            # (render_test, render_train, evaluation, ... — opt.py types)
            return int(raw.lower() == "true")
        return int(float(raw))
    if "float" in t:
        return float(raw)
    return raw


def parse_config_file(path: str) -> dict:
    """One .txt file -> {canonical_key: parsed_value}."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, raw = line.split("=", 1)
                key, raw = key.strip(), raw.strip()
            else:
                key, raw = line.strip(), "True"  # bare flag line
            name = _resolve_key(key)
            out[name] = _coerce(name, raw)
    return out


def load_config_chain(path: str) -> list:
    """Walk the include chain root-first (reference: opt.py:6-16)."""
    chain = []
    seen = set()
    current = path
    while current:
        current = os.path.abspath(current)
        if current in seen:
            raise ValueError(f"config include cycle at {current}")
        seen.add(current)
        values = parse_config_file(current)
        chain.append((current, values))
        inc = values.get("include")
        current = os.path.join(Path(current).parent, inc) if inc else None
    return list(reversed(chain))  # shallowest (root) first


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Config file chain + programmatic/CLI overrides -> Config."""
    cfg = Config()
    if path:
        for file_path, values in load_config_chain(path):
            for k, v in values.items():
                if k != "include":
                    setattr(cfg, k, v)
        cfg.config = path
    if overrides:
        for k, v in overrides.items():
            name = _resolve_key(k)
            setattr(cfg, name, _coerce(name, v) if isinstance(v, str) else v)
    return cfg


def parse_cli(argv: list) -> Config:
    """`--config file --key value [--flag]` command line."""
    args = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected argument: {tok}")
        key = tok[2:]
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            args[key] = argv[i + 1]
            i += 2
        else:
            args[key] = "True"
            i += 1
    path = args.pop("config", None)
    return load_config(path, overrides=args)


def export_config(cfg: Config, logdir: str) -> None:
    """Dump the resolved flags + the raw root config into the logdir
    (reference: opt.py:209-221)."""
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "args.txt"), "w") as f:
        for name in sorted(_FIELDS):
            f.write(f"{name} = {getattr(cfg, name)}\n")
    if cfg.config and os.path.exists(cfg.config):
        with open(os.path.join(logdir, "config.txt"), "w") as f:
            f.write(open(cfg.config).read())
