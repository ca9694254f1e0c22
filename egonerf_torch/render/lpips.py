"""The LPIPS v0.1 perceptual distance, AlexNet and VGG16 backbones
(counterpart of ``egonerf_tpu/render/lpips_jax.py``), as plain functions
on tensors: ``F.conv2d`` and ``F.max_pool2d`` on the model's device.

Weights come from a local ``.npz`` in the JAX package's layout, found
where the JAX package looks (first hit wins):
  1. ``$EGONERF_LPIPS_WEIGHTS_DIR/lpips_{net}.npz``
  2. ``~/.cache/egonerf_tpu/lpips_{net}.npz``
npz schema (float32): ``conv{i}_w`` (H, W, Cin, Cout) and ``conv{i}_b``
(Cout,) for each backbone conv in order, and ``lin{j}_w`` (C_j,), the
non-negative 1x1 head weights of each feature tap.

Make one with ``python -m egonerf_torch.tools.export_lpips [alex|vgg]
[out_dir]`` on a host that has the pip ``lpips`` package and its
pretrained weights (it writes to the discovery path above by default).

Without a file :func:`rgb_lpips` returns None.  A miss is not cached, so
a file written later in the process is read by the next call.  The JAX
package falls back to the pip ``lpips`` package when no file is found;
the port does not, since the card's installation has no such package.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# (kernel, stride, pad, maxpool before the conv) per conv, the taps (after
# the ReLU of these convs) and the pool's (kernel, stride)
_ALEX = dict(
    convs=[(11, 4, 2, False), (5, 1, 2, True), (3, 1, 1, True),
           (3, 1, 1, False), (3, 1, 1, False)],
    taps=[0, 1, 2, 3, 4],
    pool=(3, 2),
)
_VGG = dict(
    convs=[(3, 1, 1, False), (3, 1, 1, False), (3, 1, 1, True),
           (3, 1, 1, False), (3, 1, 1, True), (3, 1, 1, False),
           (3, 1, 1, False), (3, 1, 1, True), (3, 1, 1, False),
           (3, 1, 1, False), (3, 1, 1, True), (3, 1, 1, False),
           (3, 1, 1, False)],
    taps=[1, 3, 6, 9, 12],
    pool=(2, 2),
)
NETS = {"alex": _ALEX, "vgg": _VGG}
# each net's conv widths, input first (torchvision's AlexNet and VGG16)
CHANNELS = {"alex": [3, 64, 192, 384, 256, 256],
            "vgg": [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]}

# lpips' ScalingLayer constants (lpips v0.1)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def weights_path(net: str = "alex") -> str:
    base = os.environ.get("EGONERF_LPIPS_WEIGHTS_DIR",
                          os.path.expanduser("~/.cache/egonerf_tpu"))
    return os.path.join(base, f"lpips_{net}.npz")


def params_from_arrays(arrays, net: str, device) -> dict:
    """The weights of an npz mapping as tensors on ``device``: ``convs``
    [(w (Cout, Cin, H, W), b)] and ``lins`` [(C,)]."""
    n_convs, n_taps = len(NETS[net]["convs"]), len(NETS[net]["taps"])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"convs": [(t(arrays[f"conv{i}_w"]).permute(3, 2, 0, 1).contiguous(),
                       t(arrays[f"conv{i}_b"])) for i in range(n_convs)],
            "lins": [t(arrays[f"lin{j}_w"]) for j in range(n_taps)]}


def random_arrays(net: str, seed: int) -> dict:
    """Weights of the right shapes in the npz layout, drawn from ``seed``
    with numpy (conv weights 0.05 N(0, 1), biases 0.01 N(0, 1), heads
    |N(0, 1)|): for checking the graph where no weights file exists."""
    rng = np.random.default_rng(seed)
    chans = CHANNELS[net]
    arrays = {}
    for i, (k, _, _, _) in enumerate(NETS[net]["convs"]):
        arrays[f"conv{i}_w"] = (rng.normal(size=(k, k, chans[i], chans[i + 1])) * 0.05
                                ).astype(np.float32)
        arrays[f"conv{i}_b"] = (rng.normal(size=(chans[i + 1],)) * 0.01).astype(np.float32)
    for j, t in enumerate(NETS[net]["taps"]):
        arrays[f"lin{j}_w"] = np.abs(rng.normal(size=(chans[t + 1],))).astype(np.float32)
    return arrays


def load_lpips_params(net: str = "alex", device="cpu") -> Optional[dict]:
    """The weights from :func:`weights_path`; None if there is no file."""
    path = weights_path(net)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return params_from_arrays(data, net, device)


def lpips_pair(params: dict, im0: torch.Tensor, im1: torch.Tensor,
               net: str = "alex") -> torch.Tensor:
    """(h, w, 3) images in [0, 1] -> the scalar LPIPS distance: both images
    through the backbone as one batch, scaled by lpips' shift and scale;
    per tap, unit-normalised channels (eps outside the sqrt, as lpips
    v0.1), squared difference, the non-negative 1x1 head and the spatial
    mean, summed over the taps."""
    spec = NETS[net]
    pk, ps = spec["pool"]
    taps = set(spec["taps"])
    dev = params["lins"][0].device
    x = torch.stack([im0, im1]).to(dev, torch.float32).permute(0, 3, 1, 2)
    x = x * 2.0 - 1.0
    x = (x - torch.as_tensor(_SHIFT, device=dev).view(1, 3, 1, 1)) / \
        torch.as_tensor(_SCALE, device=dev).view(1, 3, 1, 1)
    total = torch.zeros((), device=dev)
    lins = iter(params["lins"])
    for i, ((k, stride, pad, pool_before), (w, b)) in enumerate(zip(spec["convs"],
                                                                    params["convs"])):
        if pool_before:
            x = F.max_pool2d(x, pk, ps)
        x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        if i in taps:
            f = x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + 1e-10)
            d = (f[0] - f[1]) ** 2
            total = total + (d * next(lins).view(-1, 1, 1)).sum(dim=0).mean()
    return total


_PARAM_CACHE: dict = {}


@torch.no_grad()
def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net: str = "alex",
              device="cpu") -> Optional[float]:
    """LPIPS of two (h, w, 3) images in [0, 1] from the local weights file,
    on ``device``; None when no file is found."""
    key = (net, str(device))
    if key not in _PARAM_CACHE:
        params = load_lpips_params(net, device)
        if params is None:
            return None
        _PARAM_CACHE[key] = params
    params = _PARAM_CACHE[key]
    return float(lpips_pair(params, torch.as_tensor(np.asarray(np_gt, np.float32)),
                            torch.as_tensor(np.asarray(np_im, np.float32)), net))
