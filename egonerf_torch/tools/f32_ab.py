"""bf16-against-float32 quality A/B at the production shape on the card
(counterpart of ``egonerf_tpu/tools/f32_ab.py``).

Re-runs :mod:`sampler_ab`'s device-uniform variant with ``compute_dtype =
float32``: the fine lines' float32 linear lookup and its float32 backward
(K1, K2 in line mode 0) where the default takes the bf16 hat (JAX's bf16
fast path), so that the default is held to the exact form at full scale.

    python -m egonerf_torch.tools.f32_ab

runs on the card, trains in ``build/sampler_ab/device_uniform_f32`` and
writes ``docs/torch/results_f32_ab.json`` (the run's record and
``device``, the card's name and power limit).
"""
from __future__ import annotations

import json

from . import device_name, sampler_ab, write_results


def main():
    from .._device import resolve_device

    dev = resolve_device("cuda")
    rec = sampler_ab.run_variant("device_uniform_f32", "simple", True, device=dev,
                                 compute_dtype="float32")
    rec["device"] = device_name(dev)
    print(json.dumps(rec), flush=True)
    write_results("f32_ab", rec)


if __name__ == "__main__":
    main()
