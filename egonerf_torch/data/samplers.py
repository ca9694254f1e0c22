"""Ray-batch sampling on the device (counterpart of the ``SimpleSampler``
branch of ``egonerf_tpu/data/samplers.py::make_device_id_sampler``).

The training rays and colors live on the card as one (N, 9) buffer
(rays | rgb); each step draws ``batch`` ray ids uniformly with replacement
from a device-side generator and gathers the rows there, so nothing
crosses from the host per step.
"""
from __future__ import annotations

import numpy as np
import torch


class DeviceRaySampler:
    def __init__(self, all_rays: np.ndarray, all_rgbs: np.ndarray, batch: int,
                 generator: torch.Generator):
        self.buffer = torch.as_tensor(
            np.concatenate([all_rays, all_rgbs], axis=1).astype(np.float32),
            device=generator.device)
        self.batch = int(batch)
        self.generator = generator

    def next_batch(self) -> torch.Tensor:
        """(batch, 9) rows, uniform with replacement."""
        ids = torch.randint(0, self.buffer.shape[0], (self.batch,),
                            generator=self.generator, device=self.buffer.device)
        return self.buffer[ids]
