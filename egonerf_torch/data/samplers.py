"""Ray-batch sampling (counterpart of ``egonerf_tpu/data/samplers.py`` and
of the trainer's choice between its device and host paths).

The training rays and colors live on the card as one (N, 9) buffer
(rays | rgb).  :class:`DeviceRaySampler` draws ``batch`` ray ids uniformly
with replacement from a device-side generator (the ``SimpleSampler``
branch of JAX's ``make_device_id_sampler``), so nothing crosses from the
host per step.  :class:`HostRaySampler` takes the ids of
:class:`SimpleSampler`, JAX's host sampler (shuffled epochs, the same ids
for the same seed), and copies them to the card each step.  The trainer
picks it by JAX's rule (:func:`host_sampling`).
"""
from __future__ import annotations

import numpy as np
import torch

# JAX keeps the rays on the device below this buffer size, at 32 float32
# a ray (egonerf_tpu/train/trainer.py:531-534)
DEVICE_BUFFER_LIMIT = 6 * 2 ** 30


def host_sampling(n_rays: int, device_sampling: bool) -> bool:
    """Whether JAX's trainer draws the ids on the host: ``device_sampling``
    off, or a ray buffer of 6 GiB or more at 32 float32 a ray."""
    return not device_sampling or n_rays * 32 * 4 >= DEVICE_BUFFER_LIMIT


class SimpleSampler:
    """Shuffled-permutation batches over a flat ray buffer (a copy of
    ``egonerf_tpu.data.samplers.SimpleSampler``)."""

    def __init__(self, total: int, batch: int, seed: int = 0):
        self.total = int(total)
        self.batch = int(batch)
        self.curr = self.total
        self.ids = None
        self.rng = np.random.default_rng(seed)

    def nextids(self) -> np.ndarray:
        self.curr += self.batch
        if self.curr + self.batch > self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr : self.curr + self.batch]


def _resident(all_rays: np.ndarray, all_rgbs: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([all_rays, all_rgbs], axis=1).astype(np.float32),
                           device=device)


class DeviceRaySampler:
    def __init__(self, all_rays: np.ndarray, all_rgbs: np.ndarray, batch: int,
                 generator: torch.Generator):
        self.buffer = _resident(all_rays, all_rgbs, generator.device)
        self.batch = int(batch)
        self.generator = generator

    def next_batch(self) -> torch.Tensor:
        """(batch, 9) rows, uniform with replacement."""
        ids = torch.randint(0, self.buffer.shape[0], (self.batch,),
                            generator=self.generator, device=self.buffer.device)
        return self.buffer[ids]


class HostRaySampler:
    def __init__(self, all_rays: np.ndarray, all_rgbs: np.ndarray, batch: int, seed: int,
                 device):
        self.buffer = _resident(all_rays, all_rgbs, device)
        self.sampler = SimpleSampler(self.buffer.shape[0], batch, seed=seed)

    def next_batch(self) -> torch.Tensor:
        """(batch, 9) rows of :class:`SimpleSampler`'s next ids.  On the
        card the ids go through pinned memory, so the copy does not hold
        the host until the card has caught up."""
        ids = torch.from_numpy(self.sampler.nextids())
        if self.buffer.is_cuda:
            ids = ids.pin_memory().to(self.buffer.device, non_blocking=True)
        return self.buffer[ids]
