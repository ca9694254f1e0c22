"""Ray-batch sampling (counterpart of ``egonerf_tpu/data/samplers.py`` and
of the trainer's choice between its device and host paths).

The training rays and colors live on the card as one (N, 9) buffer
(rays | rgb), (N, 10) with the ground-truth depths under ``use_depth``
(rays | rgb | depth, as JAX's resident buffer).  On the card, :class:`DeviceRaySampler` draws ``batch`` ray
ids uniformly with replacement from the step's generator (the
``SimpleSampler`` branch of JAX's ``make_device_id_sampler``) and
:class:`DeviceThetaSampler` draws, picks and gathers a theta-importance
batch in one launch of K14f (``ops/sampler.py::theta_batch``, its
``ThetaImportanceSampler`` branch), so nothing crosses from the host per
step.  :class:`HostRaySampler` takes the ids of a host sampler, JAX's
:class:`SimpleSampler` (shuffled epochs) or :class:`ThetaImportanceSampler`
(numpy's generator: the same ids as JAX's for the same seed), and copies
them to the card each step.  The trainer picks the host path by JAX's rule
(:func:`host_sampling`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import ops

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


class ThetaImportanceSampler:
    """Latitude-weighted pixel sampling (a copy of
    ``egonerf_tpu.data.samplers.ThetaImportanceSampler``): equirect images
    oversample the poles, so rows are drawn with weight lambda*cos(theta)+1
    (reference: sampler.py:19-38).

    ``img_wh_full`` is the FULL pre-roi-crop equirect size; the sampler
    derives the cropped per-image raster with the datasets' own slice
    arithmetic and the image count from the flat buffer length.  This is
    a deliberate deviation: the reference computes img_len outside from
    ``img_wh`` and re-applies the roi crop inside the sampler
    (reference: sampler.py:20-26, train.py:202-204), which double-crops
    on the datasets whose ``img_wh`` is already roi-cropped
    (dataset_omniscenes.py:14-16) — a latent misindexing its published
    configs never hit because they all use ``sampling_method = simple``."""

    def __init__(self, theta_importance_lambda: float, n_rays_total: int,
                 img_wh_full, batch: int, roi, seed: int = 0):
        self.batch = int(batch)
        w, h = img_wh_full
        # exact dataset slice arithmetic (datasets.py: int(r1*h)-int(r0*h)),
        # NOT int(h*(r1-r0)) — the two differ for some fractional rois
        self.w = int(roi[3] * w) - int(roi[2] * w)
        self.h = int(roi[1] * h) - int(roi[0] * h)
        if int(n_rays_total) % (self.w * self.h):
            raise ValueError(
                f"ray buffer length {n_rays_total} is not a multiple of the "
                f"per-image raster {self.w}x{self.h} — theta_importance "
                "requires the flat (img, row, col) layout (e.g. it cannot "
                "follow a filter_ray compaction)")
        self.img_len = int(n_rays_total) // (self.w * self.h)
        self.weight = self._get_weight(theta_importance_lambda, h, roi)
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _get_weight(lam: float, h: int, roi) -> np.ndarray:
        rows = np.arange(h)[int(h * roi[0]) : int(h * roi[1])]
        theta = -(rows - h // 2) / h * np.pi
        weight = np.cos(theta) * lam + 1.0
        return weight / weight.sum()

    def nextids(self) -> np.ndarray:
        img_id = self.rng.choice(self.img_len, self.batch)
        col = self.rng.choice(self.w, self.batch)
        row = self.rng.choice(self.h, self.batch, p=self.weight)
        return img_id * self.w * self.h + (col + row * self.w)


def _resident(all_rays: np.ndarray, all_rgbs: np.ndarray, device,
              all_depths: Optional[np.ndarray] = None) -> torch.Tensor:
    """The (N, 9) rays | rgb buffer on ``device``, (N, 10) with the depths."""
    cols = [all_rays, all_rgbs]
    if all_depths is not None:
        cols.append(all_depths.reshape(-1, 1))
    return torch.as_tensor(np.concatenate(cols, axis=1).astype(np.float32), device=device)


class DeviceRaySampler:
    def __init__(self, all_rays: np.ndarray, all_rgbs: np.ndarray, batch: int,
                 generator: torch.Generator, all_depths: Optional[np.ndarray] = None):
        self.buffer = _resident(all_rays, all_rgbs, generator.device, all_depths)
        self.batch = int(batch)
        self.generator = generator

    def next_batch(self) -> torch.Tensor:
        """(batch, 9 or 10) rows, uniform with replacement."""
        ids = torch.randint(0, self.buffer.shape[0], (self.batch,),
                            generator=self.generator, device=self.buffer.device)
        return self.buffer[ids]


class DeviceThetaSampler:
    """The theta-importance draw on the card: per batch one K14f launch
    draws the image and the column uniformly and ``u`` from Philox4x32-10
    under key (``seed``, t), picks the row by the cdf and gathers the
    resident buffer's rows; t counts this sampler's batches (1, 2, ...),
    so every caller of :meth:`next_batch` (training and envmap pretrain
    steps) advances it.  The cdf is ``np.cumsum(weight)`` in float64 cast
    to float32, as JAX's (``samplers.py:88``), made once."""

    def __init__(self, all_rays: np.ndarray, all_rgbs: np.ndarray,
                 sampler: ThetaImportanceSampler, batch: int, device, seed: int = 0,
                 all_depths: Optional[np.ndarray] = None):
        self.buffer = _resident(all_rays, all_rgbs, device, all_depths)
        self.cdf = torch.as_tensor(np.cumsum(sampler.weight).astype(np.float32),
                                   device=self.buffer.device)
        self.img_len, self.w, self.h = sampler.img_len, sampler.w, sampler.h
        self.batch = int(batch)
        self.seed = int(seed)
        self.t = 0

    def draw(self, t: int):
        """(ids (batch,) int64, rows (batch, 9 or 10)) of batch ``t``; the
        counter does not move."""
        return ops.KERNELS.theta_batch(self.buffer, self.cdf, self.w, self.h, self.batch,
                                       self.seed, t)

    def next_batch(self) -> torch.Tensor:
        """(batch, 9 or 10) rows of the next batch, with replacement."""
        self.t += 1
        return self.draw(self.t)[1]


class HostRaySampler:
    def __init__(self, all_rays: np.ndarray, all_rgbs: np.ndarray, sampler, device,
                 all_depths: Optional[np.ndarray] = None):
        self.buffer = _resident(all_rays, all_rgbs, device, all_depths)
        self.sampler = sampler

    def next_batch(self) -> torch.Tensor:
        """(batch, 9 or 10) rows of the host sampler's next ids.  On the card the
        ids go through pinned memory, so the copy does not hold the host
        until the card has caught up."""
        ids = torch.from_numpy(self.sampler.nextids())
        if self.buffer.is_cuda:
            ids = ids.pin_memory().to(self.buffer.device, non_blocking=True)
        return self.buffer[ids]
