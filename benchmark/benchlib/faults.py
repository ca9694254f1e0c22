"""Faults that the output check has to catch, each a context manager that
plants it for as long as it is open.  A training cell's are planted in the
program (a step that leaves the state unchanged; half the batch left out,
the mean taken over the rest); a render cell's in the reference put in the
program's place (the depth without its background term; the envmap read at
its nearest texel in place of the bilinear sample).  The CPU tests plant
them at a small size; ``control.py --fault`` reads them on the card at the
cell's own."""
from __future__ import annotations

from contextlib import contextmanager
from math import pi
from unittest import mock

import torch

from benchref import egonerf as ref


@contextmanager
def unchanged_state():
    from egonerf_torch.train.optim import Optimizer

    def step(self):
        self.count += 1

    with mock.patch.object(Optimizer, "step", step):
        yield


@contextmanager
def half_batch():
    from egonerf_torch.data.samplers import DeviceRaySampler

    whole = DeviceRaySampler.next_batch

    def half(self):
        rows = whole(self)
        return rows[: rows.shape[0] // 2]

    with mock.patch.object(DeviceRaySampler, "next_batch", half):
        yield


@contextmanager
def depth_no_background():
    whole = ref.forward

    def forward(p, rays, *args, **kw):
        out = whole(p, rays, *args, **kw)
        out["depth"] = out["depth"] - (1.0 - out["acc"]) * rays[:, -1]
        return out

    with mock.patch.object(ref, "forward", forward):
        yield


def _envmap_nearest(table, dirs):
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    norm = torch.sqrt(x * x + y * y + z * z)
    h = table.shape[1]
    u = (z / norm + 1.0) * 0.5 * (h - 1)
    v = (torch.atan2(y / norm, x / norm) + pi) / (2.0 * pi) * (2 * h - 1)
    idx = torch.round(v).long().clamp(0, 2 * h - 1) * h + torch.round(u).long().clamp(0, h - 1)
    return torch.sigmoid(table.reshape(-1, 3)[idx])


@contextmanager
def envmap_nearest():
    with mock.patch.object(ref, "envmap_radiance", _envmap_nearest):
        yield


PROGRAM = {"unchanged-state": unchanged_state, "half-batch": half_batch}
REFERENCE = {"depth-no-background": depth_no_background, "envmap-nearest": envmap_nearest}
