"""Data parallelism over a ``torch.distributed`` process group
(counterpart of ``egonerf_tpu/parallel/mesh.py``).

JAX shards the batch over a 1-D data mesh, replicates the field and lets
XLA insert one gradient ``psum`` a step.  The port does the same by hand
over the ranks of a process group, one device a rank:

* every rank builds the same global batch (the samplers are seed-identical
  across ranks, as JAX's processes are) and takes its contiguous shard of
  ``batch_size / world`` rays;
* the per-ray draws are those of the global batch: the draws that come from
  the step's generator are taken for the whole batch and sliced, which also
  keeps every rank's generator in one state, and K4's and K4c's draws are
  keyed by the global ray index (the shard's first ray is their offset);
* after the backward one ``all_reduce`` of a single flat bucket averages the
  gradients (and the shard's MSE, so that the logged value is the batch's);
* the parameters start from rank 0's (one ``broadcast``) and stay
  identical, since every rank applies the same update to the same values;
* the evaluation splits a view's chunks over the ranks and gathers the
  outputs, so every rank holds the whole image, as JAX replicates them;
* only the lead rank writes files.

The collectives are library calls (NCCL on CUDA devices, gloo on the CPU):
the JAX package has no hand-written collective either.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def process_count() -> int:
    """The number of ranks of the default process group (1 without one)."""
    return _group_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_lead_process() -> bool:
    """True on the rank that owns file IO (logs, checkpoints, images, the
    trace); a run without a process group is always the lead."""
    return process_index() == 0


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def backend_for(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched() -> bool:
    """True under ``python -m torch.distributed.run``, which sets RANK,
    WORLD_SIZE and LOCAL_RANK for every process it starts."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def rank_device(device="cuda") -> torch.device:
    """The device of this process: under a launch ``cuda`` means
    ``cuda:LOCAL_RANK``; the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and launched():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def init_from_env(device="cuda") -> bool:
    """Join the process group of a ``torch.distributed.run`` launch (its
    rendezvous in MASTER_ADDR / MASTER_PORT) unless one exists already,
    with :func:`backend_for` the device's backend.  Returns whether this
    process is in a process group."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True


class DataMesh:
    """A 1-D data mesh over the ranks of ``group`` (the default group when
    None): each rank one shard of the batch and of a view's chunks."""

    def __init__(self, group=None):
        self.group = group
        self.world = _group_size(group)
        self.rank = dist.get_rank(group)

    def shard(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's contiguous shard of ``n`` rows; ``n``
        must be a multiple of the world size."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Every tensor set to rank ``src``'s values, in place."""
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src, group=self.group)

    def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor replaced by its mean over the ranks, in place: one
        ``all_reduce`` of a flat float32 bucket of all of them, divided by
        the world size."""
        if not tensors:
            return
        with torch.no_grad():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.world)
            off = 0
            for t in tensors:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped ``t`` concatenated along dim 0 in rank
        order, on every rank."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(mesh_shape: Optional[Sequence[int]] = None, group=None) -> Optional[DataMesh]:
    """The data mesh of a run: None without a process group (one process,
    one device), else a :class:`DataMesh` over ``group`` (the default
    group when None).  ``mesh_shape`` keeps JAX's meaning: None is the
    whole group, ``[n]`` must name its size; anything else is a
    ``ValueError`` that names both numbers."""
    in_group = group is not None or (dist.is_available() and dist.is_initialized())
    world = _group_size(group) if in_group else 1
    if mesh_shape:
        n = int(np.prod(mesh_shape))
        if len(mesh_shape) != 1 or n != world:
            raise ValueError(f"mesh_shape {list(mesh_shape)} asks for {n} devices on one data "
                             f"axis; the process group has {world}")
    return DataMesh(group) if in_group else None


def check_batch(batch_size: int, mesh: Optional[DataMesh]) -> None:
    """A batch that the world size does not divide cannot be sharded (JAX's
    sharding fails on it too)."""
    if mesh is not None and batch_size % mesh.world:
        raise ValueError(f"batch_size {batch_size} does not split over {mesh.world} ranks")


def grads_of(params) -> List[torch.Tensor]:
    """The gradients that the backward gave (every rank takes the same
    path, so the same ones are None on every rank)."""
    return [p.grad for p in params.values() if p.grad is not None]
