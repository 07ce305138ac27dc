"""The process group a sharded run spans (torch port of
lbm_tpu/parallel/mesh.py).

lbm_tpu decomposes the lattice along one axis over a `jax.sharding.Mesh`.
Here each shard is one process of a `torch.distributed` group: rank r
owns rows [r L, (r + 1) L) of the shard axis and its state lives on the
rank's own device. A LatticeMesh holds the group, the rank, the world
size, that device and the backend, which is the caller's choice and
never a reaction to a failure:

  - 'nccl': one card per rank (rank r on cuda:r); it refuses a world
    larger than the card count and a machine without a card;
  - 'gloo' with device 'cpu': CPU ranks (the tests, the CPU CLI);
  - 'gloo' with device 'cuda': CUDA ranks that may share one card; what
    crosses between them (halo planes, gathers) is staged through host
    memory, since gloo sends host tensors.

The shard axis must not host an NEE boundary plane (free_axis picks the
first one that does not): cavity / poiseuille shard x, the coronary
shards y, the curved vessel z (dense backend only).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# a collective or exchange that waits longer than this fails the run
# (a rank that stopped early must not hang the others)
TIMEOUT_S = 300.0


def free_axis(spec) -> int:
    """First lattice axis with no boundary plane on it."""
    used = {bc.axis for bc in spec.boundaries}
    for a in range(3):
        if a not in used:
            return a
    raise ValueError("no boundary-free axis to shard over")


@dataclasses.dataclass(frozen=True)
class LatticeMesh:
    """One rank's view of the group a sharded run spans."""

    group: Optional[dist.ProcessGroup]   # None: the default group
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """Whether device tensors cross through host memory (gloo with
        CUDA ranks)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.group)

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """t where the backend takes it: host memory under gloo, the
        rank's card under nccl (which takes no host tensor)."""
        return t.cpu() if self.backend == "gloo" else t.to(self.device)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's t (one shape on all ranks) concatenated along dim
        in rank order, on t's device (a host tensor crosses through the
        card under nccl)."""
        if self.world == 1:
            return t
        src = self.wire(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim).to(t.device)

    def sum_in_rank_order(self, values: np.ndarray) -> np.ndarray:
        """The sum over ranks of each rank's float64 values (any shape, one
        on all ranks), added in rank order on the host: the same bits on
        every rank, so every rank takes the same stop decision. One
        gather: a run's per-step partials (records, energy) cross once,
        at its end."""
        values = np.asarray(values, np.float64)
        if self.world == 1:
            return values
        rows = self.all_gather(torch.from_numpy(
            np.ascontiguousarray(values)).reshape(1, -1))
        return np.sum(rows.numpy(), axis=0).reshape(values.shape)

    def add_in_rank_order(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of each rank's t (one shape and dtype on all
        ranks), added in rank order in t's dtype on t's device: the same
        bits on every rank (the windkessel outlets' flux, once a step)."""
        if self.world == 1:
            return t
        rows = self.all_gather(t.reshape(1, -1))
        total = rows[0]
        for r in range(1, self.world):
            total = total + rows[r]
        return total.reshape(t.shape)

    def same_on_every_rank(self, t: torch.Tensor) -> bool:
        """Whether every rank holds t bit for bit (the replicated P_c)."""
        if self.world == 1:
            return True
        rows = self.all_gather(t.reshape(1, -1)).cpu()
        ints = rows.view(torch.int32) if rows.dtype == torch.float32 \
            else rows
        return bool((ints == ints[0]).all())


def mesh_device(backend: str, rank: int, device="cuda") -> torch.device:
    """The device of rank `rank`: cuda:rank under nccl; under gloo, with
    device 'cuda' (the default) card rank % device_count (ranks share
    cards), with 'cpu' the CPU. 'cuda' without a card raises, as
    engine/runner.resolve_device does."""
    if backend == "nccl":
        return torch.device("cuda", rank)
    from lbm_tpu_torch.engine.runner import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def lattice_mesh(n: Optional[int] = None, backend: Optional[str] = None,
                 device="cuda", rank: Optional[int] = None, store=None,
                 init_method: Optional[str] = None) -> LatticeMesh:
    """This process's LatticeMesh, joining the default process group
    first if it is not up: from a `store` (a torch.distributed.FileStore)
    with `rank` and world size n, from `init_method` (e.g.
    'tcp://localhost:29512'), or from the environment torchrun sets
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). backend: 'nccl' or
    'gloo' (default: the running group's, else 'gloo'); device: the gloo
    ranks' device type, 'cuda' (the default; raises without a card) or
    'cpu'. Every wait is bounded by TIMEOUT_S."""
    if dist.is_initialized():
        backend = backend or dist.get_backend()
    backend = backend or "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ.get("RANK", "0"))
        if n is None:
            n = int(os.environ.get("WORLD_SIZE", "1"))
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("backend='nccl' needs a CUDA card; "
                                   "torch.cuda.is_available() is False")
            if n > torch.cuda.device_count():
                raise ValueError(
                    f"backend='nccl' runs one rank a card: {n} ranks, "
                    f"{torch.cuda.device_count()} cards")
            torch.cuda.set_device(mesh_device(backend, rank))
        kwargs = dict(backend=backend, rank=rank, world_size=n,
                      timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if store is not None:
            kwargs["store"] = store
        else:
            kwargs["init_method"] = init_method or "env://"
        dist.init_process_group(**kwargs)
    rank, world = dist.get_rank(), dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"the process group has {world} ranks, not {n}")
    return LatticeMesh(group=None, rank=rank, world=world,
                       device=mesh_device(backend, rank, device),
                       backend=backend)


__all__ = ["LatticeMesh", "lattice_mesh", "free_axis", "mesh_device",
           "BACKENDS", "TIMEOUT_S"]
