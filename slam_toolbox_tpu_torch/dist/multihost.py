"""Multi-process initialization and the rank mesh of the distributed paths.

PyTorch counterpart of slam_toolbox_tpu/dist/multihost.py. JAX's model is
one process per host and a `Mesh` over every device; here it is one rank
per device (the PyTorch idiom): every participating process calls
`initialize`, which starts the default `torch.distributed` process group
(NCCL between cards, gloo between CPU processes), and `global_mesh()`
describes this rank's place in it. The distributed functions of dist/
take that `Mesh` where the JAX ones take theirs, and every rank calls
them on the same inputs in the same order: each computes its own shard
and the collectives (all_reduce for psum, all_gather, ring shifts for
ppermute) join them, so every rank ends with the same result.

Usage (per process):
    from slam_toolbox_tpu_torch.dist import multihost
    multihost.initialize()          # reads SLAM_COORD/SLAM_NPROCS/
                                    # SLAM_PROC_ID, or torch's env://
    mesh = multihost.global_mesh()  # this rank, the group's size
    ... distributed_lm_solve(mesh, ...)
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from slam_toolbox_tpu_torch.device import resolve_device, world_size


@dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D mesh: its process group (None for a lone process,
    whose collectives are the identity), rank, size and device. Tensors
    given to the collectives live on `device`; bool tensors are not
    reduced (NCCL has no bool): callers convert them first."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (psum); in place, and returned."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (all the same shape), concatenated in rank order
        along dim 0."""
        if self.group is None:
            return t
        parts: List[torch.Tensor] = [torch.empty_like(t)
                                     for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, 0)

    def shift(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """Ring shift by k (ppermute with pairs (i, (i + k) % size)): rank
        i sends `t` to rank i + k and receives rank i - k's. A shift by a
        multiple of the size is the identity, done as a local copy rather
        than a send to self."""
        if k % self.size == 0:
            return t.clone()
        t = t.contiguous()
        out = torch.empty_like(t)
        ranks = dist.get_process_group_ranks(self.group)
        ops = [
            dist.P2POp(dist.isend, t, ranks[(self.rank + k) % self.size],
                       self.group),
            dist.P2POp(dist.irecv, out, ranks[(self.rank - k) % self.size],
                       self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def rank_device(rank: int, backend: str) -> torch.device:
    """The device a rank drives: the CPU under gloo; under NCCL
    cuda:LOCAL_RANK, or rank % device_count() without LOCAL_RANK."""
    if backend != "nccl":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", idx)


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Start the default process group from explicit args, or the
    SLAM_COORD (host:port) / SLAM_NPROCS / SLAM_PROC_ID environment, or
    else torch.distributed's own env:// variables (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE). Returns True if a group of more than
    one process is up, False for a single process (no coordinator
    configured: a valid deployment). The backend defaults to NCCL when a
    card is present, gloo otherwise."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("SLAM_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("SLAM_NPROCS", "0") or 0)
    if process_id is None:
        pid = os.environ.get("SLAM_PROC_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator:
        init, size, rank = f"tcp://{coordinator}", num_processes, process_id
    elif os.environ.get("MASTER_ADDR"):
        init = "env://"
        size = int(os.environ.get("WORLD_SIZE", "1") or 1)
        rank = int(os.environ.get("RANK", "0") or 0)
    else:
        return False
    if size <= 1:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank_device(rank, backend))
    dist.init_process_group(backend, init_method=init, world_size=size,
                            rank=rank)
    return True


def global_mesh(device=None) -> Mesh:
    """The mesh of every rank of the default process group, or a size-1
    mesh on `device` (default: the card) when no group is up. Under a
    group, `device` defaults to the rank's own (rank_device)."""
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        dev = (resolve_device(device) if device is not None
               else rank_device(rank, dist.get_backend()))
        return Mesh(dist.group.WORLD, rank, dist.get_world_size(), dev)
    return Mesh(None, 0, 1, resolve_device(device))


def process_info():
    up = dist.is_available() and dist.is_initialized()
    size = world_size()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": size,
        "local_devices": 1,     # one rank per device
        "global_devices": size,
    }
