"""Multi-host set-up on ``torch.distributed`` (counterpart of
``any4_tpu/parallel/distributed.py``).

A world of processes, each with its own rank, spread over hosts of
several local ranks: :func:`initialize` joins it, from an explicit address
or from ``torchrun``'s environment, and :func:`make_multihost_mesh` lays a
``dp x tp`` mesh on it with each tp group inside one host, so that the
tensor-parallel all-reduces stay on the host's own links (NVLink) and only
the data-parallel gather crosses hosts.

A host is told by ``torchrun``'s ``LOCAL_WORLD_SIZE`` (its ranks) and
``GROUP_RANK`` (its index), as it numbers ranks ``host * local_world_size
+ local_rank``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from . import tp as tpmod

# the variables torchrun sets for every rank
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(address: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: str = "gloo") -> bool:
    """Join the process group: at ``address`` (``tcp://host:port``) as
    ``rank`` of ``world_size``, or, with none of them, from ``torchrun``'s
    environment. Returns False (a single process, nothing joined) when
    neither is given. ``backend``: ``"gloo"`` (CPU, and CUDA all-reduce and
    broadcast) or ``"nccl"``."""
    if address is None and world_size is None and rank is None:
        if not all(v in os.environ for v in _TORCHRUN_ENV):
            return False
        dist.init_process_group(backend, init_method="env://")
        return True
    if address is None or world_size is None or rank is None:
        raise ValueError("initialize needs address, world_size and rank "
                         "together")
    dist.init_process_group(backend, init_method=address,
                            world_size=world_size, rank=rank)
    return True


def _local_world_size() -> int:
    """The ranks of one host: ``LOCAL_WORLD_SIZE``, else the whole world
    (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def make_multihost_mesh(tp: Optional[int] = None,
                        device="cuda") -> tpmod.Mesh:
    """A ``dp x tp`` mesh whose tp groups lie within one host (``tp``
    defaults to the host's rank count) and whose dp groups span the hosts.
    Raises unless the world divides into tp groups that each fit in a
    host; checks that every rank of a tp group names the same host."""
    world, local = dist.get_world_size(), _local_world_size()
    tp = tp or local
    if world % tp or local % tp:
        raise ValueError(f"tp={tp} must divide the world ({world}) and a "
                         f"host's {local} ranks")
    host = int(os.environ.get("GROUP_RANK", dist.get_rank() // local))
    hosts = [None] * world
    dist.all_gather_object(hosts, host)
    for i in range(0, world, tp):
        if len(set(hosts[i:i + tp])) != 1:
            raise ValueError(f"ranks {i}..{i + tp - 1} span hosts "
                             f"{sorted(set(hosts[i:i + tp]))}")
    return tpmod.make_mesh(dp=world // tp, tp=tp, device=device)


def is_primary() -> bool:
    """Is this the rank that writes results (rank 0, or a lone process)?"""
    return not dist.is_initialized() or dist.get_rank() == 0
