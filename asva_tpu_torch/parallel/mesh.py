"""The process mesh of a data-parallel job.  Port of
asva_tpu/parallel/mesh.py (`make_mesh :24`, `batch_sharding :50`,
`replicate :55`).

asva_tpu declares a (data, fsdp) mesh of devices and lets the partitioner
insert the collectives.  Here each rank is one process with one device and
a full replica of the model, and the collectives are explicit
(`parallel/reduce.py`): the gradients' mean once per optimizer step,
BatchNorm's global statistics, rank 0's replica broadcast after a build or
a restore.  FSDP (a sharded model and optimizer state) is ROADMAP A item 2.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Tuple, Union

import torch
from torch import nn

from . import multihost
from .reduce import broadcast_


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the job: its rank among `world`, its local
    rank on its host, its device and the default group's backend ("" on
    one process).  Device collectives run on the default group, host
    arrays on `multihost.host_group()`."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: str = "cpu"
    backend: str = ""


def make_mesh(device="cuda", fsdp: int = 1) -> Mesh:
    """The mesh of the initialized process group (see
    `multihost.maybe_initialize_distributed`), whose device is this local
    rank's (`multihost.local_layout`); without a group (or with a group of
    one), one process on `device` as given."""
    if fsdp != 1:
        raise ValueError(
            f"fsdp={fsdp}: the port replicates the model on every rank; "
            "sharding it (FSDP) is ROADMAP A item 2")
    if multihost.process_count() == 1:
        return Mesh(device=str(device))
    import torch.distributed as dist
    rank = dist.get_rank()
    return Mesh(rank=rank, world=dist.get_world_size(),
                local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                device=multihost.local_layout(device)[1],
                backend=dist.get_backend())


def batch_sharding(mesh: Mesh) -> Tuple[int, int]:
    """The loader's `shard=(index, count)` of this rank: its equal share of
    every epoch, so the ranks' batches in rank order form the global one."""
    return mesh.rank, mesh.world


def replicate(mesh: Mesh, tensors: Union[nn.Module, Iterable[torch.Tensor]]):
    """Broadcast rank 0's values into this rank's: a module's parameters
    and buffers (BatchNorm's running statistics included), or the given
    tensors (an optimizer's moments).  Returns the argument."""
    items = (list(tensors.parameters()) + list(tensors.buffers())
             if isinstance(tensors, nn.Module) else list(tensors))
    broadcast_(items, mesh)
    return tensors
