"""The process meshes of a job.  Port of asva_tpu/parallel/mesh.py
(`make_mesh :24`, `make_gen_mesh :34`, `batch_sharding :50`,
`replicate :55`).

asva_tpu declares a mesh of devices and lets the partitioner insert the
collectives.  Here each rank is one process with one device, and a mesh is
this rank's place on two axes of the process group, each with the
torch.distributed subgroup of the ranks that differ only along it:

  * make_mesh(fsdp=N): (data, fsdp), the training mesh.  The batch is
    sharded over both axes; parameters of at least `min_size` elements are
    split over `fsdp` (parallel/sharding.py), the rest are replicas whose
    gradients' mean runs over every rank (parallel/reduce.py);
  * make_gen_mesh(seq=N): (data, seq), the generation mesh.  The batch is
    sharded over `data`; `seq` shards the frame axis of the latent video
    (sequence parallelism), and the UNet's frame-axis operations exchange
    what they need over the seq group (`FrameShard`).

The world is data x N with N the fast axis, as asva_tpu's
`np.reshape(n // N, N)`: rank = data_index * N + index.  On one process
both meshes are the identity.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, Optional, Tuple, Union

import torch
from torch import nn

from . import multihost
from .reduce import broadcast_


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in the job: its rank among `world`, its local
    rank on its host, its device and the default group's backend ("" on
    one process); the mesh's axes ("data", then "fsdp" or "seq"), their
    sizes, this rank's index along each and each axis's process group
    (None where the axis has size 1).  Device collectives over every rank
    run on the default group, host arrays on `multihost.host_group()`."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: str = "cpu"
    backend: str = ""
    axes: Tuple[str, str] = ("data", "fsdp")
    sizes: Tuple[int, int] = (1, 1)
    coords: Tuple[int, int] = (0, 0)
    groups: tuple = (None, None)

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis this mesh does not have."""
        return self.sizes[self.axes.index(axis)] if axis in self.axes else 1

    def index(self, axis: str) -> int:
        """This rank's index along the axis; 0 for an absent one."""
        return self.coords[self.axes.index(axis)] if axis in self.axes else 0

    def group(self, axis: str):
        """The process group of the ranks that differ only along `axis`."""
        return self.groups[self.axes.index(axis)] if axis in self.axes \
            else None

    def frame_shard(self, frames: int) -> Optional["FrameShard"]:
        """This rank's share of a video of `frames` frames under the seq
        axis; None where the frames are not sharded."""
        seq = self.size("seq")
        if seq == 1:
            return None
        if frames % seq:
            raise ValueError(f"{frames} frames do not divide over seq={seq}")
        i = self.index("seq")
        return FrameShard(self.group("seq"), seq, i, i * (frames // seq))


@dataclasses.dataclass(frozen=True, eq=False)
class FrameShard:
    """The frame-shard context the UNet carries down to its frame-axis
    operations: the seq axis's process group, its size, this rank's index
    along it, and the global index of this rank's first frame.  Seq index
    0 holds global frame 0."""
    group: object
    count: int
    index: int
    offset: int


def _subgroups(blocks):
    """The process group, among `blocks` (lists of global ranks that every
    rank enumerates in the same order), that holds this rank."""
    import torch.distributed as dist
    mine, _ = dist.new_subgroups_by_enumeration(
        blocks, timeout=datetime.timedelta(seconds=multihost.TIMEOUT_S))
    return mine


def _make(device, axis: str, n: int) -> Mesh:
    world = multihost.process_count()
    if n < 1 or world % n:
        raise ValueError(f"{axis}={n} does not divide the {world} "
                         "processes of the job")
    if world == 1:
        return Mesh(device=str(device), axes=("data", axis))
    import torch.distributed as dist
    rank = dist.get_rank()
    data = world // n
    # the data axis's groups hold the ranks of one index along `axis`
    groups = (_subgroups([[d * n + i for d in range(data)]
                          for i in range(n)]) if data > 1 else None,
              _subgroups([[d * n + i for i in range(n)]
                          for d in range(data)]) if n > 1 else None)
    return Mesh(rank=rank, world=world,
                local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                device=multihost.local_layout(device)[1],
                backend=dist.get_backend(), axes=("data", axis),
                sizes=(data, n), coords=(rank // n, rank % n), groups=groups)


def make_mesh(device="cuda", fsdp: int = 1) -> Mesh:
    """The (data, fsdp) mesh of the initialized process group (see
    `multihost.maybe_initialize_distributed`), whose device is this local
    rank's (`multihost.local_layout`); without a group (or with a group of
    one), one process on `device` as given.  `fsdp` must divide the number
    of processes."""
    return _make(device, "fsdp", fsdp)


def make_gen_mesh(device="cuda", seq: int = 1) -> Mesh:
    """The (data, seq) mesh of generation: `seq` ranks share each clip's
    frames, world // seq groups of them share the batch.  `seq` must
    divide the number of processes."""
    return _make(device, "seq", seq)


def batch_sharding(mesh: Mesh) -> Tuple[int, int]:
    """The loader's `shard=(index, count)` of this rank: its equal share of
    every epoch over every axis but seq, so the shards in rank order form
    the global batch."""
    seq = mesh.size("seq")
    return mesh.rank // seq, mesh.world // seq


def replicate(mesh: Mesh, tensors: Union[nn.Module, Iterable[torch.Tensor]]):
    """Broadcast rank 0's values into this rank's: a module's parameters
    and buffers (BatchNorm's running statistics included), or the given
    tensors (an optimizer's moments).  A module's FSDP shards are left as
    they are: each rank holds another part.  Returns the argument."""
    from .sharding import is_sharded
    items = ([p for p in tensors.parameters() if not is_sharded(p)]
             + list(tensors.buffers())
             if isinstance(tensors, nn.Module) else list(tensors))
    broadcast_(items, mesh)
    return tensors
