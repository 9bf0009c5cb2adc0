"""The multi-process helpers of the train and eval CLIs, in their
one-process forms.  Port of asva_tpu/parallel/multihost.py (:17-178):

  * maybe_initialize_distributed — False when the launcher's environment
    names no peers;
  * make_global_batch — the host batch onto the device, non-blocking from
    pinned memory;
  * process_allgather, globalize_host_local — the identity;
  * gather_metric_records — the records, each example index once.

Across processes (an initialized process group of world size above 1, or a
launcher environment with WORLD_SIZE above 1) each one raises
NotImplementedError: the torch.distributed forms are ROADMAP A7, and
a one-process answer there would be silently wrong (duplicate data, a
rank's own mean taken for the global one).
"""
from __future__ import annotations

import os

import numpy as np
import torch

_ACROSS = ("{name}: more than one process takes part (world size {world}), "
           "and the port runs on one process only; the torch.distributed "
           "forms are ROADMAP A7 (parallel/ across processes)")


def _world_size() -> int:
    """The initialized process group's size, else 1."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _one_process(name: str) -> None:
    world = _world_size()
    if world > 1:
        raise NotImplementedError(_ACROSS.format(name=name, world=world))


def maybe_initialize_distributed() -> bool:
    """True when a process group is already initialized (of one process);
    False when the launcher's environment names no peers (WORLD_SIZE unset
    or 1).  Peers raise NotImplementedError."""
    import torch.distributed as dist
    _one_process("maybe_initialize_distributed")
    peers = int(os.environ.get("WORLD_SIZE", "1"))
    if peers > 1:
        raise NotImplementedError(_ACROSS.format(
            name="maybe_initialize_distributed", world=peers))
    return dist.is_available() and dist.is_initialized()


def make_global_batch(tree: dict, device) -> dict:
    """{name: host tensor or array} -> the same on `device`.  A pinned host
    tensor (the loader pins its batches when a card is present) is copied
    without blocking the host; the caching host allocator keeps its memory
    until the copy has run."""
    _one_process("make_global_batch")
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in tree.items()}


def process_allgather(x, tiled: bool = True) -> np.ndarray:
    """A host array gathered over processes: one process, the array."""
    _one_process("process_allgather")
    return np.asarray(x)


def gather_metric_records(indices, values, value_shape=None):
    """Per-example eval records, each example index once: (unique indices,
    their first values) sorted by index (asva_tpu/parallel/multihost.py:
    111-142; `value_shape` reshapes the values, as there)."""
    _one_process("gather_metric_records")
    indices = np.asarray(indices, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)
    if value_shape is not None:
        values = values.reshape((len(indices),) + tuple(value_shape))
    uniq, first = np.unique(indices, return_index=True)
    return uniq, values[first]


def globalize_host_local(tree, mesh=None):
    """Host-local state made global over processes: one process, as it
    is."""
    _one_process("globalize_host_local")
    return tree
