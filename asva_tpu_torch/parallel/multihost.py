"""The multi-process helpers of the train and eval CLIs, as torch.distributed.
Port of asva_tpu/parallel/multihost.py (:17-178):

  * maybe_initialize_distributed — joins the process group that torchrun's
    `env://` variables describe (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, LOCAL_RANK, LOCAL_WORLD_SIZE); False where they name no peers;
  * make_global_batch — this rank's rows onto its device;
  * process_allgather — a host array gathered over the ranks;
  * gather_metric_records — per-example records of every rank, each example
    index once;
  * globalize_host_local — the identity (see its docstring);

and the small pieces the checkpoints and loggers need: `process_index`,
`process_count`, `barrier` and `broadcast_object`.

Host arrays, the barrier and object broadcasts go over a gloo group, the
"host group": NCCL takes no CPU tensors, and only gloo bounds a barrier
with `monitored_barrier`.  Where the default group is gloo it is the host
group; under NCCL `maybe_initialize_distributed` makes a second, gloo group.
Every collective wait is bounded by the group's timeout (TIMEOUT_S), so a
dead peer raises instead of hanging.
"""
from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch

log = logging.getLogger("asva_tpu_torch")

#: bound on every collective wait, asva_tpu's checkpoint barrier (1800 s)
TIMEOUT_S = 1800.0

# the gloo group of host collectives where the default group is NCCL; one
# per process, like the default group itself
_HOST_GROUP = {}


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    import torch.distributed as dist
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The process group's size; 1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if _initialized() else 1


def local_layout(device) -> tuple:
    """(backend, device) of this local rank by rule: on the CPU gloo and
    the CPU; on CUDA, NCCL with card LOCAL_RANK when every local rank has a
    card of its own (LOCAL_WORLD_SIZE <= device count), else gloo with the
    ranks sharing the cards (card LOCAL_RANK % device count)."""
    if torch.device(device).type != "cuda":
        return "gloo", str(device)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"device {device!r}: no CUDA card is visible")
    rank = int(os.environ.get("LOCAL_RANK", process_index()))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))
    backend = "nccl" if local_world <= count else "gloo"
    return backend, f"cuda:{rank % count}"


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the process group of torchrun's `env://` variables.

    True when a process group is (or already was) initialized; False when
    WORLD_SIZE is unset or 1, and then nothing is started.  With WORLD_SIZE
    above 1 a failed `init_process_group` raises: N ranks that each carried
    on as one process would train on duplicate data and overwrite each
    other's checkpoints (asva_tpu/parallel/multihost.py:46-55).  The backend
    follows `local_layout(device)`; a CUDA rank's card becomes its current
    device, and under NCCL the group is bound to that card at init
    (`device_id`), so no communicator guesses its device."""
    import torch.distributed as dist
    if _initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    backend, dev = local_layout(device)
    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    try:
        dist.init_process_group(
            backend, init_method="env://", timeout=timeout,
            device_id=torch.device(dev) if backend == "nccl" else None)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group({backend!r}) failed "
            f"although WORLD_SIZE={world} names peers: {e}") from e
    if backend != "gloo":
        _HOST_GROUP["group"] = dist.new_group(backend="gloo",
                                              timeout=timeout)
    log.info("torch.distributed: backend %s, world %d, rank %d, device %s",
             backend, dist.get_world_size(), dist.get_rank(), dev)
    return True


def host_group():
    """The gloo group of host collectives (None: the default group)."""
    import torch.distributed as dist
    if "group" in _HOST_GROUP:
        return _HOST_GROUP["group"]
    if dist.get_backend() != "gloo":
        raise RuntimeError(
            "the default process group is not gloo and has no gloo host "
            "group: initialize it through maybe_initialize_distributed")
    return None


def barrier(timeout_s: float = TIMEOUT_S) -> None:
    """Return once every rank has reached this call; raise after
    `timeout_s` naming the ranks that did not.  No-op on one process."""
    import torch.distributed as dist
    if process_count() > 1:
        dist.monitored_barrier(group=host_group(),
                               timeout=datetime.timedelta(seconds=timeout_s))


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (a picklable value)."""
    import torch.distributed as dist
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def make_global_batch(tree: dict, device) -> dict:
    """{name: host tensor or array} -> the same on `device`.  A pinned host
    tensor (the loader pins its batches when a card is present) is copied
    without blocking the host; the caching host allocator keeps its memory
    until the copy has run.

    Each rank passes its own local batch and gets it back on its device:
    torch has no global array, so this is the same call under a process
    group.  The global batch is the concatenation of the ranks' batches in
    rank order (asva_tpu's `make_array_from_process_local_data`)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in tree.items()}


def process_allgather(x, tiled: bool = True) -> np.ndarray:
    """An equal-shaped host array gathered over the ranks (the host group):
    tiled=True concatenates on axis 0, else a leading process axis is
    stacked.  One process: the array."""
    import torch.distributed as dist
    x = np.asarray(x)
    world = process_count()
    if world == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x.astype(np.uint8)
                                              if x.dtype == bool else x))
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=host_group())
    out = np.stack([p.numpy().astype(x.dtype) for p in parts])
    return out.reshape((-1,) + x.shape[1:]) if tiled else out


def gather_metric_records(indices, values, value_shape=None):
    """Per-example eval records of every rank, each example index once:
    (unique indices, their first values in rank order) sorted by index
    (asva_tpu/parallel/multihost.py:111-142).  Ragged counts are padded to
    the largest with index -1.  `value_shape` gives a record's trailing
    shape and must be passed, the same on every rank, where a rank may
    have no record: an empty list has no trailing shape to gather."""
    indices = np.asarray(indices, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)
    if value_shape is not None:
        values = values.reshape((len(indices),) + tuple(value_shape))
    if process_count() > 1:
        m = int(process_allgather(np.array([len(indices)])).max())
        pad_idx = np.full((m,), -1, dtype=np.int64)
        pad_idx[:len(indices)] = indices
        pad_val = np.zeros((m,) + values.shape[1:], dtype=np.float64)
        pad_val[:len(values)] = values
        indices = process_allgather(pad_idx)
        values = process_allgather(pad_val)
        keep = indices >= 0
        indices, values = indices[keep], values[keep]
    uniq, first = np.unique(indices, return_index=True)
    return uniq, values[first]


def globalize_host_local(tree, mesh=None):
    """The identity, on one process and across processes.  asva_tpu
    re-places the host-local scalars of its train state (the step, Adam's
    count) as global arrays because orbax cannot write a host-local array
    collectively.  Here every rank holds a full replica of its state, and
    only rank 0 writes a checkpoint (training/checkpoint.py), so nothing is
    host-local in that sense."""
    return tree
