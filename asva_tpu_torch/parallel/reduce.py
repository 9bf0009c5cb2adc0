"""Collectives over the ranks' replicas (the default process group): the
counterpart of the cross-replica mean that asva_tpu's partitioner inserts
into a step sharded by batch.

  * all_reduce_mean_ — tensors replaced by their mean over the ranks (the
    gradients once per optimizer step, the logged losses once per log
    boundary);
  * broadcast_ — tensors replaced by rank 0's (replicas start equal);
  * all_reduce_sum — a differentiable sum over the ranks (BatchNorm's
    global statistics): its backward sums the incoming gradients.

Tensors travel in flat buckets of one dtype and device of at most
BUCKET_BYTES, so a model's thousand tensors cost tens of collectives, not a
thousand.  The trainers take gradients with `torch.autograd.grad`, so no
DistributedDataParallel: it reduces only from `.backward()`'s hooks.
On one process every function is the identity.
"""
from __future__ import annotations

from typing import Iterable, List

import torch

BUCKET_BYTES = 25 * 2 ** 20


def _buckets(tensors: List[torch.Tensor]):
    """Runs of tensors of one dtype and device, each of at most
    BUCKET_BYTES (or one larger tensor), in the given order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        run, size = [], 0
        for t in group:
            nbytes = t.numel() * t.element_size()
            if run and size + nbytes > BUCKET_BYTES:
                yield run
                run, size = [], 0
            run.append(t)
            size += nbytes
        if run:
            yield run


def _bucketed_(tensors: Iterable[torch.Tensor], collective) -> int:
    """Apply `collective(flat)` to each bucket's flat copy and write the
    result back; returns the bytes that took part."""
    total = 0
    with torch.no_grad():
        for run in _buckets(list(tensors)):
            flat = torch.cat([t.reshape(-1) for t in run])
            collective(flat)
            total += flat.numel() * flat.element_size()
            offset = 0
            for t in run:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return total


def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh) -> int:
    """Replace each tensor by its mean over the ranks of `mesh`, in place;
    returns the bytes reduced (0 on one process).  Every rank receives
    the same sum, so replicas stay bit-equal."""
    import torch.distributed as dist
    if mesh is None or mesh.world == 1:
        return 0

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(mesh.world)
    return _bucketed_(tensors, mean)


def broadcast_(tensors: Iterable[torch.Tensor], mesh) -> int:
    """Replace each tensor by rank 0's, in place; returns the bytes."""
    import torch.distributed as dist
    if mesh is None or mesh.world == 1:
        return 0
    return _bucketed_(tensors, lambda flat: dist.broadcast(flat, src=0))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (None: the default group),
    differentiable: rank r's gradient is the sum over ranks of the
    gradients that reach the result, as the loss of the whole batch
    demands."""
    return _AllReduceSum.apply(x, group)
