"""Collectives over the ranks: the counterparts of what asva_tpu's
partitioner inserts.

Over the replicas (the default process group):
  * all_reduce_mean_ — tensors replaced by their mean over the ranks (the
    gradients once per optimizer step, the logged losses once per log
    boundary);
  * broadcast_ — tensors replaced by rank 0's (replicas start equal);
  * all_reduce_sum — a differentiable sum over the ranks of a group
    (BatchNorm's global statistics, GroupNorm's over sharded frames): its
    backward sums the incoming gradients.

Over one axis of a mesh (a subgroup; parallel/mesh.py):
  * all_gather_shards / reduce_scatter_mean — FSDP's parameter gather and
    its gradient's reduction (parallel/sharding.py), and the batch gather
    of sharded generation;
  * all_gather_frames, broadcast_frame0, prev_frame_halo — the frame axis
    of a video sharded over the seq axis: temporal attention's K/V, frame
    0 (the first-frame K/V and the temporal mix's head tap), and the
    temporal mix's previous frame at a shard's edge.

Backends.  Gloo takes CUDA tensors only in broadcast and all_reduce (ranks
that share a card run over gloo, `multihost.local_layout`), so on gloo a
gather or a send of a CUDA tensor is staged through the host and a
reduce-scatter is an all_reduce of which each rank keeps its part; on NCCL
(a card a rank) they call all_gather_into_tensor, reduce_scatter_tensor
and send/recv.  The choice follows the group's backend.  A failed
collective raises.  Either backend sums the ranks' values in an order
that depends on the collective and on an element's place in its buffer:
beyond two ranks, a gradient reduced alone (FSDP) and the same gradient
reduced in a bucket (data parallelism) may differ in the last bits.

Replica tensors travel in flat buckets of one dtype and device of at most
BUCKET_BYTES, so a model's thousand tensors cost tens of collectives, not a
thousand.  The trainers take gradients with `torch.autograd.grad`, so no
DistributedDataParallel: it reduces only from `.backward()`'s hooks.
On one process every replica function is the identity.
"""
from __future__ import annotations

from typing import Iterable, List

import torch

from ..observability import span

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
        with span("comm.all_reduce"):
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


# ------------------------------------------------------ one mesh axis ---

def _nccl(group) -> bool:
    import torch.distributed as dist
    return dist.get_backend(group) == "nccl"


def all_gather_shards(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' equal-shaped `x` of `group` concatenated along `dim` in
    group-rank order, contiguous, on x's device."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if _nccl(group):
        out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
        dist.all_gather_into_tensor(out, xt, group=group)
    else:
        host = xt.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat(parts).to(x.device)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_mean(x: torch.Tensor, group, dim: int = 0
                        ) -> torch.Tensor:
    """This rank's block along `dim` of the ranks' mean of `x` over
    `group` (x's size along `dim` divides by the group's): the sum, then
    one divide by the group's size, as `all_reduce_mean_` takes it."""
    import torch.distributed as dist
    n, i = dist.get_world_size(group), dist.get_rank(group)
    xt = x.movedim(dim, 0).contiguous()
    rows = xt.shape[0] // n
    if _nccl(group):
        out = xt.new_empty((rows,) + xt.shape[1:])
        dist.reduce_scatter_tensor(out, xt, group=group)
    else:
        full = xt.clone()
        dist.all_reduce(full, group=group)
        out = full[i * rows:(i + 1) * rows]
    return (out / n).movedim(0, dim).contiguous()


def all_gather_frames(x: torch.Tensor, group) -> torch.Tensor:
    """(b, f, ...) frame shards -> (b, f * seq, ...), in seq order."""
    return all_gather_shards(x, group, dim=1)


def broadcast_frame0(x: torch.Tensor, group) -> torch.Tensor:
    """Global frame 0, (b, 1, ...): seq index 0's first frame on every
    rank of `group`."""
    import torch.distributed as dist
    first = x[:, :1].clone(memory_format=torch.contiguous_format)
    dist.broadcast(first, src=dist.get_global_rank(group, 0), group=group)
    return first


def prev_frame_halo(x: torch.Tensor, group) -> torch.Tensor:
    """(b, 1, ...): the last frame of the seq rank before this one (seq
    index 0 receives the last rank's: the ring closes; its caller keeps
    frame 0's own rule).  Every rank of `group` must call it."""
    import torch.distributed as dist
    n, i = dist.get_world_size(group), dist.get_rank(group)
    last = x[:, -1:].clone(memory_format=torch.contiguous_format)
    send = last if _nccl(group) else last.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (i + 1) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (i - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)
