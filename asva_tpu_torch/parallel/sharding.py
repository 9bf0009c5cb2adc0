"""FSDP: parameters and optimizer state split over the fsdp axis of a
(data, fsdp) mesh.  Port of asva_tpu/parallel/sharding.py (`_spec_for :18`,
`fsdp_shardings :31`, `shard_pytree :42`).

asva_tpu gives each parameter a sharding and lets XLA gather the weights
per layer and reduce-scatter the gradients.  Here the collectives are
explicit:

  * `fsdp_shardings` chooses each parameter's split by `_spec_for`'s rule:
    under `min_size` elements it is replicated, else split along its
    largest axis that divides by the fsdp size, and replicated when none
    does;
  * `shard_module` replaces each split parameter's data by this rank's
    block and tags the parameter with its `ShardSpec`; frozen parameters
    are split too, as asva_tpu splits the whole UNet tree;
  * `call_gathered(module, *args)` runs the module on its full parameters:
    each is gathered over the fsdp group (`_GatherShard`), and the
    gradient that reaches the gathered tensor comes back to the shard as
    the mean over every rank (a reduce-scatter over fsdp, then a mean over
    data), the gradient of the global batch;
  * `full_state_dict` / `load_full_state_dict` write and read the state of
    one process: checkpoints interchange between fsdp sizes.

The optimizer (training/optim.py) steps on the shards with sharded moments.
On one process nothing is split and every function is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .reduce import all_gather_shards, reduce_scatter_mean

#: the attribute of a split parameter that holds its ShardSpec
SPEC = "fsdp_spec"


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSpec:
    """How a parameter is split: along `dim` of `full_shape` into `count`
    equal blocks over the fsdp `group`, this rank holding block `index`;
    the gradient's mean also runs over the `data` ranks of `data_group`."""
    dim: int
    full_shape: tuple
    count: int
    index: int
    group: object
    data: int
    data_group: object

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full tensor, contiguous."""
        rows = self.full_shape[self.dim] // self.count
        return full.narrow(self.dim, self.index * rows, rows).contiguous()


def is_sharded(t: torch.Tensor) -> bool:
    return getattr(t, SPEC, None) is not None


def sharded(module: nn.Module) -> bool:
    """Whether any parameter of `module` is split."""
    return any(is_sharded(p) for p in module.parameters())


def _spec_for(shape: Sequence[int], fsdp_size: int,
              min_size: int) -> Optional[int]:
    """The dim to split a parameter of `shape` along, or None (replicated):
    asva_tpu's rule, the largest axis that divides by the fsdp size."""
    numel = 1
    for s in shape:
        numel *= s
    if fsdp_size <= 1 or numel < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % fsdp_size == 0:
            return i
    return None


def fsdp_shardings(module: nn.Module, mesh, min_size: int = 2 ** 16
                   ) -> Dict[str, Optional[int]]:
    """{parameter name: the dim it is split along, or None}."""
    n = mesh.size("fsdp")
    return {name: _spec_for(p.shape, n, min_size)
            for name, p in module.named_parameters()}


def shard_module(module: nn.Module, shardings: Dict[str, Optional[int]],
                 mesh) -> nn.Module:
    """Replace each split parameter's data by this rank's block (the
    Parameter objects stay, so build the optimizer after) and tag it with
    its ShardSpec.  Returns the module."""
    for name, p in module.named_parameters():
        dim = shardings[name]
        if dim is None:
            continue
        spec = ShardSpec(dim, tuple(p.shape), mesh.size("fsdp"),
                         mesh.index("fsdp"), mesh.group("fsdp"),
                         mesh.size("data"), mesh.group("data"))
        p.data = spec.block(p.data)
        setattr(p, SPEC, spec)
    return module


class _GatherShard(torch.autograd.Function):
    """shard -> the full parameter; backward: the full gradient's mean over
    every rank, this rank's block of it."""

    @staticmethod
    def forward(ctx, shard, spec):
        ctx.spec = spec
        return all_gather_shards(shard, spec.group, spec.dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        spec = ctx.spec
        grad = reduce_scatter_mean(grad, spec.group, spec.dim)
        if spec.data > 1:
            dist.all_reduce(grad, group=spec.data_group)
            grad = grad / spec.data
        return grad, None


def gather(shard: torch.Tensor) -> torch.Tensor:
    """The full parameter of a split one (differentiable)."""
    return _GatherShard.apply(shard, getattr(shard, SPEC))


def full_tensor(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The full tensor of `t`, a block shaped like the split parameter
    p's shard (a gradient, a moment); t itself where p is not split.
    Every rank of p's fsdp group must call it."""
    if not is_sharded(p):
        return t
    spec = getattr(p, SPEC)
    return all_gather_shards(t, spec.group, spec.dim)


def block_of(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of a full tensor shaped like parameter p (its
    value, a moment); full itself where p is not split."""
    return getattr(p, SPEC).block(full) if is_sharded(p) else full


def call_gathered(module: nn.Module, *args):
    """module(*args) on its full parameters: the split ones gathered for
    this call and freed with its outputs' graph (callers rematerialise the
    call under autograd, so the backward gathers again)."""
    full = {name: gather(p) for name, p in module.named_parameters()
            if is_sharded(p)}
    return torch.func.functional_call(module, full, args)


def full_state_dict(module: nn.Module) -> dict:
    """module.state_dict() with every split parameter gathered: the state
    of one process.  Every rank of the fsdp group must call it."""
    state = module.state_dict()
    with torch.no_grad():
        for name, p in module.named_parameters():
            if is_sharded(p):
                state[name] = full_tensor(p, p.detach())
    return state


def load_full_state_dict(module: nn.Module, state: dict) -> None:
    """Load a one-process state dict (from `full_state_dict` at any fsdp
    size), each split parameter taking its block."""
    state = dict(state)
    for name, p in module.named_parameters():
        if name in state:
            state[name] = block_of(p, state[name])
    module.load_state_dict(state)
