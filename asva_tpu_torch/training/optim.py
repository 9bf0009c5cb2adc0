"""Optimizer construction with trainable-parameter masking.

Port of asva_tpu/training/optim.py.  The reference fine-tunes only the
parameters whose torch names contain "_temp" or "_audio"
(configs/audio-cond_animation/*.yaml `trainable_modules`); everything else —
the grafted SD1.5 image weights — stays frozen.  Here the policy is a
{parameter name: bool} mask over `named_parameters()` with exact-segment
matching; frozen parameters get `requires_grad=False`, no gradient buffer,
no Adam state, no weight decay and no share in the global-norm clip.

`AdamW` follows optax's arithmetic step by step (clip_by_global_norm, then
adamw): the clip scales by max_norm / max(norm, max_norm) with no epsilon,
the update is -lr (m_hat / (sqrt(v_hat) + eps) + wd p), the warmup schedule
is read at the step count before the step (lr 0 on the first warmup step),
and `mu_dtype` stores the first moment in a lower precision.  AdamW
hyperparameters mirror the reference configs: lr 1e-4 constant (or linear
warmup), betas (0.9, 0.999), eps 1e-8, weight decay 1e-2, clip 1.0.

Under FSDP (parallel/sharding.py) it steps on the parameters' shards with
moments of the same shards; the update is elementwise, so each element
takes the arithmetic of one process.  The clip's global norm takes each
split gradient's sum of squares over the full gradient, gathered one
parameter at a time, so the norm has the bits of the unsharded one.  Its
state dict holds the full moments (gathered on every rank) and a load
takes each shard's block, so it reads and writes the state of one process.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from ..observability import span
from ..parallel import sharding

# module-path segments of the torch key space that the reference's
# "_temp"/"_audio" substrings select (attn_audio, norm_audio, attn_temp,
# norm_temp, pos_embedding_temp in the transformer block, and the FF convs'
# conv_temp)
TRAINABLE_SEGMENTS = frozenset({
    "attn_audio", "norm_audio", "attn_temp", "norm_temp",
    "pos_embedding_temp", "conv_temp",
})


def segments_for_trainable_modules(modules: Sequence[str]) -> frozenset:
    """Translate the reference YAML's trainable_modules tokens (torch-name
    substrings like "_temp"/"_audio") into exact path segments."""
    table = {
        "temp": ("attn_temp", "norm_temp", "pos_embedding_temp", "conv_temp"),
        "audio": ("attn_audio", "norm_audio"),
    }
    segs = set()
    for m in modules:
        key = m.strip("_")
        if key not in table:
            logging.getLogger("asva_tpu_torch").warning(
                "trainable_modules token %r is not a known module family "
                "(%s); it will be matched as a literal path segment", m,
                sorted(table))
        segs |= set(table.get(key, (m,)))
    return frozenset(segs)


def trainable_mask(module: nn.Module,
                   segments: Optional[Sequence[str]] = None
                   ) -> Dict[str, bool]:
    """{parameter name: True where any FULL dot-separated segment of the
    name is in `segments`} (default TRAINABLE_SEGMENTS).  Exact segment
    matching: a parameter whose name merely contains "temp" cannot silently
    become trainable.  segments=() marks everything trainable."""
    seg_set = TRAINABLE_SEGMENTS if segments is None else frozenset(segments)
    mask = {name: (not seg_set or any(s in seg_set for s in name.split(".")))
            for name, _ in module.named_parameters()}
    if seg_set and mask and not any(mask.values()):
        raise ValueError(
            f"trainable_mask: no parameter path matches segments "
            f"{sorted(seg_set)} — a masked optimizer would silently train "
            "nothing")
    return mask


def apply_trainable_mask(module: nn.Module, mask: Dict[str, bool],
                         frozen_dtype: Optional[torch.dtype] = None
                         ) -> nn.Module:
    """Set requires_grad from the mask.  With `frozen_dtype`, frozen
    parameters are stored in that dtype: one rounding, the value the cast at
    use gives anyway, at half the memory for bf16.  Trainable parameters
    keep their dtype (fp32)."""
    for name, p in module.named_parameters():
        p.requires_grad_(mask[name])
        if not mask[name] and frozen_dtype is not None:
            p.data = p.data.to(frozen_dtype)
    return module


class AdamW:
    """optax.chain(clip_by_global_norm, adamw) over a fixed list of named
    parameters.  `step(grads)` takes the gradients in the order of `names`."""

    def __init__(self, named_params: Dict[str, nn.Parameter],
                 learning_rate: float, max_grad_norm: float, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 warmup_steps: int, mu_dtype: Optional[torch.dtype]):
        self.names: List[str] = list(named_params)
        self.params: List[nn.Parameter] = list(named_params.values())
        self.learning_rate, self.max_grad_norm = learning_rate, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.warmup_steps = weight_decay, warmup_steps
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr(self, count: int) -> float:
        """The schedule at `count` steps taken (optax.linear_schedule)."""
        if self.warmup_steps > 0:
            return (self.learning_rate * min(count, self.warmup_steps)
                    / self.warmup_steps)
        return self.learning_rate

    @torch.no_grad()
    def step(self, grads: Iterable[torch.Tensor]) -> torch.Tensor:
        """One update; returns the global gradient norm before clipping."""
        grads = list(grads)
        if len(grads) != len(self.params) or any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise ValueError(f"no gradient for trainable parameters "
                             f"{missing[:8]}")
        with span("optim.clip"):
            grads = [g.float() for g in grads]
            norm = torch.sqrt(sum(
                (sharding.full_tensor(p, g).square().sum()
                 for p, g in zip(self.params, grads)),
                start=torch.zeros((), device=grads[0].device)))
            # optax: g if norm < max_norm else (g / norm) * max_norm
            clip = norm >= self.max_grad_norm
            grads = [torch.where(clip, (g / norm) * self.max_grad_norm, g)
                     for g in grads]
        lr = self.lr(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        with span("optim.adamw"):
            for i, (p, g) in enumerate(zip(self.params, grads)):
                # optax decays the stored moment in its own dtype: with a
                # bf16 mu_dtype both b1 and the product are rounded to bf16
                decayed = self.mu[i] * self.mu[i].new_tensor(self.b1)
                mu = (1.0 - self.b1) * g + decayed.float()
                nu = (1.0 - self.b2) * g.square() + self.b2 * self.nu[i]
                update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
                update = update + self.weight_decay * p.float()
                p.add_((-lr * update).to(p.dtype))
                self.mu[i] = mu.to(self.mu[i].dtype)
                self.nu[i] = nu
        return norm

    def state_dict(self) -> dict:
        """The moments in full (every rank of an fsdp group must call)."""
        return {"count": self.count,
                "mu": {n: sharding.full_tensor(p, m) for n, p, m in
                       zip(self.names, self.params, self.mu)},
                "nu": {n: sharding.full_tensor(p, v) for n, p, v in
                       zip(self.names, self.params, self.nu)}}

    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.names):
            raise ValueError("optimizer state names differ from the "
                             "trainable parameters")
        self.count = int(state["count"])
        for i, (name, p) in enumerate(zip(self.names, self.params)):
            mu = sharding.block_of(p, state["mu"][name])
            nu = sharding.block_of(p, state["nu"][name])
            self.mu[i] = mu.to(device=p.device, dtype=self.mu[i].dtype)
            self.nu[i] = nu.to(device=p.device, dtype=self.nu[i].dtype)


def build_optimizer(
    module: nn.Module,
    learning_rate: float = 1e-4,
    *,
    mask: Optional[Dict[str, bool]] = None,
    max_grad_norm: float = 1.0,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    adam_eps: float = 1e-8,
    weight_decay: float = 1e-2,
    warmup_steps: int = 0,
    mu_dtype: Optional[torch.dtype] = None,
) -> AdamW:
    """AdamW over the parameters of `module` that the mask marks trainable
    (mask None: those with requires_grad).  Weight decay and the clip run
    over these parameters only."""
    named = {name: p for name, p in module.named_parameters()
             if (p.requires_grad if mask is None else mask[name])}
    if not named:
        raise ValueError("build_optimizer: no trainable parameter")
    return AdamW(named, learning_rate, max_grad_norm, adam_beta1, adam_beta2,
                 adam_eps, weight_decay, warmup_steps, mu_dtype)
