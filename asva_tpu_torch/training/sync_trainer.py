"""Contrastive AVSync classifier training.  Port of
asva_tpu/training/sync_trainer.py.

Contract: per video, k time-shifted clips; encode all audio and video clips
once, score every (audio_i, video_j) pair with the MLP head (k^2 head evals
per item), and apply symmetric InfoNCE over rows (a->v) and columns (v->a)
with temperature tau (0.1 in the VGGSS config); batch accuracies are argmax
diagonal hits.

A step runs both CNN towers over b*k clips in training mode (BatchNorm by
batch statistics, running statistics updated in the module's buffers), the
k^2 pair scores, the loss, autograd and the AdamW update.  Every parameter
trains: no trainable mask.  With `compute_dtype=torch.bfloat16` the forward
runs under autocast: fp32 parameters, bf16 convolutions and products.

Evaluation (`eval_metrics`, `eval_scores`) puts the classifier in eval mode
under no_grad — BatchNorm uses its running averages, no state changes, and
per-item metrics do not depend on the batch's composition — and restores the
mode it found.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.reduce import all_reduce_mean_
from .optim import AdamW


@dataclasses.dataclass
class SyncTrainState:
    """Step count, the classifier (parameters and BatchNorm buffers) and its
    optimizer."""
    step: int
    classifier: nn.Module
    optimizer: AdamW

    def state_dict(self) -> dict:
        return {"step": self.step,
                "classifier": self.classifier.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.classifier.load_state_dict(state["classifier"])
        self.optimizer.load_state_dict(state["optimizer"])


def _pair_metrics(av_logits, va_logits,
                  flat_labels) -> Dict[str, torch.Tensor]:
    return {"av_loss": F.cross_entropy(av_logits.float(), flat_labels),
            "va_loss": F.cross_entropy(va_logits.float(), flat_labels),
            "av_acc": (av_logits.argmax(-1) == flat_labels).float().mean(),
            "va_acc": (va_logits.argmax(-1) == flat_labels).float().mean()}


@dataclasses.dataclass(eq=False)
class SyncContrastiveTrainer:
    classifier: nn.Module          # AVSyncClassifier
    tau: float = 0.1
    compute_dtype: Optional[torch.dtype] = None   # None: the parameters'

    def _autocast(self):
        device = next(self.classifier.parameters()).device
        if self.compute_dtype in (None, torch.float32):
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.compute_dtype)

    def _pair_logits(self, batch: dict
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Encode b*k clips in the classifier's current mode, score all
        k x k pairs -> (av_logits (b*k, k), va_logits (b*k, k), labels
        (b*k,))."""
        mels, videos = batch["mels"], batch["videos"]
        b, k = mels.shape[:2]
        with self._autocast():
            a_emb, v_emb = self.classifier.encode(mels.flatten(0, 1),
                                                  videos.flatten(0, 1))
            # all k x k pairs per item: (b, k, 1, c) x (b, 1, k, c)
            c = a_emb.shape[-1]
            a = a_emb.reshape(b, k, 1, c).expand(b, k, k, c)
            v = v_emb.reshape(b, 1, k, c).expand(b, k, k, c)
            scores = self.classifier.score_pairs(a.reshape(b * k * k, c),
                                                 v.reshape(b * k * k, c))
        scores = scores.reshape(b, k, k) / self.tau  # rows audio, cols video
        labels = torch.arange(k, device=scores.device).repeat(b)
        av_logits = scores.reshape(b * k, k)                    # audio->video
        va_logits = scores.transpose(1, 2).reshape(b * k, k)    # video->audio
        return av_logits, va_logits, labels

    def loss_fn(self, batch: dict):
        """batch: mels (b, k, 128, 204, 1), videos (b, k, f, h, w, 3).  Runs
        the classifier in training mode (its running statistics move).
        Returns ((av + va) / 2, metrics)."""
        self.classifier.train()
        metrics = _pair_metrics(*self._pair_logits(batch))
        return (metrics["av_loss"] + metrics["va_loss"]) / 2.0, metrics

    def train_step(self, state: SyncTrainState, batch: dict,
                   mesh=None) -> Dict[str, torch.Tensor]:
        """One step on this rank's `batch`.  Across the ranks of `mesh` the
        gradients are their mean before the optimizer (the global batch's,
        since BatchNorm normalises by the global statistics), and so are
        the returned metrics: both go in one reduction."""
        loss, metrics = self.loss_fn(batch)
        grads = list(torch.autograd.grad(loss, state.optimizer.params))
        if mesh is not None and mesh.world > 1:
            stacked = torch.stack([v.detach().float()
                                   for v in metrics.values()])
            all_reduce_mean_(grads + [stacked], mesh)
            metrics = dict(zip(metrics, stacked))
        state.optimizer.step(grads)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @contextlib.contextmanager
    def _eval_mode(self):
        was_training = self.classifier.training
        self.classifier.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            self.classifier.train(was_training)

    def eval_metrics(self, batch: dict) -> Dict[str, torch.Tensor]:
        """The metrics of `loss_fn` with running-average BatchNorm and no
        state change."""
        with self._eval_mode():
            return _pair_metrics(*self._pair_logits(batch))

    def eval_scores(self, mels: torch.Tensor,
                    videos: torch.Tensor) -> torch.Tensor:
        """(mels (n, ...), videos (n, ...)) -> (n,) sync scores, eval mode."""
        with self._eval_mode(), self._autocast():
            return self.classifier(mels, videos)
