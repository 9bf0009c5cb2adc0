"""AVSync classifier: audio CNN + R(2+1)D video CNN + MLP head.

Port of asva_tpu/models/avsync/classifier.py (:50-156), in the reference's
torch key space (the one `avsync_key_map` maps from: `conv1.0` / `conv1.1`
stems, `block1..4`, `conv2x..5x.{0,1}`, `fc.0/3/6`).  In eval mode the
BatchNorms use their running statistics; in training mode (`module.train()`,
asva_tpu's `train=True` with mutable batch_stats) they normalise by the
batch's statistics and update the running ones with momentum 0.1 and eps
1e-5 — with the BIASED batch variance, as flax's BatchNorm does and as the
steps are held against; torch's own BatchNorm would store the unbiased one
(n / (n - 1) times larger).

  AudioConvNet: mel (b, 128, 204, 1) -> 5-stage 2D CNN
    (1->64 k7 s2) -> [64 s2] -> [128 s2] -> [256 s2] -> [512 s1], each stage
    (conv3x3 no-bias, BN, ReLU) x2; global mean pool -> 512.
  VideoR2Plus1DNet: video (b, f, h, w, 3) -> Conv3d(3,7,7)/(1,2,2) stem +
    maxpool (1,3,3)/(1,2,2), then 4 stages of 2 factored blocks (spatial
    (1,3,3) conv -> BN -> ReLU -> temporal (3,1,1) conv) x2 with residual;
    channels 64 -> 64 -> 128 -> 256 -> 512; global mean pool -> 512.
  SyncHead: concat(audio, video) 1024 -> 512 -> 256 -> 1 logit.

Inputs are channels-last, as in the JAX package; the convolutions run on a
channels-first view.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or x's dtype where that is wider."""
    return torch.promote_types(x.dtype, torch.float32)


class _ChannelMoments(torch.autograd.Function):
    """(2, C): the per-channel sum and sum of squares of x (b, C, ...), in
    fp32 at least.  Saves x itself for the backward, not a wider copy."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        dims = [0] + list(range(2, x.dim()))
        wide = x.to(_stats_dtype(x))
        return torch.stack([wide.sum(dims), wide.square().sum(dims)])

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        shape = [1, -1] + [1] * (x.dim() - 2)
        return (grad[0].view(shape) + 2.0 * x.to(grad.dtype)
                * grad[1].view(shape)).to(x.dtype)


class _BiasedVarianceBatchNorm:
    """Training mode of torch's BatchNorm with flax's running-variance
    update: the batch normalises itself (`F.batch_norm` without running
    buffers), and the running statistics take the batch mean and the biased
    batch variance, both reduced in fp32.

    Across processes the batch is the global one, as flax's `batch_stats`
    are under a batch sharded by the partitioner: the ranks' per-channel
    counts, sums and sums of squares are summed in fp32 (at least) by one
    differentiable all-reduce over `process_group` (None: the default
    group), and both the normalisation and the running statistics use the
    global mean and biased variance.  `nn.SyncBatchNorm` does not serve: it
    refuses CPU tensors and stores the unbiased variance."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if _world_size(self.process_group) > 1:
            return self._global_forward(x)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x.detach().float(), dims, correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(
                mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(
                var.to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        from ...parallel.reduce import all_reduce_sum
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c, dtype=_stats_dtype(x))
        stats = all_reduce_sum(
            torch.cat([_ChannelMoments.apply(x).reshape(-1), count]),
            self.process_group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(
                mean.detach().to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(
                var.detach().to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            scale = scale * self.weight
        shift = -mean * scale
        if self.bias is not None:
            shift = shift + self.bias
        shape = [1, c] + [1] * (x.dim() - 2)
        return (x * scale.view(shape) + shift.view(shape)).to(x.dtype)


def _world_size(group) -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


class BatchNorm2d(_BiasedVarianceBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BiasedVarianceBatchNorm, nn.BatchNorm3d):
    pass


def _conv_bn2d(cin: int, cout: int, kernel: int, stride, padding: int):
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride, padding, bias=False),
        BatchNorm2d(cout))


class Basic2DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int,
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, out_planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(out_planes)
        self.conv2 = nn.Conv2d(out_planes, out_planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class AudioConvNet(nn.Module):
    """mel (b, 128, 204, 1) -> (b, 512)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv_bn2d(1, 64, 7, 2, 3)
        self.block1 = Basic2DBlock(64, 64, (2, 2))
        self.block2 = Basic2DBlock(64, 128, (2, 2))
        self.block3 = Basic2DBlock(128, 256, (2, 2))
        self.block4 = Basic2DBlock(256, 512, (1, 1))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.to(self.conv1[0].weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x))
        x = self.block4(self.block3(self.block2(self.block1(x))))
        return x.mean(dim=(2, 3))


class BasicR2P1DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int,
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        st, sh, sw = stride
        p = out_planes
        self.spt_conv1 = nn.Conv3d(in_planes, p, (1, 3, 3), (1, sh, sw),
                                   (0, 1, 1), bias=False)
        self.spt_bn1 = BatchNorm3d(p)
        self.tmp_conv1 = nn.Conv3d(p, p, (3, 1, 1), (st, 1, 1), (1, 0, 0),
                                   bias=False)
        self.tmp_bn1 = BatchNorm3d(p)
        self.spt_conv2 = nn.Conv3d(p, p, (1, 3, 3), 1, (0, 1, 1), bias=False)
        self.spt_bn2 = BatchNorm3d(p)
        self.tmp_conv2 = nn.Conv3d(p, p, (3, 1, 1), 1, (1, 0, 0), bias=False)
        self.out_bn = BatchNorm3d(p)
        if in_planes != p or any(s != 1 for s in stride):
            self.res_conv = nn.Conv3d(in_planes, p, 1, stride, bias=False)
        else:
            self.res_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.spt_bn1(self.spt_conv1(x))
        y = F.relu(self.tmp_bn1(self.tmp_conv1(F.relu(y))))
        y = self.spt_bn2(self.spt_conv2(y))
        y = self.tmp_conv2(F.relu(y))
        if self.res_conv is not None:
            x = self.res_conv(x)
        return F.relu(self.out_bn(y + x))


class VideoR2Plus1DNet(nn.Module):
    """video (b, f, h, w, 3), CLIP-normalised frames -> (b, 512)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False),
            BatchNorm3d(64))
        cin = 64
        for i, (ch, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                          (512, 2)]):
            setattr(self, f"conv{i + 2}x", nn.Sequential(
                BasicR2P1DBlock(cin, ch, (stride,) * 3),
                BasicR2P1DBlock(ch, ch)))
            cin = ch

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = video.to(self.conv1[0].weight.dtype).permute(0, 4, 1, 2, 3)
        x = F.relu(self.conv1(x))
        # the (1, 3, 3) pool per frame, as a 2D pool over (channel, frame)
        # planes: a free view, and its backward has a fixed summation order
        # where max_pool3d's adds with atomics
        c, t = x.shape[1:3]
        x = F.max_pool2d(x.flatten(1, 2), 3, 2, 1).unflatten(1, (c, t))
        x = self.conv5x(self.conv4x(self.conv3x(self.conv2x(x))))
        return x.mean(dim=(2, 3, 4))


class SyncHead(nn.Module):
    def __init__(self, dim: int = 512, out_dim: int = 1):
        super().__init__()
        # the reference's Sequential holds dropouts at 2 and 5
        self.fc = nn.Sequential(
            nn.Linear(2 * dim, dim), nn.ReLU(), nn.Identity(),
            nn.Linear(dim, dim // 2), nn.ReLU(), nn.Identity(),
            nn.Linear(dim // 2, out_dim))

    def forward(self, audio_emb: torch.Tensor,
                video_emb: torch.Tensor) -> torch.Tensor:
        return self.fc(torch.cat([audio_emb, video_emb], dim=-1))


class AVSyncClassifier(nn.Module):
    """(mel, video) -> scalar sync score per pair."""

    def __init__(self):
        super().__init__()
        self.audio_encoder = AudioConvNet()
        self.video_encoder = VideoR2Plus1DNet()
        self.head = SyncHead()

    def forward(self, mels: torch.Tensor,
                videos: torch.Tensor) -> torch.Tensor:
        return self.score_pairs(*self.encode(mels, videos))

    def encode(self, mels: torch.Tensor, videos: torch.Tensor):
        return self.audio_encoder(mels), self.video_encoder(videos)

    def score_pairs(self, audio_emb: torch.Tensor,
                    video_emb: torch.Tensor) -> torch.Tensor:
        return self.head(audio_emb, video_emb)[:, 0]
