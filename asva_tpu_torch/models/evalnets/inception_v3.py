"""InceptionV3 with the FID-specific block variants: the FID feature net.

Port of asva_tpu/models/evalnets/inception_v3.py, in the pytorch-fid /
torchvision key space (`inception_v3_key_map`: BasicConv2d children `conv`
+ `bn`).  BasicConv2d = conv (no bias) + BN (eps 1e-3) + relu; InceptionA/C
and the first InceptionE pool with a 3x3 average that does not count the
padding (`count_include_pad=False`, JAX `_avg_pool_nocount` :34); the last
InceptionE pools with a max.  Input (b, 229, 229, 3) in [-1, 1],
channels-last; output the 2048-d pool3 features.  Inference only.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nocount(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x),
                          self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avg_pool_nocount(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)],
                         dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        k17, p17, k71, p71 = (1, 7), (0, 3), (7, 1), (3, 0)
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, k17, padding=p17)
        self.branch7x7_3 = BasicConv2d(c7, 192, k71, padding=p71)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, k71, padding=p71)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, k17, padding=p17)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, k71, padding=p71)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, k17, padding=p17)
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_2(self.branch7x7dbl_1(x))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(bd)))
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_nocount(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_2(self.branch7x7x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(b7))
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool   # the final FID block
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = (F.max_pool2d(x, 3, 1, 1) if self.use_max_pool
              else _avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         dim=1)


class InceptionV3FID(nn.Module):
    """images (b, h, w, 3) in [-1, 1] -> (b, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, False)
        self.Mixed_7c = InceptionE(2048, True)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.Conv2d_1a_3x3.conv.weight.dtype).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))
