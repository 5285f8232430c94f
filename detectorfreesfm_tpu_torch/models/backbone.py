"""ResNet-FPN 8/2 backbone (NCHW inside).

Port of `ResNetFPN_8_2` and `BasicBlock` from the JAX package's
models/backbone.py: a BasicBlock ResNet trunk at strides 2/4/8 and an FPN
top-down path back to 1/2. All convolutions are bias-free and followed by
eval-mode BatchNorm (eps 1e-5, as flax and torch share). Submodule names
follow the flax parameter tree so checkpoints convert by name
(utils/checkpoint.py).

Outputs: coarse (B, 256, H/8, W/8) and fine (B, 128, H/2, W/2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm2d holding exactly flax's four tensors.

    The JAX trainers differentiate with respect to the whole variables
    tree, so with `use_running_average` the running statistics get
    gradients and the optimizer moves them. A trainer that sets
    `requires_grad` on the statistics gets flax's formula, through which
    autograd reaches them (F.batch_norm's does not)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.running_mean.requires_grad or self.running_var.requires_grad:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None])
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1):
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.has_downsample = stride != 1 or cin != planes
        if self.has_downsample:
            self.downsample_conv = _conv(cin, planes, 1, stride)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + y)


def _upsample2(x):
    """Nearest-neighbour x2, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResNetFPN_8_2(nn.Module):
    """Coarse 1/8 (256-d) + fine 1/2 (128-d) feature pyramid."""

    def __init__(self, initial_dim: int = 128, block_dims=(128, 196, 256)):
        super().__init__()
        bd = block_dims
        self.conv1 = nn.Conv2d(1, initial_dim, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(initial_dim)
        self.layer1_0 = BasicBlock(initial_dim, bd[0], 1)
        self.layer1_1 = BasicBlock(bd[0], bd[0], 1)
        self.layer2_0 = BasicBlock(bd[0], bd[1], 2)
        self.layer2_1 = BasicBlock(bd[1], bd[1], 1)
        self.layer3_0 = BasicBlock(bd[1], bd[2], 2)
        self.layer3_1 = BasicBlock(bd[2], bd[2], 1)
        self.layer3_out = _conv(bd[2], bd[2], 1)
        self.layer2_lateral = _conv(bd[1], bd[2], 1)
        self.layer2_smooth1 = _conv(bd[2], bd[1], 3)
        self.layer2_smooth_bn = BatchNorm(bd[1])
        self.layer2_smooth2 = _conv(bd[1], bd[1], 3)
        self.layer1_lateral = _conv(bd[0], bd[1], 1)
        self.layer1_smooth1 = _conv(bd[1], bd[1], 3)
        self.layer1_smooth_bn = BatchNorm(bd[1])
        self.layer1_smooth2 = _conv(bd[1], bd[0], 3)

    def forward(self, x):
        """x: (B, 1, H, W) grayscale in [0, 1]."""
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1_1(self.layer1_0(x))         # 1/2
        x2 = self.layer2_1(self.layer2_0(x1))        # 1/4
        x3 = self.layer3_1(self.layer3_0(x2))        # 1/8
        c3 = self.layer3_out(x3)                     # coarse out
        y2 = self.layer2_lateral(x2) + _upsample2(c3)
        y2 = F.relu(self.layer2_smooth_bn(self.layer2_smooth1(y2)))
        y2 = self.layer2_smooth2(y2)                 # 1/4
        y1 = self.layer1_lateral(x1) + _upsample2(y2)
        y1 = F.relu(self.layer1_smooth_bn(self.layer1_smooth1(y1)))
        fine = self.layer1_smooth2(y1)               # 1/2
        return c3, fine
