"""ResNet-FPN backbones (NCHW inside).

Port of `ResNetFPN_8_2`, `BasicBlock`, `ResNetFPN` and `build_resnetfpn`
from the JAX package's models/backbone.py: a BasicBlock ResNet trunk at
strides 2/4/8 and an FPN top-down path back to 1/2, and the generic
variant that covers the reference's other stride ladders. All
convolutions are bias-free and followed by eval-mode BatchNorm (eps 1e-5,
as flax and torch share). Submodule names follow the flax parameter tree
so checkpoints convert by name (utils/checkpoint.py). `compute_dtype` is
flax's `dtype` (models/layers.py): at bf16 the convolutions, relus,
residual adds and the FPN's upsample-and-add run in bf16, BatchNorm in
fp32 rounded to bf16.

ResNetFPN_8_2's outputs: coarse (B, 256, H/8, W/8) and fine (B, 128, H/2,
W/2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm2d holding exactly flax's four tensors.

    The JAX trainers differentiate with respect to the whole variables
    tree, so with `use_running_average` the running statistics get
    gradients and the optimizer moves them. A trainer that sets
    `requires_grad` on the statistics gets flax's formula, through which
    autograd reaches them (F.batch_norm's does not).

    Both branches normalise in fp32 and return `compute_dtype`, as flax's
    BatchNorm(dtype=...) does; F.batch_norm takes a bf16 input with fp32
    statistics and computes in fp32."""

    def __init__(self, c: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        dt = self.compute_dtype
        if self.running_mean.requires_grad or self.running_var.requires_grad:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x.float() - self.running_mean[:, None, None])
                    * mul[:, None, None] + self.bias[:, None, None]).to(dt)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0,
                            self.eps).to(dt)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dtype: torch.dtype = torch.float32):
    return Conv2d(cin, cout, k, stride, padding=k // 2, bias=False,
                  compute_dtype=dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.conv1 = _conv(cin, planes, 3, stride, dt)
        self.bn1 = BatchNorm(planes, compute_dtype=dt)
        self.conv2 = _conv(planes, planes, 3, dtype=dt)
        self.bn2 = BatchNorm(planes, compute_dtype=dt)
        self.has_downsample = stride != 1 or cin != planes
        if self.has_downsample:
            self.downsample_conv = _conv(cin, planes, 1, stride, dt)
            self.downsample_bn = BatchNorm(planes, compute_dtype=dt)

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

    def __init__(self, initial_dim: int = 128, block_dims=(128, 196, 256),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        bd, dt = block_dims, compute_dtype
        self.conv1 = Conv2d(1, initial_dim, 7, 2, padding=3, bias=False,
                            compute_dtype=dt)
        self.bn1 = BatchNorm(initial_dim, compute_dtype=dt)
        self.layer1_0 = BasicBlock(initial_dim, bd[0], 1, dt)
        self.layer1_1 = BasicBlock(bd[0], bd[0], 1, dt)
        self.layer2_0 = BasicBlock(bd[0], bd[1], 2, dt)
        self.layer2_1 = BasicBlock(bd[1], bd[1], 1, dt)
        self.layer3_0 = BasicBlock(bd[1], bd[2], 2, dt)
        self.layer3_1 = BasicBlock(bd[2], bd[2], 1, dt)
        self.layer3_out = _conv(bd[2], bd[2], 1, dtype=dt)
        self.layer2_lateral = _conv(bd[1], bd[2], 1, dtype=dt)
        self.layer2_smooth1 = _conv(bd[2], bd[1], 3, dtype=dt)
        self.layer2_smooth_bn = BatchNorm(bd[1], compute_dtype=dt)
        self.layer2_smooth2 = _conv(bd[1], bd[1], 3, dtype=dt)
        self.layer1_lateral = _conv(bd[0], bd[1], 1, dtype=dt)
        self.layer1_smooth1 = _conv(bd[1], bd[1], 3, dtype=dt)
        self.layer1_smooth_bn = BatchNorm(bd[1], compute_dtype=dt)
        self.layer1_smooth2 = _conv(bd[1], bd[0], 3, dtype=dt)

    def forward(self, x, fine: bool = True):
        """x: (B, 1, H, W) grayscale in [0, 1]. With fine=False the FPN
        path is skipped and fine is None (the coarse-only matchers; XLA
        drops the unused branch the same way)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1_1(self.layer1_0(x))         # 1/2
        x2 = self.layer2_1(self.layer2_0(x1))        # 1/4
        x3 = self.layer3_1(self.layer3_0(x2))        # 1/8
        c3 = self.layer3_out(x3)                     # coarse out
        if not fine:
            return c3, None
        y2 = self.layer2_lateral(x2) + _upsample2(c3)
        y2 = F.relu(self.layer2_smooth_bn(self.layer2_smooth1(y2)))
        y2 = self.layer2_smooth2(y2)                 # 1/4
        y1 = self.layer1_lateral(x1) + _upsample2(y2)
        y1 = F.relu(self.layer1_smooth_bn(self.layer1_smooth1(y1)))
        fine = self.layer1_smooth2(y1)               # 1/2
        return c3, fine


class ResNetFPN(nn.Module):
    """The reference's other stride variants as one module (JAX's
    `ResNetFPN`): `stage_strides` fixes the trunk, `fine_stage` how far the
    top-down path descends. Returns (coarse, fine): the deepest stage after
    a 1x1 out conv, and the FPN output at stage `fine_stage`."""

    def __init__(self, stage_strides=(1, 2, 2), block_dims=(128, 196, 256),
                 initial_dim: int = 128, first_kernel: int = 7,
                 first_stride: int = 1, fine_stage: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        bd, dt, k = list(block_dims), compute_dtype, first_kernel
        self.n_stages, self.fine_stage = len(bd), fine_stage
        self.conv1 = Conv2d(1, initial_dim, k, first_stride,
                            padding=k // 2, bias=False, compute_dtype=dt)
        self.bn1 = BatchNorm(initial_dim, compute_dtype=dt)
        cin = initial_dim
        for i, (d, st) in enumerate(zip(bd, stage_strides)):
            self.add_module(f"layer{i + 1}_0", BasicBlock(cin, d, st, dt))
            self.add_module(f"layer{i + 1}_1", BasicBlock(d, d, 1, dt))
            cin = d
        self.add_module(f"layer{len(bd)}_out", _conv(bd[-1], bd[-1], 1,
                                                     dtype=dt))
        for i in range(len(bd) - 2, fine_stage - 1, -1):
            self.add_module(f"layer{i + 1}_lateral",
                            _conv(bd[i], bd[i + 1], 1, dtype=dt))
            self.add_module(f"layer{i + 1}_smooth1",
                            _conv(bd[i + 1], bd[i + 1], 3, dtype=dt))
            self.add_module(f"layer{i + 1}_smooth_bn",
                            BatchNorm(bd[i + 1], compute_dtype=dt))
            self.add_module(f"layer{i + 1}_smooth2",
                            _conv(bd[i + 1], bd[i], 3, dtype=dt))

    def forward(self, x):
        """x: (B, 1, H, W) grayscale in [0, 1]."""
        layer = lambda name: getattr(self, name)  # noqa: E731
        x = F.relu(self.bn1(self.conv1(x)))
        feats = []
        for i in range(self.n_stages):
            x = layer(f"layer{i + 1}_1")(layer(f"layer{i + 1}_0")(x))
            feats.append(x)
        coarse = layer(f"layer{self.n_stages}_out")(feats[-1])
        y = coarse
        for i in range(self.n_stages - 2, self.fine_stage - 1, -1):
            y = layer(f"layer{i + 1}_lateral")(feats[i]) + _upsample2(y)
            y = F.relu(layer(f"layer{i + 1}_smooth_bn")(
                layer(f"layer{i + 1}_smooth1")(y)))
            y = layer(f"layer{i + 1}_smooth2")(y)
        return coarse, y


# The reference's variant table (name -> constructor kwargs), a copy of the
# JAX package's: coarse at prod(first_stride, stage_strides), fine at the
# `fine_stage` level.
_FPN_VARIANTS = {
    # conv1 7x7/s1, 4 stages -> coarse 1/8, fine 1/1
    "8_1": dict(first_kernel=7, first_stride=1, stage_strides=(1, 2, 2, 2),
                block_dims=(64, 96, 128, 196), initial_dim=64, fine_stage=0),
    # conv1 7x7/s1, 3 stages -> coarse 1/4, fine 1/1
    "4_1": dict(first_kernel=7, first_stride=1, stage_strides=(1, 2, 2),
                block_dims=(64, 96, 128), initial_dim=64, fine_stage=0),
    # conv1 3x3/s1, 2 stages -> coarse 1/2, fine 1/1
    "2_1": dict(first_kernel=3, first_stride=1, stage_strides=(1, 2),
                block_dims=(64, 96), initial_dim=64, fine_stage=0),
    # conv1 7x7/s2, 4 stages -> coarse 1/16, fine 1/4
    "16_4": dict(first_kernel=7, first_stride=2, stage_strides=(1, 2, 2, 2),
                 block_dims=(128, 196, 256, 384), initial_dim=128,
                 fine_stage=1),
}


def build_resnetfpn(variant: str,
                    compute_dtype: torch.dtype = torch.float32,
                    **overrides):
    """Any reference ResNetFPN variant by name ('8_2', '8_1', '4_1',
    '2_1', '16_4'); another name raises ValueError."""
    if variant == "8_2":
        return ResNetFPN_8_2(compute_dtype=compute_dtype, **overrides)
    if variant not in _FPN_VARIANTS:
        raise ValueError(f"unknown ResNetFPN variant {variant!r}; "
                         f"choose from ['8_2', {sorted(_FPN_VARIANTS)}]")
    kw = dict(_FPN_VARIANTS[variant])
    kw.update(overrides)
    return ResNetFPN(compute_dtype=compute_dtype, **kw)
