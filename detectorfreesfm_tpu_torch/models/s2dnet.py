"""S2DNet-style VGG hypercolumn backbone of the multiview refiner.

Port of the JAX package's models/s2dnet.py: a VGG16 prefix giving conv1_2
(stride 1, 64-d) and conv3_3 (stride 4, 256-d) maps, each adapted to
`out_dim` by a 1x1 -> gelu -> 5x5 conv pair; the stride-4 map is upsampled
bilinearly to the patch size and the two are summed. NCHW in and out.
`compute_dtype` is flax's `dtype` (models/layers.py): at bf16 every conv,
activation, pool, the upsampling and the sum are bf16.

Parity with flax:
  * `max_pool(padding="SAME")` pads -inf on the right and bottom only when
    the size is even (10 -> 5 at crop 19); `_same_max_pool` pads as flax
    does, where MaxPool2d(padding=1) would pad both sides.
  * flax's `nn.gelu` is the tanh approximation.
  * `jax.image.resize(..., "bilinear")` upsampling is half-pixel bilinear
    with edge weights renormalized, which is `F.interpolate(
    mode="bilinear", align_corners=False)` (tests/test_torch_refine.py
    holds them equal at crops 19, 15 and 11).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


def _same_max_pool(x, k: int = 3, s: int = 2):
    """Flax max_pool with padding="SAME": output ceil(n / s), the padding
    split with the extra element at the end."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: last dim first
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), k, s)


class S2DNet(nn.Module):
    """Patch hypercolumn features: (N, 1, P, P) -> (N, out_dim, P, P)."""

    def __init__(self, out_dim: int = 128,
                 vgg_dims1: Sequence[int] = (64, 64),
                 vgg_dims2: Sequence[int] = (128, 128),
                 vgg_dims3: Sequence[int] = (256, 256, 256),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()

        def conv(cin, cout, k):
            return Conv2d(cin, cout, k, padding=k // 2,
                          compute_dtype=compute_dtype)

        self.conv1_1 = conv(1, vgg_dims1[0], 3)
        self.conv1_2 = conv(vgg_dims1[0], vgg_dims1[1], 3)
        self.conv2_1 = conv(vgg_dims1[1], vgg_dims2[0], 3)
        self.conv2_2 = conv(vgg_dims2[0], vgg_dims2[1], 3)
        self.conv3_1 = conv(vgg_dims2[1], vgg_dims3[0], 3)
        self.conv3_2 = conv(vgg_dims3[0], vgg_dims3[1], 3)
        self.conv3_3 = conv(vgg_dims3[1], vgg_dims3[2], 3)
        self.adap1_1x1 = conv(vgg_dims1[1], out_dim, 1)
        self.adap1_5x5 = conv(out_dim, out_dim, 5)
        self.adap3_1x1 = conv(vgg_dims3[2], out_dim, 1)
        self.adap3_5x5 = conv(out_dim, out_dim, 5)

    def forward(self, x):
        h, w = x.shape[-2:]
        y = F.relu(self.conv1_1(x))
        y = F.relu(self.conv1_2(y))
        hyper1 = y
        y = _same_max_pool(y)
        y = F.relu(self.conv2_1(y))
        y = F.relu(self.conv2_2(y))
        y = _same_max_pool(y)
        y = F.relu(self.conv3_1(y))
        y = F.relu(self.conv3_2(y))
        hyper3 = F.relu(self.conv3_3(y))

        a1 = self.adap1_5x5(F.gelu(self.adap1_1x1(hyper1), approximate="tanh"))
        a3 = self.adap3_5x5(F.gelu(self.adap3_1x1(hyper3), approximate="tanh"))
        a3 = F.interpolate(a3, size=(h, w), mode="bilinear",
                           align_corners=False, antialias=False)
        return a1 + a3
