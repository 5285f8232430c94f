"""Layers with flax's `dtype` semantics.

A flax layer built with `dtype=bfloat16` keeps float32 parameters
(`param_dtype`) and computes in bf16:
  * Dense and Conv cast the input, the kernel and the bias to bf16; the
    product (accumulated in fp32, in XLA as in cuBLAS and cuDNN) is
    rounded to bf16, and the bias is added to it in bf16, a second
    rounding that a fused bias epilogue would skip;
  * LayerNorm and BatchNorm take their statistics and normalise in fp32,
    and round the result to bf16.
These subclasses of the torch layers do the same for `compute_dtype`. At
float32 they compute exactly as the plain torch layers do. Parameter
names are torch's, so checkpoints convert as before
(utils/checkpoint.py); gradients reach the fp32 parameters through the
casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _add_bias(y, bias, dtype, channel_dim):
    """flax's bias add: after the product was rounded to `dtype`."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(dtype).reshape(shape)


class Linear(nn.Linear):
    def __init__(self, cin: int, cout: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x.float(), self.weight, self.bias)
        return _add_bias(F.linear(x.to(dt), self.weight.to(dt)), self.bias,
                         dt, -1)


class Conv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 groups: int = 1):
        super().__init__(cin, cout, k, stride, padding=padding, bias=bias,
                         groups=groups)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return self._conv_forward(x.float(), self.weight, self.bias)
        return _add_bias(self._conv_forward(x.to(dt), self.weight.to(dt),
                                            None), self.bias, dt, 1)


class LayerNorm(nn.LayerNorm):
    def __init__(self, d: int, eps: float,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)
