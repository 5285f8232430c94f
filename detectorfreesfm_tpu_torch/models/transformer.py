"""Matching transformer blocks.

Port of `EncoderLayer` and `LocalFeatureTransformer` from the JAX package's
models/transformer.py: bias-free QKV projections, linear (elu+1) or masked
full attention, a merge projection, LayerNorm over the concatenation, a
concat-MLP feed-forward and a residual add. Flax's LayerNorm epsilon is
1e-6 (torch's default is 1e-5), and it is kept. `compute_dtype` is flax's
`dtype` (models/layers.py): at bf16 the projections, the MLP, the relu
and the residual stream are bf16, LayerNorm runs in fp32 rounded to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import full_attention, linear_attention
from .layers import LayerNorm, Linear

LN_EPS = 1e-6


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, attention: str = "linear",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.attn = (linear_attention if attention == "linear"
                     else full_attention)
        d, dt = d_model, compute_dtype
        self.q_proj = Linear(d, d, bias=False, compute_dtype=dt)
        self.k_proj = Linear(d, d, bias=False, compute_dtype=dt)
        self.v_proj = Linear(d, d, bias=False, compute_dtype=dt)
        self.merge = Linear(d, d, compute_dtype=dt)
        self.norm1 = LayerNorm(2 * d, LN_EPS, dt)
        self.mlp1 = Linear(2 * d, 2 * d, compute_dtype=dt)
        self.mlp2 = Linear(2 * d, d, compute_dtype=dt)
        self.norm2 = LayerNorm(d, LN_EPS, dt)

    def forward(self, x, source, x_mask=None, source_mask=None):
        """x: (B, L, C) queries; source: (B, S, C) keys/values."""
        b, l, d = x.shape
        s = source.shape[1]
        h = self.nhead
        q = self.q_proj(x).reshape(b, l, h, d // h)
        k = self.k_proj(source).reshape(b, s, h, d // h)
        v = self.v_proj(source).reshape(b, s, h, d // h)
        msg = self.attn(q, k, v, q_mask=x_mask, kv_mask=source_mask)
        return self.update(x, msg.reshape(b, l, d))

    def update(self, x, msg):
        """The merge projection, LayerNorm over [x, msg], the concat-MLP
        and the residual add, on the attention's (B, L, C) message."""
        msg = self.norm1(torch.cat([x, self.merge(msg)], dim=-1))
        msg = self.mlp2(F.relu(self.mlp1(msg)))
        return x + self.norm2(msg)


class LocalFeatureTransformer(nn.Module):
    """Alternating self/cross attention over two feature sets."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 layer_names=("self", "cross") * 4, attention: str = "linear",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kinds = tuple(layer_names)
        for i, kind in enumerate(self.kinds):
            self.add_module(f"layer_{i}_{kind}", EncoderLayer(
                d_model, nhead, attention, compute_dtype))

    def forward(self, feat0, feat1, mask0=None, mask1=None):
        """feat0 (B, L, C), feat1 (B, S, C) -> transformed (feat0, feat1)."""
        for i, kind in enumerate(self.kinds):
            layer = getattr(self, f"layer_{i}_{kind}")
            if kind == "self":
                feat0 = layer(feat0, feat0, mask0, mask0)
                feat1 = layer(feat1, feat1, mask1, mask1)
            else:
                feat0, feat1 = (layer(feat0, feat1, mask0, mask1),
                                layer(feat1, feat0, mask1, mask0))
        return feat0, feat1
