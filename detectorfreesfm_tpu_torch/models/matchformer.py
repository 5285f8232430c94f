"""MatchFormer-class coarse matcher: attention inside the backbone.

Port of `MatchFormerConfig`, `SRAttention` and `MatchFormerMatcher` from
the JAX package's models/matchformer.py. Each stage is a stride-2 conv
patch embed, the sine position encoding, and blocks of self- then
cross-attention between the two images ("extract-and-match"), with the
keys and values average-pooled by the stage's reduction ratio (PVT's
spatially-reduced attention). Dual-softmax matching runs on the last
stage's 1/8 features, dense, as in JAX. Both images of a pair share one
frame size. The two stages of models/loftr.py's PairMatcher, without the
fine stage: the encoder attends across the two images, so there is no
per-image stage, and a view is its frame (FrameViews; `encode_views`
returns the frames as given); `match_views` is the whole network on the
two sides' frames. Through the engine each step's frames come from its
view store instead of being stacked per pair, with the same results.

The queries are chunked by 4096, as in JAX, so a stage-0 logits tensor is
(B, heads, 4096, M), not (B, heads, N, M) (15 GB per attention at 832 px).
Under autograd each chunk is recomputed in the backward pass
(torch.utils.checkpoint, JAX's jax.checkpoint) instead of keeping its
softmax.

`compute_dtype="bfloat16"` is JAX's bf16 path (models/layers.py): embeds,
projections, MLPs and the residual stream in bf16; the attention logits
and softmax in fp32 (JAX's `preferred_element_type=float32`), the softmax
rounded to bf16 before it weights the values; LayerNorm in fp32 rounded
to bf16. The two images run as one batch of 2B (the same weights, row by
row the same products).

Under a torch profiler (utils/profiler.py) the matcher records the spans
`matcher/encoder` (the three stages, patch embeds to the last block),
`matcher/sr_attention` (each SRAttention call's attention core: the K/V
pooling, the q/k/v projections, the chunked logits, softmax and values,
and the output projection; not its post-norms and MLP) and
`matcher/dual_softmax` (the dense confidence and the top-K), with their
device time; and the counter `matchformer/logit_bytes`, the bytes of
fp32 logits the query chunks write (2B x heads x N x M x 4 a call).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import set_backends
from ..utils.profiler import count, span
from .layers import Conv2d, LayerNorm, Linear
from .loftr import MatcherConfig, PairMatcher, dense_match, grid_valid
from .position_encoding import add_position_encoding
from .transformer import LN_EPS

QUERY_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class MatchFormerConfig(MatcherConfig):
    stage_dims: tuple = (64, 128, 256)   # strides 2, 4, 8
    stage_blocks: tuple = (1, 2, 2)      # (self, cross) pairs per stage
    sr_ratios: tuple = (8, 4, 2)         # K/V spatial reduction per stage


class FrameViews(NamedTuple):
    """MatchFormer's views: the frames as staged."""

    frames: torch.Tensor   # (N, H, W, 1) in [0, 1]


def avg_pool(x, r: int):
    """flax's nn.avg_pool of (B, H, W, C) over r x r windows at stride r,
    VALID. In bf16 the window is summed in bf16, one element at a time in
    row-major order, as XLA reduces a bf16 window (a sum in fp32, as
    avg_pool2d's, rounds once and differs)."""
    if x.dtype == torch.float32:
        return F.avg_pool2d(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    b, h, w, c = x.shape
    win = x[:, :h // r * r, :w // r * r].reshape(b, h // r, r, w // r, r, c)
    acc = win[:, :, 0, :, 0]
    for i in range(r):
        for j in range(r):
            if i or j:
                acc = acc + win[:, :, i, :, j]
    return acc / (r * r)


def gelu(x):
    """flax's nn.gelu: the tanh approximation. In bf16 JAX rounds after
    each op of its formula, with the constants in bf16, and so does this;
    in fp32 one F.gelu."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    dt = x.dtype
    c = torch.tensor(float(np.sqrt(2 / np.pi)), dtype=torch.float32).to(dt)
    k = torch.tensor(0.044715, dtype=torch.float32).to(dt)
    inner = c * (x + k * (x * (x * x)))
    return x * (torch.tensor(0.5, dtype=dt) * (1.0 + torch.tanh(inner)))


class SRAttention(nn.Module):
    """Attention with average-pooled keys/values, then flax's post-norm
    block: LayerNorm(x + proj(attn)), then LayerNorm(y + MLP(y)) with
    tanh-approximated GELU (flax's nn.gelu default)."""

    def __init__(self, dim: int, nhead: int, sr_ratio: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.nhead, self.sr_ratio = dim, nhead, sr_ratio
        dt = compute_dtype
        self.q = Linear(dim, dim, bias=False, compute_dtype=dt)
        self.k = Linear(dim, dim, bias=False, compute_dtype=dt)
        self.v = Linear(dim, dim, bias=False, compute_dtype=dt)
        self.proj = Linear(dim, dim, compute_dtype=dt)
        self.ln = LayerNorm(dim, LN_EPS, dt)
        self.mlp1 = Linear(dim, 2 * dim, compute_dtype=dt)
        self.mlp2 = Linear(2 * dim, dim, compute_dtype=dt)
        self.ln2 = LayerNorm(dim, LN_EPS, dt)
        # JAX's 1 / sqrt(head dim), both in float32.
        self.scale = float(np.float32(1.0) / np.sqrt(np.float32(dim // nhead)))

    def forward(self, x, source_map):
        """x: (B, N, C) queries; source_map: (B, H, W, C) keys/values (x's
        own map for self-attention, the other image's for cross)."""
        with span("matcher/sr_attention", x.device):
            msg = self.attention(x, source_map)
        y = self.ln(x + msg)
        h = self.mlp2(gelu(self.mlp1(y)))
        return self.ln2(y + h)

    def attention(self, x, source_map):
        """The attention core: pooled keys and values, the query chunks'
        softmax attention and the output projection, (B, N, C)."""
        b, n, c = x.shape
        hn = self.nhead
        dh = self.dim // hn
        kv = source_map
        if self.sr_ratio > 1:
            kv = avg_pool(kv, self.sr_ratio)
        kv = kv.reshape(b, -1, c)
        q = self.q(x).reshape(b, n, hn, dh).transpose(1, 2)      # B H N D
        k = self.k(kv).reshape(b, -1, hn, dh).permute(0, 2, 3, 1)  # B H D M
        v = self.v(kv).reshape(b, -1, hn, dh).transpose(1, 2)      # B H M D
        dt = v.dtype
        count("matchformer/logit_bytes", b * hn * n * kv.shape[1] * 4)

        def attend(qc, k, v):
            logits = torch.matmul(qc.float(), k.float()) * self.scale
            attn = torch.softmax(logits, dim=-1).to(dt)
            return torch.matmul(attn.float(), v.float()).to(dt)

        outs = []
        for qc in q.split(QUERY_CHUNK, dim=2):
            if torch.is_grad_enabled():
                outs.append(checkpoint(attend, qc, k, v, use_reentrant=False))
            else:
                outs.append(attend(qc, k, v))
        out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, n, self.dim)
        return self.proj(out)


class MatchFormerMatcher(PairMatcher):
    """Extract-and-match hierarchical matcher."""

    def __init__(self, cfg: MatchFormerConfig = MatchFormerConfig()):
        super().__init__()
        set_backends(cfg.compute_dtype)  # as DetectorFreeMatcher
        self.cfg = cfg
        dt, cin = cfg.dtype, 1
        for si, (dims, blocks, sr) in enumerate(zip(
                cfg.stage_dims, cfg.stage_blocks, cfg.sr_ratios)):
            self.add_module(f"embed{si}", Conv2d(cin, dims, 3, 2, padding=1,
                                                 compute_dtype=dt))
            for bi in range(blocks):
                for kind in ("self", "cross"):
                    self.add_module(f"s{si}_b{bi}_{kind}",
                                    SRAttention(dims, cfg.nhead, sr, dt))
            cin = dims

    def encode_views(self, images) -> FrameViews:
        """No per-image stage: (N, H, W, 1) frames are their own views."""
        return FrameViews(images)

    def view_bytes(self, h: int, w: int) -> int:
        """Bytes of one view, the fp32 frame that the engine stages."""
        return h * w * 4

    def match_views(self, view0: FrameViews, view1: FrameViews,
                    valid_hw0=None, valid_hw1=None,
                    return_conf: bool = False):
        """The whole network on the two sides' frames (B each); arguments
        and outputs as PairMatcher.forward's. The two sides run as one
        batch of 2B."""
        image0, image1 = view0.frames, view1.frames
        cfg = self.cfg
        b = image0.shape[0]
        dev = image0.device
        x = torch.cat([image0, image1], dim=0).to(cfg.dtype).permute(
            0, 3, 1, 2)                                   # (2B, 1, H, W)
        with span("matcher/encoder", dev):
            for si, (dims, blocks) in enumerate(zip(cfg.stage_dims,
                                                    cfg.stage_blocks)):
                x = getattr(self, f"embed{si}")(x)
                hs, ws = x.shape[2:]
                # The position encoding feeds each stage's attention, and
                # not the matching features after the last one.
                f = add_position_encoding(x.permute(0, 2, 3, 1)).reshape(
                    2 * b, hs * ws, dims)
                for bi in range(blocks):
                    f = getattr(self, f"s{si}_b{bi}_self")(
                        f, f.reshape(2 * b, hs, ws, dims))
                    other = torch.cat([f[b:], f[:b]], dim=0)
                    f = getattr(self, f"s{si}_b{bi}_cross")(
                        f, other.reshape(2 * b, hs, ws, dims))
                x = f.reshape(2 * b, hs, ws, dims).permute(0, 3, 1, 2)
        h8, w8 = x.shape[2:]
        mask0 = grid_valid(valid_hw0, b, h8, w8, cfg.border, dev)
        mask1 = grid_valid(valid_hw1, b, h8, w8, cfg.border, dev)
        with span("matcher/dual_softmax", dev):
            return dense_match(f[:b], f[b:], mask0, mask1, cfg, w8,
                               return_conf)
