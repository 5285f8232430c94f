"""EfficientLoFTR: semi-dense matching with aggregated attention.

Wang, He, Peng, Tan, Zhou, "Efficient LoFTR: Semi-Dense Local Feature
Matching with Sparse-Like Speed", CVPR 2024
(https://github.com/zju3dv/EfficientLoFTR, weights published as
https://huggingface.co/zju-community/efficientloftr). The equations are
those of transformers' models/efficientloftr/modeling_efficientloftr.py
(4.57.6), at the published widths:

  * per image, RepVGG: stages of [1, 2, 4, 14] blocks, widths [64, 64,
    128, 256], strides [2, 1, 2, 2]; a block is ReLU(BN(conv3x3) +
    BN(conv1x1) [+ BN(x) where the shapes allow]), the three branches
    summed as published (not folded into one conv). Its views are the
    1/8 (256), 1/4 (128) and 1/2 (64 channels) maps (EfficientLoFTRViews);
  * per pair, 4 layers of (self, cross) aggregated attention at d = 256,
    8 heads of 32: queries aggregated by a depthwise 4x4 stride-4 conv,
    keys and values by a 4x4 max-pool of the source map, one shared
    LayerNorm, q/k/v projections without bias, in self-attention alone a
    2-D rotary embedding over all 256 channels (theta 10 000, the
    aggregated grid's (row, column) positions from 1, interleaved), full
    softmax attention, the output projection, bilinear x4 back to the 1/8
    grid, an MLP on concat(x, message) (512 -> 512, leaky ReLU, 512 ->
    256, LayerNorm) and a residual add. Cross-attention is sequential, as
    in the original: image 1 attends to image 0's updated features;
  * the dual-softmax and mutual nearest neighbours (models/loftr.py's
    building blocks, over grid_valid's cells: the padding and the border
    take part in neither softmax);
  * the fine fusion: the coarse features over sqrt(256), a 1x1 conv and
    bilinear x2, then two blocks (a 1x1 conv of the backbone's 1/4, then
    1/2, map added in, a 3x3 conv, BN, leaky ReLU, a 3x3 conv, bilinear
    x2) to a full-resolution 64-channel map of both frames, and its 8x8
    window in image 0 and 10x10 window (padding 1) in image 1 at each of
    the K top-K slots;
  * the two-stage fine matching at those slots: a dual-softmax of the
    first 56 channels (each side over sqrt(56)) between the two windows,
    its argmax over the 64 x 64 inner cells moving both keypoints to
    their cells (offsets cell - 3.5 px); then the last 8 channels (image
    1's over sqrt(8)) at image 0's cell against the 3x3 of image 1's
    window at padded rows and columns (cell - 1 .. cell + 1) modulo 10, as
    transformers indexes them, a softmax at temperature 10 and its
    expectation over [-1, 1] moving image 1's keypoint.

Where transformers 4.57.6 departs from the original, this follows the
original: its first fine stage gathers each match's offset along the
match axis, which hands every match the window corner's (-3.5, -3.5), and
its forward pairs the windows of image 0's n-th row with image 1's n-th
row, which are different matches unless the cells agree. Here a match
(i, j) takes image 0's window at i, image 1's at j and the offsets of its
own argmax. The fine stage runs at the K slots of the top-K (valid or
not), where transformers refines every cell; its value at a match is the
same. It is part of the model: MatcherConfig's `fine_enabled` (the LoFTR
family's --match-type) does not apply.

Frames are multiples of 32 pixels a side (the 1/8 grid aggregated by 4).
The aggregated attention runs unmasked over the padded frame, as
transformers' does (the original masks the padding through max-pooled
masks). The family is checked against transformers alone: the original's
fine_matching.py and transformer.py are not in the repository, so the
second stage's index and the unmasked padding are unverified against the
published model. The model runs in float32 alone: `compute_dtype=
"bfloat16"` raises. The attention core is ops/sr_attention.py's: the
kernel of csrc/sr_attention.cu on the card in fp32 without autograd, the
plain chain on the CPU and under autograd.

Under a torch profiler (utils/profiler.py) the matcher records the spans
`matcher/repvgg` (the backbone, per batch of views),
`matcher/aggregated_attention` (each module call, from aggregation to the
residual add), `matcher/dual_softmax`, `matcher/fine_fusion` (the pyramid
and the window gather) and `matcher/fine` (the two stages), with their
device time; and the counters `eloftr/attn_queries` (aggregated queries
x frames a call) and `eloftr/attn_fused` (those the kernel computed).

`from_published` maps a state_dict under transformers' names
(`EfficientLoFTRForKeypointMatching`) onto this module's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import set_backends
from ..ops import sr_attention as sr_ops
from ..ops.dual_softmax import dual_softmax_confidence, extract_topk_matches
from ..utils.profiler import count, span
from .backbone import BatchNorm
from .layers import Conv2d, LayerNorm, Linear
from .loftr import (MatcherConfig, MatchOutput, PairMatcher, cells_to_xy,
                    grid_valid)

LN_EPS = 1e-5   # torch's LayerNorm default, as transformers builds them


@dataclasses.dataclass(frozen=True)
class EfficientLoFTRConfig(MatcherConfig):
    stage_blocks: tuple = (1, 2, 4, 14)
    stage_dims: tuple = (64, 64, 128, 256)
    stage_strides: tuple = (2, 1, 2, 2)
    q_aggregation: int = 4     # depthwise conv, kernel = stride
    kv_aggregation: int = 4    # max-pool, kernel = stride
    rope_theta: float = 10000.0
    d_mlp: int = 512           # the MLP on concat(x, message)
    fine_kernel: int = 8       # image 0's window; image 1's is 2 wider
    fine_slice: int = 8        # channels of the second fine stage
    fine_temperature: float = 10.0


class EfficientLoFTRViews(NamedTuple):
    """RepVGG's maps of N views, NCHW."""

    coarse: torch.Tensor   # (N, 256, H/8, W/8)
    quarter: torch.Tensor  # (N, 128, H/4, W/4)
    half: torch.Tensor     # (N, 64, H/2, W/2)


class ConvNorm(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        return self.norm(self.conv(x))


class RepVGGBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = ConvNorm(cin, cout, 3, stride)
        self.conv2 = ConvNorm(cin, cout, 1, stride)
        self.identity = (BatchNorm(cin) if cin == cout and stride == 1
                         else None)

    def forward(self, x):
        y = self.conv1(x) + self.conv2(x)
        if self.identity is not None:
            y = y + self.identity(x)
        return F.relu(y)


class RepVGG(nn.Module):
    def __init__(self, cfg: EfficientLoFTRConfig):
        super().__init__()
        self.stages = nn.ModuleList()
        cin = 1
        for blocks, cout, stride in zip(cfg.stage_blocks, cfg.stage_dims,
                                        cfg.stage_strides):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                RepVGGBlock(cin if b == 0 else cout, cout,
                            stride if b == 0 else 1) for b in range(blocks))
            self.stages.append(stage)
            cin = cout

    def forward(self, x):
        """(N, 1, H, W) -> the last three stages' maps, finest last."""
        outs = []
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
            outs.append(x)
        return outs[:0:-1]


def rope_tables(h: int, w: int, d: int, theta: float, device):
    """(cos, sin), each (h * w, d): channel c of cell (r, q) turns by
    pos * theta^(-(c // 4) / (d / 4)), pos = r + 1 where c // 2 is even
    and q + 1 where it is odd (transformers' compute_embeddings with its
    partial_rotary_factor of 4)."""
    inv = 1.0 / (theta ** (torch.arange(0, d // 2, 2, dtype=torch.int64)
                           .to(device=device, dtype=torch.float) / (d // 2)))
    emb = torch.zeros(h, w, d // 2, device=device)
    emb[..., 0::2] = torch.arange(1, h + 1, device=device,
                                  dtype=torch.float)[:, None, None] * inv
    emb[..., 1::2] = torch.arange(1, w + 1, device=device,
                                  dtype=torch.float)[None, :, None] * inv
    emb = emb.reshape(h * w, d // 2).repeat_interleave(2, dim=-1)
    return emb.cos(), emb.sin()


def rotate(x, rope):
    """x * cos + rotate_half(x) * sin, channel pairs (2t, 2t + 1)."""
    cos, sin = rope
    half = torch.stack([-x[..., 1::2], x[..., 0::2]], -1).flatten(-2)
    return x * cos + half * sin


class AggregatedAttention(nn.Module):
    """One aggregated-attention module of the coarse transformer."""

    def __init__(self, cfg: EfficientLoFTRConfig):
        super().__init__()
        d = cfg.d_coarse
        self.nhead, self.qa, self.kva = (cfg.nhead, cfg.q_aggregation,
                                         cfg.kv_aggregation)
        self.scale = (d // cfg.nhead) ** -0.5
        self.aggregation = nn.ModuleDict({
            "q_aggregation": Conv2d(d, d, self.qa, self.qa, bias=False,
                                    groups=d),
            "norm": LayerNorm(d, LN_EPS)})
        self.attention = nn.ModuleDict(
            {n: Linear(d, d, bias=False)
             for n in ("q_proj", "k_proj", "v_proj", "o_proj")})
        self.mlp = nn.ModuleDict({
            "fc1": Linear(2 * d, cfg.d_mlp, bias=False),
            "fc2": Linear(cfg.d_mlp, d, bias=False),
            "layer_norm": LayerNorm(d, LN_EPS)})

    def forward(self, x, source, rope=None):
        """x, source: (B, C, H, W) 1/8 maps; rope: the aggregated grid's
        (cos, sin) in self-attention, None in cross-attention."""
        with span("matcher/aggregated_attention", x.device):
            agg, att, mlp = self.aggregation, self.attention, self.mlp
            q = agg["q_aggregation"](x)
            kv = F.max_pool2d(source, self.kva, self.kva)
            b, c, h, w = q.shape
            q = agg["norm"](q.permute(0, 2, 3, 1).reshape(b, h * w, c))
            kv = agg["norm"](kv.permute(0, 2, 3, 1).reshape(b, -1, c))
            q, k, v = att["q_proj"](q), att["k_proj"](kv), att["v_proj"](kv)
            if rope is not None:
                q, k = rotate(q, rope), rotate(k, rope)
            msg = att["o_proj"](self.attend(q, k, v))
            msg = F.interpolate(msg.transpose(1, 2).reshape(b, c, h, w),
                                scale_factor=self.qa, mode="bilinear",
                                align_corners=False)
            y = torch.cat([x, msg], 1).permute(0, 2, 3, 1)
            y = mlp["layer_norm"](mlp["fc2"](F.leaky_relu(mlp["fc1"](y))))
            return x + y.permute(0, 3, 1, 2)

    def attend(self, q, k, v):
        """softmax(q.k / sqrt(32)) v per head: the kernel of
        ops/sr_attention.py in fp32 without autograd, else its chain."""
        b, n, _ = q.shape
        if not torch.is_grad_enabled():
            before = sr_ops.launches["sr_attention"]
            out = sr_ops.sr_attention(q, k, v, self.nhead, self.scale)
            fused = sr_ops.launches["sr_attention"] - before
        else:
            out = sr_ops.sr_attention_plain(q, k, v, self.nhead, self.scale)
            fused = 0
        count("eloftr/attn_queries", b * n)
        count("eloftr/attn_fused", b * n * fused)
        return out


class FineFusion(nn.Module):
    """The coarse features and the backbone's 1/4 and 1/2 maps fused to
    a full-resolution map."""

    def __init__(self, cfg: EfficientLoFTRConfig):
        super().__init__()
        dims = list(cfg.stage_dims[:0:-1])       # 256, 128, 64
        self.out_conv = Conv2d(dims[0], dims[0], 1, bias=False)
        self.out_conv_layers = nn.ModuleList(
            nn.ModuleDict({
                "out_conv1": Conv2d(cout, cin, 1, bias=False),
                "out_conv2": Conv2d(cin, cin, 3, padding=1, bias=False),
                "batch_norm": BatchNorm(cin),
                "out_conv3": Conv2d(cin, cout, 3, padding=1, bias=False)})
            for cin, cout in zip(dims, dims[1:]))

    def forward(self, coarse, residuals):
        """coarse (N, 256, H/8, W/8) already scaled; residuals the 1/4
        and 1/2 maps -> (N, 64, H, W)."""
        def up(t):
            return F.interpolate(t, scale_factor=2.0, mode="bilinear",
                                 align_corners=False)

        x = up(self.out_conv(coarse))
        for blk, r in zip(self.out_conv_layers, residuals):
            y = blk["out_conv1"](r) + x
            y = F.leaky_relu(blk["batch_norm"](blk["out_conv2"](y)))
            x = up(blk["out_conv3"](y))
        return x


def windows(fmap, idx, w8: int, size: int, offset: int):
    """(B * K, size * size, C) windows of fmap (B, C, H, W) at rows and
    columns 8 x cell + offset onwards, for the (B, K) cells `idx`; zero
    outside the map."""
    b, c, h, w = fmap.shape
    ar = torch.arange(size, device=fmap.device) + offset
    idx = idx.long()
    yy = (idx // w8 * 8)[..., None, None] + ar[:, None]
    xx = (idx % w8 * 8)[..., None, None] + ar[None, :]
    inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
    bi = torch.arange(b, device=fmap.device)[:, None, None, None]
    out = fmap[bi, :, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
    out = torch.where(inside, out, torch.zeros((), device=fmap.device))
    return out.reshape(-1, size * size, c)


class FineMatching(nn.Module):
    """The two-stage fine matching at K slots: no parameters, a module so
    that hooks see its cells and keypoints."""

    def __init__(self, cfg: EfficientLoFTRConfig):
        super().__init__()
        self.win, self.slice, self.temp = (cfg.fine_kernel, cfg.fine_slice,
                                           cfg.fine_temperature)

    def forward(self, win0, win1, xy0, xy1):
        """win0 (M, W*W, C), win1 (M, (W+2)^2, C) at M = B * K slots;
        xy0, xy1 (B, K, 2) the cells' corners -> both keypoints (B, K,
        2) in full-res px."""
        W, s = self.win, self.slice
        m, _, c = win0.shape
        d1 = c - s
        dev = win0.device
        sim = (win0[..., :d1] / d1 ** 0.5) @ (
            win1[..., :d1] / d1 ** 0.5).transpose(1, 2)
        conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
        conf = conf.reshape(m, W * W, W + 2, W + 2)[..., 1:-1, 1:-1]
        best = conf.reshape(m, (W * W) ** 2).argmax(1)
        i0, i1 = best // (W * W), best % (W * W)

        def offset(i):
            return torch.stack([i % W, i // W], -1).float() - (W // 2 - 0.5)

        kp0 = xy0 + offset(i0).reshape(xy0.shape)
        kp1 = xy1 + offset(i1).reshape(xy1.shape)
        rows = torch.arange(m, device=dev)
        f0 = win0[rows, i0, d1:]                                  # (M, s)
        d = torch.arange(-1, 2, device=dev)
        r = (i1 // W)[:, None, None] + d[:, None]
        q = (i1 % W)[:, None, None] + d[None, :]
        pos = (r % (W + 2)) * (W + 2) + q % (W + 2)               # (M, 3, 3)
        f1 = win1[rows[:, None], pos.reshape(m, 9), d1:] / s ** 0.5
        heat = torch.softmax((f1 @ f0[:, :, None])[..., 0] / self.temp, -1)
        grid = torch.linspace(-1.0, 1.0, 3, device=dev)
        heat = heat.reshape(m, 3, 3)
        ex = (heat * grid[None, :]).sum((1, 2))
        ey = (heat * grid[:, None]).sum((1, 2))
        return kp0, kp1 + torch.stack([ex, ey], -1).reshape(xy1.shape)


class EfficientLoFTRMatcher(PairMatcher):
    """EfficientLoFTR: images in, fixed-capacity matches with both
    keypoints refined out."""

    def __init__(self, cfg: EfficientLoFTRConfig = EfficientLoFTRConfig()):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise ValueError(f"efficientloftr runs in float32 only, not "
                             f"{cfg.compute_dtype}")
        if cfg.d_coarse != cfg.stage_dims[-1]:
            raise ValueError("efficientloftr: d_coarse must be the last "
                             "stage's width")
        set_backends(cfg.compute_dtype)  # TF32 off, as DetectorFreeMatcher
        self.cfg = cfg
        self.backbone = RepVGG(cfg)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList()
        for _ in range(cfg.n_coarse_layers):
            layer = nn.Module()
            layer.self_attention = AggregatedAttention(cfg)
            layer.cross_attention = AggregatedAttention(cfg)
            self.transformer.layers.append(layer)
        self.fine_fusion = FineFusion(cfg)
        self.fine = FineMatching(cfg)

    def encode_views(self, images) -> EfficientLoFTRViews:
        """RepVGG on (N, H, W, 1) frames in [0, 1] (eval-mode BatchNorm:
        a view serves every pair it belongs to)."""
        side = 8 * self.cfg.q_aggregation
        if images.shape[1] % side or images.shape[2] % side:
            raise ValueError(f"efficientloftr: frames must be multiples of "
                             f"{side} px a side, got "
                             f"{tuple(images.shape[1:3])}")
        with span("matcher/repvgg", images.device):
            return EfficientLoFTRViews(
                *self.backbone(images.float().permute(0, 3, 1, 2)))

    def view_bytes(self, h: int, w: int) -> int:
        """Bytes of one view's three fp32 maps at an h x w frame."""
        d = self.cfg.stage_dims
        return 4 * sum((h // s) * (w // s) * c
                       for s, c in ((8, d[3]), (4, d[2]), (2, d[1])))

    def coarse_transformer(self, x, b: int):
        """The 4 (self, cross) layers on (2B, C, h8, w8): self-attention
        over both sides at once, then image 0 attends to image 1 and
        image 1 to image 0's updated features."""
        a = self.cfg.q_aggregation
        rope = rope_tables(x.shape[2] // a, x.shape[3] // a, x.shape[1],
                           self.cfg.rope_theta, x.device)
        for layer in self.transformer.layers:
            x = layer.self_attention(x, x, rope)
            f0 = layer.cross_attention(x[:b], x[b:])
            f1 = layer.cross_attention(x[b:], f0)
            x = torch.cat([f0, f1])
        return x

    def match_views(self, view0: EfficientLoFTRViews,
                    view1: EfficientLoFTRViews, valid_hw0=None,
                    valid_hw1=None, return_conf: bool = False):
        """The pair stage over the two sides' views (B each); arguments
        and outputs as PairMatcher.forward's."""
        cfg = self.cfg
        b, d, h8, w8 = view0.coarse.shape
        dev = view0.coarse.device
        x = self.coarse_transformer(
            torch.cat([view0.coarse, view1.coarse]), b)
        feat = x.flatten(2).transpose(1, 2)               # (2B, L, C)
        mask0 = grid_valid(valid_hw0, b, h8, w8, cfg.border, dev)
        mask1 = grid_valid(valid_hw1, b, h8, w8, cfg.border, dev)
        with span("matcher/dual_softmax", dev):
            conf = dual_softmax_confidence(feat[:b], feat[b:], mask0, mask1,
                                           cfg.dsoftmax_temperature)
            m = extract_topk_matches(conf, cfg.match_threshold,
                                     cfg.max_matches)
        with span("matcher/fine_fusion", dev):
            fmap = self.fine_fusion(x / d ** 0.5, [
                torch.cat([view0.quarter, view1.quarter]),
                torch.cat([view0.half, view1.half])])
            win0 = windows(fmap[:b], m.idx0, w8, cfg.fine_kernel, 0)
            win1 = windows(fmap[b:], m.idx1, w8, cfg.fine_kernel + 2, -1)
            del fmap
        xy0, xy1 = cells_to_xy(m.idx0, w8), cells_to_xy(m.idx1, w8)
        with span("matcher/fine", dev):
            kp0, kp1 = self.fine(win0, win1, xy0, xy1)
        out = MatchOutput(kp0, kp1, m.conf, m.valid)
        return (out, conf) if return_conf else out


PUBLISHED_PREFIXES = (
    ("efficientloftr.backbone.", "backbone."),
    ("efficientloftr.local_feature_transformer.", "transformer."),
    ("refinement_layer.", "fine_fusion."),
)


def from_published(state: dict) -> dict:
    """A state_dict under transformers' EfficientLoFTRForKeypointMatching
    names (the published zju-community/efficientloftr weights) under this
    module's: three prefixes renamed, BatchNorm's `num_batches_tracked`
    dropped. A name of neither raises. Write it as a checkpoint that
    `--matcher-ckpt` reads with utils/checkpoint.py's
    `save_checkpoint(path, state_dict_to_flax_variables(...))`."""
    out = {}
    for name, t in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        for old, new in PUBLISHED_PREFIXES:
            if name.startswith(old):
                out[new + name[len(old):]] = t
                break
        else:
            raise ValueError(f"efficientloftr: no port name for published "
                             f"parameter {name}")
    return out
