"""ASpanFormer-class coarse matcher: flow-guided windowed attention.

Port of `ASpanConfig`, `FlowHead`, `FlowCrossAttention` and `ASpanMatcher`
from the JAX package's models/aspan.py. The LoFTR backbone and position
encoding feed `n_flow_layers` rounds of: linear self-attention in each
image, a flow head per image (where each cell lands in the other image:
the expected position under a low-rank global softmax, plus a learned
residual), and cross-attention restricted to the (2r+1)^2 cells around
each query's flow target. Matching is the dense dual-softmax; the fused
kernels serve the LoFTR family only, as in JAX. The two stages of
models/loftr.py's PairMatcher, without the fine stage: `encode_views`
(per image: the backbone's coarse path and the position encoding, into
CoarseViews) and `match_views` (per pair: the masks, the rounds and the
dual-softmax).

The window is discrete: the flow target is clipped to the grid, the
window's cells rounded (half to even, in both packages) and clipped again,
so a flow one ulp from JAX's can move a whole window cell.

`compute_dtype="bfloat16"` is JAX's bf16 path (models/layers.py): the
backbone, the projections and the residual stream in bf16; the flow
head's similarity, softmax and expectation, and the window attention's
logits and softmax in fp32 (JAX's `preferred_element_type=float32`), the
softmax rounded to bf16 before it weights the values.

Under a torch profiler (utils/profiler.py) the matcher records the spans
`matcher/backbone` (the module's call), and per round
`matcher/self_attention` (both self layers), `matcher/flow_head` (both
flow heads) and `matcher/span_attention` (both window cross-attentions:
window cells, projections, the window attention, merge and
feed-forward), then `matcher/dual_softmax` (the dense confidence and the
top-K), with their device time; and the counters `aspan/window_queries`
(queries x rounds x directions), `aspan/window_clamped` (those whose
window the grid's edge clipped, so that it attends repeated cells),
summed on the card, and `aspan/span_fused` (those whose window attention
the kernel of ops/span_attention.py computed, reading the window's rows
in place), `aspan/flow_queries` (the flow heads' queries) and
`aspan/flow_fused` (those whose expectation the kernel of
ops/flow_expectation.py computed, without the (B, L, L) similarity).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ..device import set_backends
from ..ops import flow_expectation as flow_ops
from ..ops import span_attention as span_ops
from ..ops.flow_expectation import flow_expectation, grid_xy
from ..ops.span_attention import span_attention
from ..utils.profiler import count, span
from .backbone import ResNetFPN_8_2
from .layers import Linear
from .loftr import MatcherConfig, PairMatcher, dense_match, grid_valid
from .position_encoding import add_position_encoding
from .transformer import EncoderLayer


@dataclasses.dataclass(frozen=True)
class ASpanConfig(MatcherConfig):
    span_radius: int = 2          # (2r+1)^2 attended cells around the target
    n_flow_layers: int = 4        # (self, flow, cross) rounds


class CoarseViews(NamedTuple):
    """What the coarse-only per-image stage gives for N views."""

    coarse: torch.Tensor   # (N, h8, w8, C) position-encoded, 1/8 grid


class FlowHead(nn.Module):
    """Per-cell flow into the other image: the softmax-expected position
    of a 64-d similarity, minus the cell's own, plus a learned residual."""

    def __init__(self, d_model: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.proj_q = Linear(d_model, 64, bias=False, compute_dtype=dt)
        self.proj_k = Linear(d_model, 64, bias=False, compute_dtype=dt)
        self.delta = Linear(d_model, 2, compute_dtype=dt)

    def forward(self, x, source, hw):
        """x, source: (B, L, C) on an (h, w) grid -> (B, L, 2) float32
        (dx_col, dy_row) cell offsets. The expectation is the kernel of
        ops/flow_expectation.py on the card, its dense version on the
        CPU."""
        b, l, w = x.shape[0], x.shape[1], hw[1]
        before = flow_ops.launches["flow_expectation"]
        expected = flow_expectation(self.proj_q(x).float(),
                                    self.proj_k(source).float(), w)
        count("aspan/flow_queries", b * l)
        count("aspan/flow_fused", b * l * (
            flow_ops.launches["flow_expectation"] - before))
        grid = grid_xy(l, w, x.device)
        return expected - grid + self.delta(x).float()


class FlowCrossAttention(EncoderLayer):
    """Cross-attention over the (2r+1)^2 window around each query's flow
    target; the EncoderLayer's projections, merge and feed-forward."""

    def __init__(self, d_model: int, nhead: int, radius: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, nhead, "linear", compute_dtype)
        self.radius = radius

    def window_cells(self, flow, hw):
        """(B, L, K2) int64 flat cells of each query's window, row-major
        over (dy, dx), from (B, L, 2) float32 flow."""
        b, l = flow.shape[:2]
        h, w = hw
        r = self.radius
        here = grid_xy(l, w, flow.device)
        cx = (here[:, 0] + flow[..., 0]).clamp(0, w - 1)
        cy = (here[:, 1] + flow[..., 1]).clamp(0, h - 1)
        offs = torch.arange(-r, r + 1, device=flow.device,
                            dtype=torch.float32)
        gx = torch.round(cx[..., None, None] + offs).clamp(0, w - 1)
        gy = torch.round(cy[..., None, None] + offs[:, None]).clamp(0, h - 1)
        count("aspan/window_queries", b * l)
        # Rounding is monotone: a window leaves the grid where its first
        # or last cell does.
        count("aspan/window_clamped", lambda: (
            (torch.round(cx - r) < 0) | (torch.round(cx + r) > w - 1) |
            (torch.round(cy - r) < 0) | (torch.round(cy + r) > h - 1)).sum())
        return (gy * w + gx).long().reshape(b, l, -1)

    def forward(self, x, source, hw, flow):
        """x: (B, L, C) queries on an (h, w) grid; source: (B, L, C) on the
        same grid; flow: (B, L, 2) predicted (dx_col, dy_row) offsets. The
        window attention is the kernel of ops/span_attention.py on the
        card, its gather/einsum chain on the CPU."""
        b, l, _ = x.shape
        cells = self.window_cells(flow, hw)
        before = span_ops.launches["span_attention"]
        msg = span_attention(self.q_proj(x), self.k_proj(source),
                             self.v_proj(source), cells, self.nhead)
        count("aspan/span_fused", b * l * (
            span_ops.launches["span_attention"] - before))
        return self.update(x, msg)


class ASpanMatcher(PairMatcher):
    """Flow-guided coarse matcher."""

    def __init__(self, cfg: ASpanConfig = ASpanConfig()):
        super().__init__()
        set_backends(cfg.compute_dtype)  # as DetectorFreeMatcher
        self.cfg = cfg
        dt, d, nh = cfg.dtype, cfg.d_coarse, cfg.nhead
        self.backbone = ResNetFPN_8_2(compute_dtype=dt)
        for i in range(cfg.n_flow_layers):
            for s in (0, 1):
                self.add_module(f"self{s}_{i}",
                                EncoderLayer(d, nh, "linear", dt))
                self.add_module(f"flow{s}_{i}", FlowHead(d, dt))
                self.add_module(f"cross{s}_{i}", FlowCrossAttention(
                    d, nh, cfg.span_radius, dt))

    def encode_views(self, images) -> CoarseViews:
        """The per-image stage: (N, H, W, 1) frames in [0, 1] to their
        CoarseViews, the backbone's coarse path (its FPN path is skipped)
        and the position encoding. Nothing in it reads another image."""
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        with span("matcher/backbone", images.device):
            coarse, _ = self.backbone(x, fine=False)
        return CoarseViews(add_position_encoding(coarse.permute(0, 2, 3, 1)))

    def view_bytes(self, h: int, w: int) -> int:
        """Bytes of one view's CoarseViews at an h x w frame."""
        cfg = self.cfg
        return (h // 8) * (w // 8) * cfg.d_coarse * cfg.dtype.itemsize

    def match_views(self, view0: CoarseViews, view1: CoarseViews,
                    valid_hw0=None, valid_hw1=None,
                    return_conf: bool = False):
        """The pair stage: the masks, the rounds and the dense
        dual-softmax over the two sides' CoarseViews (B views each);
        arguments and outputs as PairMatcher.forward's."""
        cfg = self.cfg
        b, h8, w8, d = view0.coarse.shape
        c0 = view0.coarse.reshape(b, h8 * w8, d)
        c1 = view1.coarse.reshape(b, h8 * w8, d)
        dev = c0.device
        mask0 = grid_valid(valid_hw0, b, h8, w8, cfg.border, dev)
        mask1 = grid_valid(valid_hw1, b, h8, w8, cfg.border, dev)
        hw = (h8, w8)
        for i in range(cfg.n_flow_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            with span("matcher/self_attention", dev):
                c0 = layer("self0")(c0, c0, mask0, mask0)
                c1 = layer("self1")(c1, c1, mask1, mask1)
            with span("matcher/flow_head", dev):
                flow0 = layer("flow0")(c0, c1, hw)
                flow1 = layer("flow1")(c1, c0, hw)
            with span("matcher/span_attention", dev):
                c0, c1 = (layer("cross0")(c0, c1, hw, flow0),
                          layer("cross1")(c1, c0, hw, flow1))
        with span("matcher/dual_softmax", dev):
            return dense_match(c0, c1, mask0, mask1, cfg, w8, return_conf)
