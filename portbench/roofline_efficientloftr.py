"""Operations and bytes of the EfficientLoFTR reference
(`reference/efficientloftr.py`), counted from shapes as `roofline.py`
counts the LoFTR-class one: only convolutions and products (two
operations per multiply-add).

RepVGG once per view (the engine's store computes a view once per call,
as for ASpan); per pair, both frames through the 4 (self, cross) layers
of aggregated attention over the padded 1/8 grid, one dual-softmax
product over the cells that may match, the fine fusion of both frames to
full resolution and the two fine stages at the reference's matches. The
fusion's roofline counts its conv products and, for bytes, the three
maps it reads (the coarse features, the 1/4 and 1/2 maps) read once and
the full-resolution map written once, in fp32.
"""

from __future__ import annotations

from portbench import roofline


def repvgg(cfg, h, w):
    """One h x w frame through RepVGG: each block's 3x3 and 1x1 branch."""
    total, cin = 0, 1
    for blocks, cout, stride in zip(cfg["stage_blocks"], cfg["stage_dims"],
                                    cfg["stage_strides"]):
        h, w = h // stride, w // stride
        for b in range(blocks):
            ci = cin if b == 0 else cout
            total += (roofline.conv(ci, cout, 3, h, w) +
                      roofline.conv(ci, cout, 1, h, w))
        cin = cout
    return total


def attention_module(cfg, h8, w8):
    """One aggregated-attention module on one frame's h8 x w8 grid."""
    d, a, kva = cfg["d_coarse"], cfg["q_aggregation"], cfg["kv_aggregation"]
    n = (h8 // a) * (w8 // a)
    m = (h8 // kva) * (w8 // kva)
    cells = h8 * w8
    return (roofline.conv(1, d, a, h8 // a, w8 // a) +   # depthwise
            2 * n * d * d + 2 * 2 * m * d * d +          # q; k and v
            4 * n * m * d + 2 * n * d * d +              # attention; o
            2 * cells * (2 * d) * cfg["d_mlp"] +
            2 * cells * cfg["d_mlp"] * d)


def transformer(cfg, frame):
    """Both frames through every (self, cross) layer."""
    side = frame // 8
    return 2 * 2 * cfg["n_coarse_layers"] * attention_module(cfg, side,
                                                             side)


def fusion_maps(cfg, frame):
    """(channels, side) of the maps the fusion reads, coarsest first, and
    of the map it writes."""
    d = cfg["stage_dims"]
    return [(d[3], frame // 8), (d[2], frame // 4), (d[1], frame // 2)], \
        (d[1], frame)


def fusion(cfg, frame):
    """(operations, bytes) of the fine fusion of one pair's two frames."""
    (c8, s8), (c4, s4), (c2, s2) = fusion_maps(cfg, frame)[0]
    flops = (roofline.conv(c8, c8, 1, s8, s8) +
             roofline.conv(c4, c8, 1, s4, s4) +
             roofline.conv(c8, c8, 3, s4, s4) +
             roofline.conv(c8, c4, 3, s4, s4) +
             roofline.conv(c2, c4, 1, s2, s2) +
             roofline.conv(c4, c4, 3, s2, s2) +
             roofline.conv(c4, c2, 3, s2, s2))
    maps, (cf, sf) = fusion_maps(cfg, frame)
    nbytes = 4 * (sum(c * s * s for c, s in maps) + cf * sf * sf)
    return 2 * flops, 2 * nbytes


def fine(cfg, n_matches):
    """The two fine stages' products at n matches: the first stage over
    the first C - 8 channels, the second over the last 8, each window
    against window (W^2 x (W + 2)^2)."""
    w = cfg["fine_kernel"]
    c = cfg["stage_dims"][1]
    return n_matches * 2 * w * w * (w + 2) ** 2 * c


def pair(cfg, frame, hw0, hw1, n_matches):
    """Operations of one pair's stage through the reference (RepVGG
    apart)."""
    live0 = roofline.live_cells(*hw0, cfg["border"])
    live1 = roofline.live_cells(*hw1, cfg["border"])
    return (transformer(cfg, frame) +
            roofline.dual_softmax(live0, live1, cfg["d_coarse"])[0] +
            fusion(cfg, frame)[0] + fine(cfg, n_matches))
