"""Operations and bytes of the ASpan-class reference (`reference/aspan.py`),
counted from shapes as `roofline.py` counts the LoFTR-class one: only
convolutions and products (two operations per multiply-add).

The backbone's coarse path once per view; per pair and round, over the
whole 1/8 grid of L cells: two linear-attention self layers, two flow
heads and two span layers; then one dual-softmax product over the cells
that may match. The flow heads' roofline counts their two L x L products
(similarity and expectation) and, for bytes, the two fp32 64-d
projections read once and the (L, 2) fp32 flow written once.
"""

from __future__ import annotations

from portbench import roofline


def backbone_coarse(h, w, initial=128, dims=(128, 196, 256)):
    """One image through ResNet-FPN 8/2 up to its coarse output: the whole
    network less the top-down path to 1/2 (laterals and smooths)."""
    a, b, c = dims
    s4, s2 = (h // 4, w // 4), (h // 2, w // 2)
    top_down = (roofline.conv(b, c, 1, *s4) + roofline.conv(c, b, 3, *s4) +
                roofline.conv(b, b, 3, *s4) + roofline.conv(a, b, 1, *s2) +
                roofline.conv(b, b, 3, *s2) + roofline.conv(b, a, 3, *s2))
    return roofline.resnetfpn_8_2(h, w, initial, dims) - top_down


def flow_products(l, d_flow):
    """One flow head's L x L products: similarity and expectation."""
    return 2 * l * l * d_flow + 2 * l * l * 2


def flow_bytes(l, d_flow):
    """One flow head's least traffic: both fp32 projections read once, the
    (L, 2) fp32 flow written once."""
    return 4 * (2 * l * d_flow + 2 * l)


def flow_head(l, d, d_flow):
    """One flow head: the two projections, the products, the residual."""
    return 2 * 2 * l * d * d_flow + flow_products(l, d_flow) + 2 * l * d * 2


def span_layer(l, d, k):
    """One span layer: l queries, each against a window of k cells."""
    proj = 3 * 2 * l * d * d
    attn = 2 * l * k * d + 2 * l * k * d
    update = 2 * l * d * d + 2 * l * (2 * d) * (2 * d) + 2 * l * (2 * d) * d
    return proj + attn + update


def pair(cfg, frame, hw0, hw1):
    """Operations of one pair's stage through the reference (no backbone)."""
    l = (frame // 8) ** 2
    d, nh, df = cfg["d_coarse"], cfg["nhead"], cfg["d_flow"]
    k = (2 * cfg["span_radius"] + 1) ** 2
    per_round = 2 * (roofline.encoder(l, l, d, nh) + flow_head(l, d, df) +
                     span_layer(l, d, k))
    live0 = roofline.live_cells(*hw0, cfg["border"])
    live1 = roofline.live_cells(*hw1, cfg["border"])
    return (cfg["n_flow_layers"] * per_round +
            roofline.dual_softmax(live0, live1, d)[0])


def flow_heads(cfg, frame):
    """(operations, bytes) of one pair's flow heads at the roofline."""
    l, df = (frame // 8) ** 2, cfg["d_flow"]
    n = 2 * cfg["n_flow_layers"]
    return n * flow_products(l, df), n * flow_bytes(l, df)
