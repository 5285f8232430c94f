"""Operations and bytes of the MatchFormer-class reference
(`reference/matchformer.py`), counted from shapes as `roofline.py` counts
the LoFTR-class one: only convolutions and products (two operations per
multiply-add).

Per pair, both frames through every stage (the encoder attends across
the pair, so nothing is computed once per view): the patch embed, then
per block a self and a cross attention layer in each image, each of N
queries against the M cells of the pooled grid; then one dual-softmax
product over the cells that may match. The attention core's roofline
counts its QK and AV products (4 N M C a layer) and, for bytes, q, the
pooled k and v read once and the output written once, in fp32.
"""

from __future__ import annotations

from portbench import roofline


def stages(cfg, frame):
    """(grid side, channels, blocks, pooled keys) of each stage."""
    out, side = [], frame
    for c, blocks, sr in zip(cfg["stage_dims"], cfg["stage_blocks"],
                             cfg["sr_ratios"]):
        side //= 2
        out.append((side, c, blocks, (side // sr) ** 2))
    return out


def attention_products(n, m, c):
    """One layer's QK and AV products: n queries, m keys, width c."""
    return 4 * n * m * c


def attention_bytes(n, m, c):
    """One layer's least traffic: q and the output (n x c), the pooled k
    and v (m x c), fp32, each once."""
    return 4 * (2 * n * c + 2 * m * c)


def layer(n, m, c):
    """One attention layer: q, k, v, the products, the output projection
    and the MLP of width 2c."""
    return (2 * n * c * c + 2 * 2 * m * c * c + attention_products(n, m, c) +
            2 * n * c * c + 2 * n * c * (2 * c) + 2 * n * (2 * c) * c)


def pair(cfg, frame, hw0, hw1):
    """Operations of one pair through the reference."""
    total, cin = 0, 1
    for side, c, blocks, m in stages(cfg, frame):
        n = side * side
        total += 2 * (roofline.conv(cin, c, 3, side, side) +
                      2 * blocks * layer(n, m, c))
        cin = c
    live0 = roofline.live_cells(*hw0, cfg["border"])
    live1 = roofline.live_cells(*hw1, cfg["border"])
    return total + roofline.dual_softmax(live0, live1, cin)[0]


def sr_attention(cfg, frame):
    """(operations, bytes) of one pair's attention cores at the
    roofline: every layer of both frames."""
    flops = nbytes = 0
    for side, c, blocks, m in stages(cfg, frame):
        layers = 2 * 2 * blocks
        flops += layers * attention_products(side * side, m, c)
        nbytes += layers * attention_bytes(side * side, m, c)
    return flops, nbytes
