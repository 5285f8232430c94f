"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes that the references' forwards need, counted from
shapes. Only convolutions and products count (two operations per
multiply-add); elementwise work, norms and softmaxes do not.

The counts follow the references (`reference/`), so they stay the same
whatever the program does: the backbone over the padded frame; the
transformers, the dual-softmax and the refiner over what may match or
exists (cells inside the border-trimmed live region; a track's live
nodes); the fine stage over the matches the inputs produce.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core operations and HBM3
# bandwidth. Rates assume the 700 W power limit.
PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def conv(cin, cout, k, oh, ow):
    return 2 * cin * cout * k * k * oh * ow


def resnetfpn_8_2(h, w, initial=128, dims=(128, 196, 256)):
    """One image of ResNet-FPN 8/2 at h x w (multiples of 8)."""
    a, b, c = dims
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    s2, s4, s8 = (h2, w2), (h4, w4), (h8, w8)
    layers = [
        (1, initial, 7, s2),
        (initial, a, 3, s2), (a, a, 3, s2), (a, a, 3, s2), (a, a, 3, s2),
        (a, b, 3, s4), (b, b, 3, s4), (a, b, 1, s4), (b, b, 3, s4),
        (b, b, 3, s4),
        (b, c, 3, s8), (c, c, 3, s8), (b, c, 1, s8), (c, c, 3, s8),
        (c, c, 3, s8),
        (c, c, 1, s8),                                      # layer3_out
        (b, c, 1, s4), (c, b, 3, s4), (b, b, 3, s4),        # 1/4 path
        (a, b, 1, s2), (b, b, 3, s2), (b, a, 3, s2),        # 1/2 path
    ]
    if initial != a:
        raise ValueError("layer1_0 without a downsample needs initial == "
                         "dims[0]")
    return sum(conv(ci, co, k, *s) for ci, co, k, s in layers)


def encoder(l, s, d, nhead):
    """One encoder layer: l queries against s sources of width d."""
    dh = d // nhead
    proj = 2 * d * d * (l + 2 * s)
    attn = 2 * s * d * dh + 2 * l * d + 2 * l * d * dh
    mlp = 2 * l * d * d + 2 * l * (2 * d) * (2 * d) + 2 * l * (2 * d) * d
    return proj + attn + mlp


def transformer(l0, l1, d, nhead, n_pairs):
    """n_pairs (self, cross) layer pairs over sets of l0 and l1 tokens."""
    per = (encoder(l0, l0, d, nhead) + encoder(l1, l1, d, nhead) +
           encoder(l0, l1, d, nhead) + encoder(l1, l0, d, nhead))
    return n_pairs * per


def dual_softmax(l, s, c):
    """(flops, bytes) of dual-softmax matching of l x s cells of width c:
    one product; the fp32 features and masks read once, the row and
    column (max, arg) written once."""
    flops = 2 * l * s * c
    nbytes = 4 * (l + s) * c + 4 * (l + s) + 8 * (l + s)
    return flops, nbytes


def live_cells(h, w, border):
    """Cells of the 1/8 grid inside the border-trimmed live region."""
    return max(h // 8 - 2 * border, 0) * max(w // 8 - 2 * border, 0)


def loftr_pair(cfg, frame, hw0, hw1, n_matches):
    """Operations of one pair through the LoFTR-class reference."""
    l0 = live_cells(*hw0, cfg["border"])
    l1 = live_cells(*hw1, cfg["border"])
    d, h = cfg["d_coarse"], cfg["nhead"]
    win = cfg["fine_window"] ** 2
    fine = (transformer(win, win, cfg["d_fine"], h, 1) +
            2 * win * cfg["d_fine"])
    return (2 * resnetfpn_8_2(frame, frame, cfg["initial_dim"],
                              cfg["block_dims"]) +
            transformer(l0, l1, d, h, cfg["n_coarse_layers"]) +
            dual_softmax(l0, l1, d)[0] + n_matches * fine)


def s2dnet(p, out_dim=128):
    """One p x p patch through S2DNet (VGG dims 64/128/256)."""
    p2 = math.ceil(p / 2)
    p4 = math.ceil(p2 / 2)
    return (conv(1, 64, 3, p, p) + conv(64, 64, 3, p, p) +
            conv(64, 128, 3, p2, p2) + conv(128, 128, 3, p2, p2) +
            conv(128, 256, 3, p4, p4) + 2 * conv(256, 256, 3, p4, p4) +
            conv(64, out_dim, 1, p, p) + conv(out_dim, out_dim, 5, p, p) +
            conv(256, out_dim, 1, p4, p4) + conv(out_dim, out_dim, 5, p4,
                                                 p4))


def refiner_track(cfg, n_nodes, window):
    """Operations of one track of n_nodes live nodes (reference first)."""
    w2 = window * window
    d = cfg["d_model"]
    q = (n_nodes - 1) * w2
    return (n_nodes * s2dnet(window + cfg["crop_extra"], d) +
            transformer(w2, q, d, cfg["nhead"], cfg["n_layers"]) +
            2 * q * d)


def roofline_share(flops, nbytes, seconds):
    """Least time at the peaks over the time taken, in %."""
    least = max(flops / PEAKS["bf16_flops_per_s"],
                nbytes / PEAKS["hbm_bytes_per_s"])
    return 100.0 * least / seconds
