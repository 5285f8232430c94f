"""Plain PyTorch forward of the ASpan-class matcher (ASpanFormer, Chen et
al., ECCV 2022; widths of apple/ml-aspanformer's configs/aspan/outdoor/
aspan_test.py), one pair at a time, on the flax parameter tree of the
bundled checkpoint (`weights.py`).

The coarse output of ResNet-FPN 8/2 (BasicBlocks 128/196/256, eval
BatchNorm) over the padded square frame and the sine position encoding
(both `loftr.py`'s); then `n_flow_layers` rounds over the whole 1/8 grid
of each frame, padding included, since the flow heads and the windows
read every cell:
  self  LoFTR's linear-attention encoder layer in each image (`nn.py`),
        masked to the cells that may match, the values scaled by one
        over the grid's length;
  flow  per direction, a softmax over every cell of the other grid of
        the product of two 64-d projections over 8; each cell's target
        is the expected (col, row) under it, less its own, plus a learned
        2-d residual;
  span  per direction, attention from each cell to the (2r+1)^2 cells of
        the other grid around its target: the target clipped to the grid,
        the window's cells rounded half to even (torch.round, as in the
        program) and clipped again; a true softmax of q.k / sqrt(32) per
        head over the window; then the encoder layer's merge, LayerNorm,
        MLP and residual.
Then the dual-softmax and the mutual matches over the cells that may
match (`loftr.py`). Keypoints come back at their cells' corners in frame
pixels.

Departures from the published ASpanFormer, as the program has them: the
span is fixed at radius `span_radius` (2), where the published one is
scaled by the flow's uncertainty; there is no hierarchical sampling
inside the span; there is no fine stage (coarse matches only).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .loftr import backbone, cell_mask, mutual_matches, position_encoding
from .nn import encoder_layer, layer_norm


def grid_xy(h8, w8, device):
    """(h8 * w8, 2) float32 (col, row) of each cell, row-major."""
    rows, cols = torch.meshgrid(
        torch.arange(h8, dtype=torch.float32, device=device),
        torch.arange(w8, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([cols.reshape(-1), rows.reshape(-1)], -1)


def flow_head(pr, p, x, src, grid):
    """(L, 2) cell offsets into src's grid of x's (L, C) cells."""
    sim = pr.einsum("lc,sc->ls", pr.dense(x, p["proj_q"]),
                    pr.dense(src, p["proj_k"])) / 8.0
    expected = pr.einsum("ls,sk->lk", torch.softmax(sim, -1), grid)
    return expected - grid + pr.dense(x, p["delta"])


def window_cells(flow, grid, h8, w8, radius):
    """(L, (2r+1)^2) flat cells of each query's window."""
    cx = (grid[:, 0] + flow[:, 0]).clamp(0, w8 - 1)
    cy = (grid[:, 1] + flow[:, 1]).clamp(0, h8 - 1)
    off = torch.arange(-radius, radius + 1, dtype=torch.float32,
                       device=flow.device)
    gx = torch.round(cx[:, None, None] + off[None, None, :]).clamp(0, w8 - 1)
    gy = torch.round(cy[:, None, None] + off[None, :, None]).clamp(0, h8 - 1)
    return (gy * w8 + gx).long().reshape(len(flow), -1)


def span_layer(pr, p, x, src, cells, nhead):
    """Softmax cross-attention of x's (L, C) cells to src's cells at
    `cells` (L, K), then the encoder layer's update."""
    l, d = x.shape
    dh = d // nhead
    k = pr.dense(src, p["k_proj"])[cells].reshape(l, -1, nhead, dh)
    v = pr.dense(src, p["v_proj"])[cells].reshape(l, -1, nhead, dh)
    q = pr.dense(x, p["q_proj"]).reshape(l, nhead, dh)
    attn = torch.softmax(pr.einsum("lhd,lkhd->lhk", q, k) / math.sqrt(dh),
                         -1)
    msg = pr.dense(pr.einsum("lhk,lkhd->lhd", attn, v).reshape(l, d),
                   p["merge"])
    msg = layer_norm(torch.cat([x, msg], -1), p["norm1"])
    msg = pr.dense(F.relu(pr.dense(msg, p["mlp1"])), p["mlp2"])
    return x + layer_norm(msg, p["norm2"])


def match_pair(pr, W, cfg, img0, img1, hw0, hw1):
    """img0, img1: (F, F) frames in [0, 1]; hw: (h, w) live pixels.
    Returns {kpts0, kpts1 (N, 2) frame pixels, conf (N,)}."""
    dev = img0.device
    h8 = w8 = img0.shape[-1] // 8
    c3, _ = backbone(pr, W, torch.stack([img0, img1])[:, None].float())
    coarse = c3.permute(0, 2, 3, 1) + position_encoding(
        c3.shape[1], h8, w8, dev)
    f0, f1 = coarse.reshape(2, 1, h8 * w8, -1)
    masks = [cell_mask(h8, w8, hw, cfg["border"], dev)[None]
             for hw in (hw0, hw1)]
    p, nh, vs = W["params"], cfg["nhead"], 1.0 / (h8 * w8)
    grid = grid_xy(h8, w8, dev)
    r = cfg["span_radius"]
    for i in range(cfg["n_flow_layers"]):
        f0 = encoder_layer(pr, p[f"self0_{i}"], f0, f0, masks[0], masks[0],
                           nh, vs)
        f1 = encoder_layer(pr, p[f"self1_{i}"], f1, f1, masks[1], masks[1],
                           nh, vs)
        cells0 = window_cells(flow_head(pr, p[f"flow0_{i}"], f0[0], f1[0],
                                        grid), grid, h8, w8, r)
        cells1 = window_cells(flow_head(pr, p[f"flow1_{i}"], f1[0], f0[0],
                                        grid), grid, h8, w8, r)
        f0, f1 = (span_layer(pr, p[f"cross0_{i}"], f0[0], f1[0], cells0,
                             nh)[None],
                  span_layer(pr, p[f"cross1_{i}"], f1[0], f0[0], cells1,
                             nh)[None])
    live = [m[0].nonzero()[:, 0] for m in masks]
    rows, cols, conf = mutual_matches(
        pr, f0[0][live[0]], f1[0][live[1]], cfg["dsoftmax_temperature"],
        cfg["match_threshold"], cfg["top_k"])
    xy = lambda i: torch.stack([(i % w8).float() * 8.0,  # noqa: E731
                                (i // w8).float() * 8.0], -1)
    return {"kpts0": xy(live[0][rows]), "kpts1": xy(live[1][cols]),
            "conf": conf}
