"""Plain PyTorch forward of the MatchFormer-class matcher (MatchFormer,
Wang et al., ACCV 2022, https://github.com/jamycheung/MatchFormer), one
pair at a time, on the flax parameter tree of a checkpoint (`weights.py`).

Three stages at strides 2, 4 and 8. Each stage is a 3x3 stride-2
convolution (the patch embed) over both frames, the sine position
encoding (`loftr.py`'s), then `stage_blocks` blocks of self-attention in
each image and cross-attention from each image to the other
("extract-and-match"). One attention layer, over a stage's (N, C) cells:
  keys and values from the source map average-pooled over `sr_ratio`
  squares; q, k, v projections; per head a full softmax of q.k / sqrt(d)
  over the pooled grid, the queries taken in blocks so that a 832 px
  frame fits; the output projection, a residual and LayerNorm; an MLP of
  width 2C with the tanh GELU, a residual and LayerNorm (post-norm).
Then the dual-softmax and the mutual matches over the cells that may
match (`loftr.py`), on the last stage's features. Returns those features
of both frames beside the matches; keypoints at their cells' corners in
frame pixels.

Departures from the published MatchFormer, as the program has them:
three stages, not four with an FPN decoder; no fine stage (coarse
matches only); keys and values reduced by average pooling; the sine
position encoding at every stage; the repo's MatchFormer-class widths
(64/128/256, blocks 1/2/2), 8 heads at every stage, an MLP of width 2C
and a 3x3 stride-2 patch embed before each stage, not the published lite
or large sizes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .loftr import cell_mask, mutual_matches, position_encoding
from .nn import gelu_tanh, layer_norm

QUERY_BLOCK = 8192


def sr_attention(pr, p, x, src, nhead, sr):
    """One layer: x (N, C) queries attend to src (H, W, C), pooled by
    `sr`; returns the layer's (N, C) output."""
    n, c = x.shape
    dh = c // nhead
    kv = src.permute(2, 0, 1)[None]
    if sr > 1:
        kv = F.avg_pool2d(kv, sr)
    kv = kv[0].reshape(c, -1).t()
    q = pr.dense(x, p["q"]).reshape(n, nhead, dh)
    k = pr.dense(kv, p["k"]).reshape(-1, nhead, dh)
    v = pr.dense(kv, p["v"]).reshape(-1, nhead, dh)
    out = torch.empty_like(q)
    for s in range(0, n, QUERY_BLOCK):
        logits = pr.einsum("nhd,mhd->hnm", q[s:s + QUERY_BLOCK],
                           k) / math.sqrt(dh)
        out[s:s + QUERY_BLOCK] = pr.einsum(
            "hnm,mhd->nhd", torch.softmax(logits, -1), v)
    y = layer_norm(x + pr.dense(out.reshape(n, c), p["proj"]), p["ln"])
    h = pr.dense(gelu_tanh(pr.dense(y, p["mlp1"])), p["mlp2"])
    return layer_norm(y + h, p["ln2"])


def encoder(pr, W, cfg, img0, img1):
    """(2, N, C) last-stage features of the two (F, F) frames."""
    p, nh = W["params"], cfg["nhead"]
    x = torch.stack([img0, img1])[:, None].float()
    for si, (blocks, sr) in enumerate(zip(cfg["stage_blocks"],
                                          cfg["sr_ratios"])):
        e = p[f"embed{si}"]
        x = pr.conv(x, e["kernel"], e["bias"], 2, 1)
        _, c, h, w = x.shape
        f = (x.permute(0, 2, 3, 1) +
             position_encoding(c, h, w, x.device)).reshape(2, h * w, c)
        for bi in range(blocks):
            ps, pc = p[f"s{si}_b{bi}_self"], p[f"s{si}_b{bi}_cross"]
            f = torch.stack([sr_attention(pr, ps, f[i],
                                          f[i].reshape(h, w, c), nh, sr)
                             for i in (0, 1)])
            f = torch.stack([sr_attention(pr, pc, f[i],
                                          f[1 - i].reshape(h, w, c), nh, sr)
                             for i in (0, 1)])
        x = f.reshape(2, h, w, c).permute(0, 3, 1, 2)
    return f


def match_pair(pr, W, cfg, img0, img1, hw0, hw1):
    """img0, img1: (F, F) frames in [0, 1]; hw: (h, w) live pixels.
    Returns {kpts0, kpts1 (N, 2) frame pixels, conf (N,), feat0, feat1
    (h8 * w8, C) last-stage features}."""
    f = encoder(pr, W, cfg, img0, img1)
    w8 = img0.shape[-1] // 8
    live = [cell_mask(w8, w8, hw, cfg["border"], f.device).nonzero()[:, 0]
            for hw in (hw0, hw1)]
    rows, cols, conf = mutual_matches(
        pr, f[0][live[0]], f[1][live[1]], cfg["dsoftmax_temperature"],
        cfg["match_threshold"], cfg["top_k"])
    xy = lambda i: torch.stack([(i % w8).float() * 8.0,  # noqa: E731
                                (i // w8).float() * 8.0], -1)
    return {"kpts0": xy(live[0][rows]), "kpts1": xy(live[1][cols]),
            "conf": conf, "feat0": f[0], "feat1": f[1]}
