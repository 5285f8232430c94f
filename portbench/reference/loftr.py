"""Plain PyTorch forward of the LoFTR-class matcher (Sun et al., CVPR 2021,
outdoor_ds widths), one pair at a time, on the flax parameter tree of the
bundled checkpoint.

ResNet-FPN 8/2 (BasicBlocks 128/196/256, eval BatchNorm) over the padded
square frame; sine position encoding; the coarse transformer and the
dual-softmax over the cells that may match (the border-trimmed live region:
masked cells take part in neither); mutual nearest neighbours above the
threshold, at most `top_k` by confidence; the fine stage's 5x5 windows at
1/2 resolution, its transformer and soft-argmax. Keypoints come back in
frame pixels: image 0 at its cell's corner, image 1 moved by the fine
stage, unrounded.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .nn import batch_norm, soft_argmax, transformer

RESNET_BLOCKS = (("layer1_0", 1), ("layer1_1", 1), ("layer2_0", 2),
                 ("layer2_1", 1), ("layer3_0", 2), ("layer3_1", 1))


def _block(pr, p, s, x, stride):
    y = F.relu(batch_norm(pr.conv(x, p["conv1"]["kernel"], None, stride, 1),
                          p["bn1"], s["bn1"]))
    y = batch_norm(pr.conv(y, p["conv2"]["kernel"], None, 1, 1), p["bn2"],
                   s["bn2"])
    if "downsample_conv" in p:
        x = batch_norm(pr.conv(x, p["downsample_conv"]["kernel"], None,
                               stride, 0), p["downsample_bn"],
                       s["downsample_bn"])
    return F.relu(x + y)


def _conv(pr, p, x):
    k = p["kernel"]
    return pr.conv(x, k, None, 1, k.shape[-1] // 2)


def backbone(pr, W, x):
    """x (N, 1, H, W) -> coarse (N, 256, H/8, W/8), fine (N, 128, H/2,
    W/2)."""
    p, s = W["params"]["backbone"], W["batch_stats"]["backbone"]
    x = F.relu(batch_norm(pr.conv(x, p["conv1"]["kernel"], None, 2, 3),
                          p["bn1"], s["bn1"]))
    feats = []
    for name, stride in RESNET_BLOCKS:
        x = _block(pr, p[name], s[name], x, stride)
        feats.append(x)
    x1, x2, x3 = feats[1], feats[3], feats[5]
    c3 = _conv(pr, p["layer3_out"], x3)
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa
    y = _conv(pr, p["layer2_lateral"], x2) + up(c3)
    y = F.relu(batch_norm(_conv(pr, p["layer2_smooth1"], y),
                          p["layer2_smooth_bn"], s["layer2_smooth_bn"]))
    y = _conv(pr, p["layer2_smooth2"], y)
    y = _conv(pr, p["layer1_lateral"], x1) + up(y)
    y = F.relu(batch_norm(_conv(pr, p["layer1_smooth1"], y),
                          p["layer1_smooth_bn"], s["layer1_smooth_bn"]))
    return c3, _conv(pr, p["layer1_smooth2"], y)


def position_encoding(d, h, w, device):
    """(h, w, d): channel 4i sin(x f_i), 4i+1 cos(x f_i), 4i+2 sin(y f_i),
    4i+3 cos(y f_i), f_i = 10000^(-i / (d/4 - 1))."""
    d4 = d // 4
    f = torch.exp(torch.arange(d4, dtype=torch.float32, device=device) *
                  (-math.log(10000.0) / max(d4 - 1, 1)))
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    xs, ys = (x * f).expand(h, w, d4), (y * f).expand(h, w, d4)
    return torch.stack([xs.sin(), xs.cos(), ys.sin(), ys.cos()],
                       -1).reshape(h, w, d)


def cell_mask(h8, w8, hw, border, device):
    """(h8 * w8,) bool: the cells `border` in from the live region's edge
    (hw: (h, w) live pixels)."""
    vh, vw = int(hw[0]) // 8, int(hw[1]) // 8
    ys = torch.arange(h8, device=device)[:, None]
    xs = torch.arange(w8, device=device)[None, :]
    m = (ys >= border) & (xs >= border) & (ys < vh - border) & \
        (xs < vw - border)
    return m.reshape(-1)


def mutual_matches(pr, f0, f1, temperature, threshold, top_k):
    """Dual-softmax confidence of (L, C) and (S, C) features; rows that are
    their column's best too, above the threshold, at most top_k by
    confidence: (rows, cols, conf)."""
    c = f0.shape[-1]
    sim = pr.einsum("lc,sc->ls", f0 / math.sqrt(c),
                    f1 / math.sqrt(c)) / temperature
    log_conf = 2.0 * sim - torch.logsumexp(sim, 1)[:, None] - \
        torch.logsumexp(sim, 0)[None, :]
    del sim
    row_max, row_arg = log_conf.max(1)
    col_arg = log_conf.argmax(0)
    del log_conf
    conf = row_max.exp()
    rows = torch.arange(len(conf), device=conf.device)
    keep = (col_arg[row_arg] == rows) & (conf > threshold)
    rows = rows[keep]
    if len(rows) > top_k:
        rows = rows[torch.topk(conf[rows], top_k).indices]
    return rows, row_arg[rows], conf[rows]


def _windows(fine, idx, w8, win):
    """(N, win*win, C) windows of fine (hf, wf, C) centred at 4 x the
    cells `idx`, clamped to the map."""
    hf, wf, c = fine.shape
    half = win // 2
    off = torch.arange(-half, half + 1, device=fine.device)
    cy, cx = (idx // w8) * 4, (idx % w8) * 4
    yy = (cy[:, None, None] + off[None, :, None]).clamp(0, hf - 1)
    xx = (cx[:, None, None] + off[None, None, :]).clamp(0, wf - 1)
    return fine[yy, xx].reshape(len(idx), win * win, c)


def match_pair(pr, W, cfg, img0, img1, hw0, hw1):
    """img0, img1: (F, F) frames in [0, 1]; hw: (h, w) live pixels.
    Returns {kpts0, kpts1 (N, 2) frame pixels, conf (N,)}."""
    dev = img0.device
    frame = img0.shape[-1]
    h8 = w8 = frame // 8
    c3, fine = backbone(pr, W, torch.stack([img0, img1])[:, None].float())
    coarse = c3.permute(0, 2, 3, 1) + position_encoding(
        c3.shape[1], h8, w8, dev)
    coarse = coarse.reshape(2, h8 * w8, -1)
    masks = [cell_mask(h8, w8, hw, cfg["border"], dev) for hw in (hw0, hw1)]
    cells = [m.nonzero()[:, 0] for m in masks]
    f0 = coarse[0][cells[0]][None]
    f1 = coarse[1][cells[1]][None]
    p = W["params"]
    vs = 1.0 / (h8 * w8)  # one over the padded grid's source length
    f0, f1 = transformer(pr, p["coarse_transformer"], f0, f1, None, None,
                         cfg["nhead"], vs, vs)
    rows, cols, conf = mutual_matches(
        pr, f0[0], f1[0], cfg["dsoftmax_temperature"], cfg["match_threshold"],
        cfg["top_k"])
    idx0, idx1 = cells[0][rows], cells[1][cols]
    xy = lambda i: torch.stack([(i % w8).float() * 8.0,  # noqa: E731
                                (i // w8).float() * 8.0], -1)
    kpts0, kpts1 = xy(idx0), xy(idx1)
    if len(idx0):
        win = cfg["fine_window"]
        fmap = fine.permute(0, 2, 3, 1)
        w0 = _windows(fmap[0], idx0, w8, win)
        w1 = _windows(fmap[1], idx1, w8, win)
        fvs = 1.0 / (win * win)
        w0, w1 = transformer(pr, p["fine_match"]["fine_transformer"], w0, w1,
                             None, None, cfg["nhead"], fvs, fvs)
        center = w0[:, (win * win) // 2]
        sim = pr.einsum("nc,nwc->nw", center, w1) / math.sqrt(w1.shape[-1])
        coords = soft_argmax(sim.reshape(-1, win, win))
        kpts1 = kpts1 + coords * (win // 2) * 2.0
    return {"kpts0": kpts0, "kpts1": kpts1, "conf": conf}
