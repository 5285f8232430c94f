"""Plain PyTorch forward of EfficientLoFTR (Wang et al., CVPR 2024,
https://github.com/zju3dv/EfficientLoFTR), one pair at a time, on the
flax parameter tree of a checkpoint (`weights.py`). It follows
transformers 4.57.6's models/efficientloftr/modeling_efficientloftr.py
(`EfficientLoFTRForKeypointMatching`) at the published widths:

  RepVGG over both (F, F) frames: stages of blocks ReLU(BN(conv3x3) +
  BN(conv1x1) [+ BN(x)]), the 1/8, 1/4 and 1/2 maps kept; 4 layers of
  (self, cross) aggregated attention on the 1/8 maps: queries through a
  depthwise conv of kernel and stride 4, keys and values through a 4x4
  max-pool, a shared LayerNorm, q/k/v without bias, the 2-D rotary
  embedding in self-attention only, softmax attention per head, the
  output projection, bilinear x4, an MLP on [x, message] with leaky ReLU
  and LayerNorm, a residual; image 1's cross-attention reads image 0's
  updated features; the dual-softmax and mutual matches over the cells
  that may match (`loftr.py`); the fine fusion (coarse / sqrt(C), 1x1 conv,
  bilinear x2, two blocks of conv1x1(skip) + x, conv3x3, BN, leaky ReLU,
  conv3x3, bilinear x2) to a full-resolution map; its 8x8 windows of
  image 0 and 10x10 of image 1 unfolded at stride 8; the fine stage's
  dual-softmax over the first C - 8 channels, its argmax over the inner
  64 x 64 moving both keypoints, and the 3x3 softmax (temperature 10) of
  the last 8 channels around it moving image 1's.

Departures from transformers, as the program has them: a match (i, j)
takes image 0's window at i and image 1's at j, with the offsets of its
own argmax (transformers pairs rows by position and gathers every offset
from the window's corner); at most `top_k` matches by confidence; the
border counted from the live region, which takes part in the softmax
alone.

Returns the matches with both refined keypoints (frame pixels) and their
confidences, the post-transformer coarse features of both frames, and a
function that runs the fine stage at given (idx0, idx1) cells.

The published weights are not in the repository: `seeded_weights` draws
a flax tree from a seed and sets each BatchNorm's running statistics with
this module's own forward (`calibrate`), for the benchmark's cell and the
port's tests alike.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .loftr import cell_mask, mutual_matches
from .nn import FP32, batch_norm, exact_fp32, layer_norm
from .weights import _convert

LN_EPS = 1e-5


def _convnorm(pr, p, s, x, stride, norm):
    k = p["conv"]["kernel"]
    return norm(pr.conv(x, k, None, stride, k.shape[-1] // 2), p["norm"],
                s["norm"])


def backbone(pr, W, cfg, x, norm=batch_norm):
    """x (N, 1, F, F) -> [1/8, 1/4, 1/2] maps, NCHW."""
    p, s = W["params"]["backbone"], W["batch_stats"]["backbone"]
    outs = []
    for si, (blocks, stride) in enumerate(zip(cfg["stage_blocks"],
                                              cfg["stage_strides"])):
        for bi in range(blocks):
            bp = p["stages"][str(si)]["blocks"][str(bi)]
            bs = s["stages"][str(si)]["blocks"][str(bi)]
            st = stride if bi == 0 else 1
            y = _convnorm(pr, bp["conv1"], bs["conv1"], x, st, norm) + \
                _convnorm(pr, bp["conv2"], bs["conv2"], x, st, norm)
            if "identity" in bp:
                y = y + norm(x, bp["identity"], bs["identity"])
            x = F.relu(y)
        outs.append(x)
    return [outs[3], outs[2], outs[1]]


def rope(h, w, d, theta, device):
    """(cos, sin) of the h x w aggregated grid, (h * w, d): channel c
    turns by pos * theta^(-2 (c // 4) / (d / 2)), pos the row (from 1)
    where c // 2 is even, else the column."""
    c = torch.arange(d, device=device)
    freq = 1.0 / theta ** ((2 * (c // 4)).float() / (d // 2))
    rows = torch.arange(1, h + 1, device=device).float()
    cols = torch.arange(1, w + 1, device=device).float()
    pos = torch.where((c // 2) % 2 == 0, rows[:, None, None],
                      cols[None, :, None])
    ang = (pos * freq).reshape(h * w, d)
    return ang.cos(), ang.sin()


def _rotate(x, cs):
    x1, x2 = x[:, 0::2], x[:, 1::2]
    turned = torch.stack([-x2, x1], -1).reshape(x.shape)
    return x * cs[0] + turned * cs[1]


def aggregated_attention(pr, p, x, src, cfg, cs=None):
    """One module: x, src (C, H, W) 1/8 maps -> x updated."""
    c, h8, w8 = x.shape
    a, nh = cfg["q_aggregation"], cfg["nhead"]
    dh = c // nh
    k = p["aggregation"]["q_aggregation"]["kernel"][:, 0]    # (C, a, a)
    q = pr.einsum("chiwj,cij->chw", x.reshape(c, h8 // a, a, w8 // a, a), k)
    kv = F.max_pool2d(src[None], cfg["kv_aggregation"])[0]
    h, w = q.shape[1:]
    q = layer_norm(q.reshape(c, -1).t(), p["aggregation"]["norm"], LN_EPS)
    kv = layer_norm(kv.reshape(c, -1).t(), p["aggregation"]["norm"], LN_EPS)
    att = p["attention"]
    q, kk, v = (pr.dense(q, att["q_proj"]), pr.dense(kv, att["k_proj"]),
                pr.dense(kv, att["v_proj"]))
    if cs is not None:
        q, kk = _rotate(q, cs), _rotate(kk, cs)
    logits = pr.einsum("nhd,mhd->hnm", q.reshape(-1, nh, dh),
                       kk.reshape(-1, nh, dh)) / math.sqrt(dh)
    out = pr.einsum("hnm,mhd->nhd", torch.softmax(logits, -1),
                    v.reshape(-1, nh, dh)).reshape(-1, c)
    msg = pr.dense(out, att["o_proj"]).t().reshape(1, c, h, w)
    msg = F.interpolate(msg, scale_factor=a, mode="bilinear",
                        align_corners=False)[0]
    y = torch.cat([x, msg]).reshape(2 * c, -1).t()
    m = p["mlp"]
    y = pr.dense(F.leaky_relu(pr.dense(y, m["fc1"])), m["fc2"])
    y = layer_norm(y, m["layer_norm"], LN_EPS)
    return x + y.t().reshape(c, h8, w8)


def transformer(pr, W, cfg, c0, c1):
    """The (self, cross) layers on the two (C, h8, w8) coarse maps."""
    c, h8, w8 = c0.shape
    a = cfg["q_aggregation"]
    cs = rope(h8 // a, w8 // a, c, cfg["rope_theta"], c0.device)
    layers = W["params"]["transformer"]["layers"]
    for i in range(cfg["n_coarse_layers"]):
        ps, pc = layers[str(i)]["self_attention"], \
            layers[str(i)]["cross_attention"]
        c0 = aggregated_attention(pr, ps, c0, c0, cfg, cs)
        c1 = aggregated_attention(pr, ps, c1, c1, cfg, cs)
        c0 = aggregated_attention(pr, pc, c0, c1, cfg)
        c1 = aggregated_attention(pr, pc, c1, c0, cfg)
    return c0, c1


def fusion(pr, W, coarse, quarter, half, norm=batch_norm):
    """(N, C, h8, w8) coarse, the 1/4 and 1/2 maps -> (N, C_f, F, F)."""
    p = W["params"]["fine_fusion"]
    s = W["batch_stats"]["fine_fusion"]
    up = lambda t: F.interpolate(t, scale_factor=2.0,  # noqa: E731
                                 mode="bilinear", align_corners=False)
    x = up(pr.conv(coarse / math.sqrt(coarse.shape[1]),
                   p["out_conv"]["kernel"]))
    for i, r in enumerate((quarter, half)):
        bp, bs = p["out_conv_layers"][str(i)], s["out_conv_layers"][str(i)]
        y = pr.conv(r, bp["out_conv1"]["kernel"]) + x
        y = norm(pr.conv(y, bp["out_conv2"]["kernel"], None, 1, 1),
                 bp["batch_norm"], bs["batch_norm"])
        x = up(pr.conv(F.leaky_relu(y), bp["out_conv3"]["kernel"], None, 1,
                       1))
    return x


def fine_stage(pr, cfg, fmap0, fmap1, idx0, idx1, w8):
    """Both refined keypoints (M, 2) of the matches (idx0, idx1) over the
    full-resolution maps fmap0, fmap1 (C, F, F)."""
    win, sl, dev = cfg["fine_kernel"], cfg["fine_slice"], fmap0.device
    c = fmap0.shape[0]
    u0 = F.unfold(fmap0[None], win, stride=8).reshape(c, win * win, -1)
    u1 = F.unfold(fmap1[None], win + 2, stride=8, padding=1).reshape(
        c, (win + 2) ** 2, -1)
    f0 = u0[:, :, idx0.long()].permute(2, 1, 0)        # (M, 64, C)
    f1 = u1[:, :, idx1.long()].permute(2, 1, 0)        # (M, 100, C)
    d1 = c - sl
    sim = pr.einsum("mlc,mrc->mlr", f0[..., :d1] / math.sqrt(d1),
                    f1[..., :d1] / math.sqrt(d1))
    conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
    conf = conf.reshape(-1, win * win, win + 2, win + 2)[..., 1:-1, 1:-1]
    best = conf.reshape(len(f0), win ** 4).argmax(1)
    il, ir = best // (win * win), best % (win * win)
    cell = lambda i: torch.stack([(i % w8).float() * 8.0,  # noqa: E731
                                  (i // w8).float() * 8.0], -1)
    grid = lambda i: torch.stack([(i % win).float(),  # noqa: E731
                                  (i // win).float()], -1) - win // 2 + 0.5
    kp0 = cell(idx0) + grid(il)
    kp1 = cell(idx1) + grid(ir)
    conf2 = pr.einsum("mlc,mrc->mlr", f0[..., d1:],
                      f1[..., d1:] / math.sqrt(sl)).reshape(
        -1, win * win, win + 2, win + 2)
    d = torch.arange(-1, 2, device=dev)
    m = torch.arange(len(f0), device=dev)[:, None, None]
    # transformers' indexing: padded rows and columns cell - 1 .. cell + 1
    # of the inner cell's index; -1 reads the last row or column.
    heat = conf2[m, il[:, None, None], (ir // win)[:, None, None] +
                 d[:, None], (ir % win)[:, None, None] + d[None, :]]
    heat = torch.softmax(heat.reshape(-1, 9) / cfg["fine_temperature"],
                         -1).reshape(-1, 3, 3)
    lin = torch.linspace(-1.0, 1.0, 3, device=dev)
    ex = (heat * lin[None, None, :]).sum((1, 2))
    ey = (heat * lin[None, :, None]).sum((1, 2))
    return kp0, kp1 + torch.stack([ex, ey], -1)


def match_pair(pr, W, cfg, img0, img1, hw0, hw1):
    """img0, img1: (F, F) frames in [0, 1]; hw: (h, w) live pixels.
    Returns {kpts0, kpts1 (N, 2) refined frame pixels, conf (N,), idx0,
    idx1 (N,) cells, feat0, feat1 (h8 * w8, C) post-transformer coarse
    features, fine_at: (idx0, idx1) -> (kpts0, kpts1)}."""
    coarse, quarter, half = backbone(
        pr, W, cfg, torch.stack([img0, img1])[:, None].float())
    c0, c1 = transformer(pr, W, cfg, coarse[0], coarse[1])
    c, h8, w8 = c0.shape
    f0, f1 = c0.reshape(c, -1).t(), c1.reshape(c, -1).t()
    live = [cell_mask(h8, w8, hw, cfg["border"], c0.device).nonzero()[:, 0]
            for hw in (hw0, hw1)]
    rows, cols, conf = mutual_matches(
        pr, f0[live[0]], f1[live[1]], cfg["dsoftmax_temperature"],
        cfg["match_threshold"], cfg["top_k"])
    idx0, idx1 = live[0][rows], live[1][cols]
    fmap = fusion(pr, W, torch.stack([c0, c1]), quarter, half)
    del coarse, quarter, half

    def fine_at(i0, i1):
        return fine_stage(pr, cfg, fmap[0], fmap[1], i0, i1, w8)

    kpts0, kpts1 = fine_at(idx0, idx1)
    return {"kpts0": kpts0, "kpts1": kpts1, "conf": conf, "idx0": idx0,
            "idx1": idx1, "feat0": f0, "feat1": f1, "fine_at": fine_at}


def seeded_tree(cfg, seed: int) -> dict:
    """EfficientLoFTR's flax tree of `cfg`'s widths, every leaf drawn from
    `seed`: conv and Dense kernels N(0, 1) over the root of their fan-in
    (the depthwise aggregation's over 4, its fan-in's root), BatchNorm and
    LayerNorm scales 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1); the
    BatchNorm statistics at (0, 1) until `calibrate` sets them."""
    g = torch.Generator().manual_seed(seed % 2 ** 63)

    def normal(*shape):
        return torch.randn(*shape, generator=g)

    def conv(cin, cout, k):
        return {"kernel": normal(k, k, cin, cout) / math.sqrt(k * k * cin)}

    def norm(c):
        return {"scale": 1.0 + 0.1 * normal(c), "bias": 0.1 * normal(c)}

    def stats(c):
        return {"mean": torch.zeros(c), "var": torch.ones(c)}

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out) / math.sqrt(n_in)}

    stages_p, stages_s, cin = {}, {}, 1
    for si, (blocks, cout, stride) in enumerate(zip(
            cfg["stage_blocks"], cfg["stage_dims"], cfg["stage_strides"])):
        bp, bs = {}, {}
        for b in range(blocks):
            ci = cin if b == 0 else cout
            p = {n: {"conv": conv(ci, cout, k), "norm": norm(cout)}
                 for n, k in (("conv1", 3), ("conv2", 1))}
            s = {n: {"norm": stats(cout)} for n in ("conv1", "conv2")}
            if ci == cout and (b > 0 or stride == 1):
                p["identity"], s["identity"] = norm(ci), stats(ci)
            bp[str(b)], bs[str(b)] = p, s
        stages_p[str(si)], stages_s[str(si)] = {"blocks": bp}, {"blocks": bs}
        cin = cout
    d, a = cfg["d_coarse"], cfg["q_aggregation"]
    layers = {}
    for i in range(cfg["n_coarse_layers"]):
        layers[str(i)] = {kind: {
            "aggregation": {"q_aggregation": conv(1, d, a), "norm": norm(d)},
            "attention": {n: dense(d, d) for n in
                          ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {"fc1": dense(2 * d, cfg["d_mlp"]),
                    "fc2": dense(cfg["d_mlp"], d),
                    "layer_norm": norm(d)}}
            for kind in ("self_attention", "cross_attention")}
    dims = cfg["stage_dims"][:0:-1]
    fp, fs = {"out_conv": conv(dims[0], dims[0], 1)}, {}
    lp, ls = {}, {}
    for i, (ci, co) in enumerate(zip(dims, dims[1:])):
        lp[str(i)] = {"out_conv1": conv(co, ci, 1),
                      "out_conv2": conv(ci, ci, 3), "batch_norm": norm(ci),
                      "out_conv3": conv(ci, co, 3)}
        ls[str(i)] = {"batch_norm": stats(ci)}
    fp["out_conv_layers"], fs["out_conv_layers"] = lp, ls
    return {"params": {"backbone": {"stages": stages_p},
                       "transformer": {"layers": layers},
                       "fine_fusion": fp},
            "batch_stats": {"backbone": {"stages": stages_s},
                            "fine_fusion": {"out_conv_layers": ls}}}


def _measured_norm(x, p, s, eps=1e-5):
    """BatchNorm that first sets its running mean and variance to its
    input's, per channel over the batch and the pixels."""
    s["mean"] = x.mean((0, 2, 3))
    s["var"] = x.var((0, 2, 3), unbiased=False)
    return batch_norm(x, p, s, eps)


def calibrate(W, cfg, image0, image1):
    """Set each BatchNorm's running statistics in W to those of its input
    over the pairs (image0[i], image1[i]), each (P, F, F), as training
    leaves them, in exact fp32: RepVGG's over the 2P frames, the fusion's
    over the P pairs' post-transformer maps, each layer normalised with
    its own statistics before the next one is measured."""
    with exact_fp32():
        coarse, quarter, half = backbone(
            FP32, W, cfg, torch.cat([image0, image1])[:, None].float(),
            _measured_norm)
        n = len(image0)
        order = [j for i in range(n) for j in (i, n + i)]
        maps = [m for i in range(n)
                for m in transformer(FP32, W, cfg, coarse[i], coarse[n + i])]
        fusion(FP32, W, torch.stack(maps), quarter[order], half[order],
               _measured_norm)


def seeded_weights(cfg, seed: int, image0, image1) -> dict:
    """`seeded_tree(cfg, seed)` with its BatchNorm statistics set by
    `calibrate` on the pairs (image0, image1), each (P, F, F) on the
    device to compute on; the tree's leaves on the CPU."""
    tree = seeded_tree(cfg, seed)
    W = {k: _convert(v, image0.device) for k, v in tree.items()}
    calibrate(W, cfg, image0, image1)

    def to_cpu(t):
        return ({k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict)
                else t.cpu())

    tree["batch_stats"] = to_cpu(W["batch_stats"])
    return tree
