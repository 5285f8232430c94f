"""Plain PyTorch forward of DetectorFreeSfM's multiview refinement matcher
(He et al., CVPR 2024): per track, a patch around each node, dilated by
the node's relative scale; S2DNet hypercolumn features (a VGG16 prefix
with 1x1 -> gelu -> 5x5 adapters at strides 1 and 4, the second upsampled
bilinearly and added); the central window of each patch through the
self/cross transformer (the reference node against all query nodes); the
reference centre's correlation with each query window under a softmax of
temperature 0.1, and its expectation as each query node's move.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .nn import gelu_tanh, soft_argmax, transformer


def patches(images, xy, img, size, scale):
    """(N, size, size) bilinear samples of images (I, H, W) on a unit grid
    dilated by `scale` around xy (N, 2) (x, y) of image `img` (N,). The
    lower corner is clipped to the image, the upper one is clip(lower + 1),
    the weights come from the unclipped coordinate."""
    _, h, w = images.shape
    offs = torch.arange(size, dtype=torch.float32, device=xy.device) - \
        (size - 1) / 2.0
    ys = (xy[:, 1:2] + offs * scale[:, None])[:, :, None].expand(-1, size,
                                                                 size)
    xs = (xy[:, 0:1] + offs * scale[:, None])[:, None, :].expand(-1, size,
                                                                 size)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0 = y0.long().clamp(0, h - 1)
    x0 = x0.long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    i = img.long()[:, None, None]
    g = lambda yy, xx: images[i, yy, xx]  # noqa: E731
    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _pool(x):
    """3x3 / 2 max pool with flax's SAME padding (the extra pad at the
    end)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), 3, 2)


def s2dnet(pr, p, x):
    """(N, 1, P, P) -> (N, 128, P, P)."""
    def conv(name, t):
        k = p[name]["kernel"]
        return pr.conv(t, k, p[name]["bias"], 1, k.shape[-1] // 2)

    h, w = x.shape[-2:]
    y = F.relu(conv("conv1_1", x))
    hyper1 = F.relu(conv("conv1_2", y))
    y = _pool(hyper1)
    y = F.relu(conv("conv2_2", F.relu(conv("conv2_1", y))))
    y = _pool(y)
    y = F.relu(conv("conv3_2", F.relu(conv("conv3_1", y))))
    hyper3 = F.relu(conv("conv3_3", y))
    a1 = conv("adap1_5x5", gelu_tanh(conv("adap1_1x1", hyper1)))
    a3 = conv("adap3_5x5", gelu_tanh(conv("adap3_1x1", hyper3)))
    return a1 + F.interpolate(a3, size=(h, w), mode="bilinear",
                              align_corners=False)


def l2n(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def refine(pr, W, cfg, images, node_img, node_xy, node_scale, node_mask,
           window):
    """Refined (T, V, 2) node coordinates. images (I, H, W) in [0, 1];
    node_* (T, V) with node 0 the track's reference; masked nodes and the
    reference keep their coordinates."""
    t, v = node_img.shape
    crop = window + cfg["crop_extra"]
    p = W["params"]
    x = patches(images, node_xy.reshape(-1, 2), node_img.reshape(-1), crop,
                node_scale.reshape(-1))
    f = s2dnet(pr, p["backbone"], x[:, None])
    off = (crop - window) // 2
    f = f[:, :, off:off + window, off:off + window]
    c, w2 = f.shape[1], window * window
    f = f.permute(0, 2, 3, 1).reshape(t, v, w2, c)
    ref, qry = f[:, 0], f[:, 1:].reshape(t, (v - 1) * w2, c)
    ref_mask = node_mask[:, :1].expand(t, w2)
    qry_mask = node_mask[:, 1:].repeat_interleave(w2, 1)
    ref, qry = transformer(pr, p["transformer"], ref, qry, ref_mask,
                           qry_mask, cfg["nhead"], 1.0 / w2,
                           1.0 / ((v - 1) * w2))
    qry = l2n(qry.reshape(t, v - 1, w2, c))
    center = l2n(ref[:, w2 // 2])
    sim = pr.einsum("tc,tqwc->tqw", center, qry)
    coords = soft_argmax(sim.reshape(t, v - 1, window, window) /
                         cfg["softmax_temperature"])
    delta = coords * ((window - 1) / 2.0) * node_scale[:, 1:, None]
    out = torch.cat([node_xy[:, :1], node_xy[:, 1:] + delta], 1)
    return torch.where(node_mask[..., None], out, node_xy)
