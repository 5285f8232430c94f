"""Crop-and-resize and fixed-size patch extraction by bilinear gathers.

Port of the JAX package's ops/roi_align.py. Sample coordinates of every
box or patch are materialized and the interpolation is four gathers from
one flat (B·H·W, C) view of the feature maps plus a weighted sum, so no
per-box copy of an image is ever made.

This is not `F.grid_sample`: the lower corner is clipped to the map, the
upper one is `clip(lower + 1)`, and the weights come from the unclipped
coordinate. Near the border neither of grid_sample's padding modes gives
these values.
"""

from __future__ import annotations

import torch


def _gather4(flat, base, ys, xs, h: int, w: int):
    """Bilinear samples of flat (B·H·W, C) maps at float coordinates ys,
    xs (N, oh, ow), from the image whose first row is `base` (N, 1, 1)."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    x0i = x0.to(torch.int64).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)

    def g(yi, xi):
        return flat[base + yi * w + xi]

    top = g(y0i, x0i) * (1 - wx) + g(y0i, x1i) * wx
    bot = g(y1i, x0i) * (1 - wx) + g(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def crop_and_resize(features, boxes, box_image_idx, out_size: tuple):
    """Crop boxes from a batch of feature maps and resize bilinearly.

    features (B, H, W, C); boxes (N, 4) as (x0, y0, x1, y1) in feature-map
    pixels; box_image_idx (N,); out_size (oh, ow). Edge samples land on the
    box corners (crop_and_resize corner semantics). Returns (N, oh, ow, C)."""
    oh, ow = out_size
    b, h, w, c = features.shape
    n = boxes.shape[0]
    boxes = boxes.to(torch.float32)
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    fy = torch.linspace(0.0, 1.0, oh, dtype=torch.float32,
                        device=boxes.device)
    fx = torch.linspace(0.0, 1.0, ow, dtype=torch.float32,
                        device=boxes.device)
    ys = y0[:, None] + fy[None, :] * (y1 - y0)[:, None]      # (N, oh)
    xs = x0[:, None] + fx[None, :] * (x1 - x0)[:, None]      # (N, ow)
    ys = ys[:, :, None].expand(n, oh, ow)
    xs = xs[:, None, :].expand(n, oh, ow)
    base = (box_image_idx.to(torch.int64) * (h * w))[:, None, None]
    return _gather4(features.reshape(b * h * w, c), base, ys, xs, h, w)


def extract_patches(features, centers, image_idx, patch_size: int,
                    scales=None):
    """Fixed-size windows centered at fractional points.

    The multiview refiner's crop: `patch_size` samples on a unit grid
    centered at each point, dilated per point by `scales`.

    features (B, H, W, C); centers (N, 2) as (x, y); image_idx (N,);
    scales optional (N,). Returns (N, patch_size, patch_size, C)."""
    n = centers.shape[0]
    b, h, w, c = features.shape
    dev = centers.device
    half = (patch_size - 1) / 2.0
    offs = torch.arange(patch_size, dtype=torch.float32, device=dev) - half
    step = (torch.ones(n, dtype=torch.float32, device=dev) if scales is None
            else scales.to(torch.float32))
    centers = centers.to(torch.float32)
    ys = centers[:, 1:2] + offs[None, :] * step[:, None]     # (N, P)
    xs = centers[:, 0:1] + offs[None, :] * step[:, None]
    ys = ys[:, :, None].expand(n, patch_size, patch_size)
    xs = xs[:, None, :].expand(n, patch_size, patch_size)
    base = (image_idx.to(torch.int64) * (h * w))[:, None, None]
    return _gather4(features.reshape(b * h * w, c), base, ys, xs, h, w)
