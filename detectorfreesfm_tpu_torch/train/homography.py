"""Homography self-supervision: random warps and their exact cell labels.

Port of the JAX package's train/homography.py: `random_homography` draws
rotation, anisotropic scale, translation and perspective about the image
centre (JAX's draws, utils/prng.py, from the same key), `warp_image`
inverse-warps bilinearly (0 outside the frame), and
`homography_cell_assignment` gives each source cell's target cell under H
(-1 where the warp leaves the frame), the labels of
`losses.coarse_focal_loss`. Float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.precision import geometry_precision
from ..device import resolve_device
from ..utils import prng


def random_homography(key, h: int, w: int, max_rotation: float = 0.35,
                      max_scale: float = 0.25, max_translation: float = 0.15,
                      max_perspective: float = 3e-4, device=None
                      ) -> torch.Tensor:
    """(3, 3) float32 homography mapping source pixels to warped pixels."""
    dev = resolve_device(device)
    k = prng.split(key, 5)
    ang = prng.uniform(k[0], (), -max_rotation, max_rotation, dev)
    sc = torch.exp(prng.uniform(k[1], (2,), -max_scale, max_scale, dev))
    tx = prng.uniform(k[2], (), -max_translation, max_translation, dev) * w
    ty = prng.uniform(k[3], (), -max_translation, max_translation, dev) * h
    p = prng.uniform(k[4], (2,), -max_perspective, max_perspective, dev)
    ca, sa = torch.cos(ang), torch.sin(ang)
    one = torch.ones((), device=dev)
    A = torch.stack([
        torch.stack([ca * sc[0], -sa * sc[0], tx]),
        torch.stack([sa * sc[1], ca * sc[1], ty]),
        torch.stack([p[0], p[1], one])])
    C = torch.tensor([[1.0, 0, -w / 2], [0, 1.0, -h / 2], [0, 0, 1.0]],
                     device=dev)
    Ci = torch.tensor([[1.0, 0, w / 2], [0, 1.0, h / 2], [0, 0, 1.0]],
                      device=dev)
    with geometry_precision():
        return Ci @ A @ C


def warp_image(img: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Inverse-warp an (H, W) or (H, W, 1) image by H (src -> dst):
    out(dst) = img(H^-1 dst), bilinear; samples outside the frame are 0."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    dev = img.device
    with geometry_precision():
        Hi = torch.linalg.inv(H)
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        src = torch.einsum("ij,jhw->ihw", Hi,
                           torch.stack([gx, gy, torch.ones_like(gx)]))
    den = torch.where(torch.abs(src[2]) < 1e-9,
                      torch.full_like(src[2], 1e-9), src[2])
    sx, sy = src[0] / den, src[1] / den
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    inside = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1))[..., None]
    x0i = torch.clamp(x0.long(), 0, w - 1)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    out = ((img[y0i, x0i] * (1 - wx) + img[y0i, x1i] * wx) * (1 - wy)
           + (img[y1i, x0i] * (1 - wx) + img[y1i, x1i] * wx) * wy)
    out = torch.where(inside, out, torch.zeros((), device=dev))
    return out[..., 0] if squeeze else out


def homography_cell_assignment(H: torch.Tensor, h: int, w: int,
                               grid: int = 8) -> torch.Tensor:
    """(L,) int32: each source cell centre's target cell under H
    (row-major on the 1/grid grid), or -1 where it leaves the frame."""
    dev = H.device
    h8, w8 = h // grid, w // grid
    ys = (torch.arange(h8, dtype=torch.float32, device=dev) + 0.5) * grid
    xs = (torch.arange(w8, dtype=torch.float32, device=dev) + 0.5) * grid
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones(h8 * w8, device=dev)])
    with geometry_precision():
        dst = H @ pts
    z = torch.where(torch.abs(dst[2]) < 1e-9, torch.full_like(dst[2], 1e-9),
                    dst[2])
    dx, dy = dst[0] / z, dst[1] / z
    ok = (dx >= 0) & (dx < w) & (dy >= 0) & (dy < h)
    cell = (torch.clamp(torch.floor(dy / grid).long(), 0, h8 - 1) * w8
            + torch.clamp(torch.floor(dx / grid).long(), 0, w8 - 1))
    return torch.where(ok, cell, torch.full_like(cell, -1)).int()


def make_selfsup_batch(images, rng, device=None):
    """images (B, H, W) -> dict(image0, image1, gt) with a random
    homography per item; gt (B, L) int32 for coarse_focal_loss."""
    dev = resolve_device(device)
    images = torch.as_tensor(np.asarray(images), device=dev)
    b, h, w = images.shape
    keys = prng.split(rng, b)
    Hs = [random_homography(k, h, w, device=dev) for k in keys]
    warped = torch.stack([warp_image(images[i], Hs[i]) for i in range(b)])
    gt = torch.stack([homography_cell_assignment(H, h, w) for H in Hs])
    return {"image0": images[..., None], "image1": warped[..., None],
            "gt": gt}
