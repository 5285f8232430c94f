"""Soft-argmax (spatial expectation) with positional standard deviation.

Port of the JAX package's ops/dsnt.py: a softmax heatmap over a local
window is reduced to its expected (x, y) coordinate and the total std.
"""

from __future__ import annotations

import torch


def heatmap_softmax(scores, temperature: float = 1.0):
    """Softmax over the last two (spatial) dims, float32 internally."""
    shape = scores.shape
    flat = scores.reshape(shape[:-2] + (-1,)).float()
    return torch.softmax(flat / temperature, dim=-1).reshape(shape)


def normalized_grid(h: int, w: int, dtype=torch.float32, device=None):
    """Coordinate grids in [-1, 1] (x over width, y over height), each (h, w)."""
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


def _grids(heatmap, normalized: bool):
    h, w = heatmap.shape[-2:]
    gx, gy = normalized_grid(h, w, heatmap.dtype, heatmap.device)
    if not normalized:
        gx = (gx + 1.0) * 0.5 * (w - 1)
        gy = (gy + 1.0) * 0.5 * (h - 1)
    return gx, gy


def spatial_expectation2d(heatmap, normalized: bool = True):
    """Expected (x, y) of (..., H, W) probability maps -> (..., 2)."""
    gx, gy = _grids(heatmap, normalized)
    ex = (heatmap * gx).sum(dim=(-2, -1))
    ey = (heatmap * gy).sum(dim=(-2, -1))
    return torch.stack([ex, ey], dim=-1)


def spatial_expectation_with_std(heatmap, normalized: bool = True):
    """Expectation plus total std sqrt(Var[x] + Var[y])."""
    gx, gy = _grids(heatmap, normalized)
    ex = (heatmap * gx).sum(dim=(-2, -1))
    ey = (heatmap * gy).sum(dim=(-2, -1))
    ex2 = (heatmap * gx * gx).sum(dim=(-2, -1))
    ey2 = (heatmap * gy * gy).sum(dim=(-2, -1))
    var = (ex2 - ex * ex).clamp(min=0.0) + (ey2 - ey * ey).clamp(min=0.0)
    std = torch.sqrt(var + 1e-12)
    return torch.stack([ex, ey], dim=-1), std


def soft_argmax_refine(correlation, temperature: float = 1.0,
                       normalized: bool = True):
    """correlation (..., H, W) raw scores -> (coords (..., 2), std (...,))."""
    p = heatmap_softmax(correlation, temperature)
    return spatial_expectation_with_std(p, normalized=normalized)
