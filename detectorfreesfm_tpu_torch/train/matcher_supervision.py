"""Coarse-matching ground truth: depth-warped cell assignment for a pair.

Port of the JAX package's train/matcher_supervision.py: each 8-px grid
point of image0 with valid depth warps into image1; the nearest grid cell
of its landing point is the positive column of that row of the
dual-softmax matrix, and rows that fail the depth, cycle or border checks
get -1. The continuous landing point is the fine stage's target. Float32
with TF32 off, on the device of the inputs.
"""

from __future__ import annotations

import torch

from ..core.geometry import quat_to_rotmat
from ..core.precision import geometry_precision
from .supervision import _bilinear_depth


def _reproject(xy, d, Ka, Ra, ta, Kb, Rb, tb):
    """Pixels xy of view a with depths d -> (camera-b points, pixels)."""
    xy_n = (xy - torch.stack([Ka[0, 2], Ka[1, 2]])) / torch.stack(
        [Ka[0, 0], Ka[1, 1]])
    Xa = torch.cat([xy_n * d[:, None], d[:, None]], -1)
    Xw = torch.einsum("lj,jk->lk", Xa - ta, Ra)
    Xb = torch.einsum("lj,kj->lk", Xw, Rb) + tb
    z = Xb[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uv = Xb[..., :2] / z_safe[..., None] * torch.stack(
        [Kb[0, 0], Kb[1, 1]]) + torch.stack([Kb[0, 2], Kb[1, 2]])
    return Xb, uv


def pair_cell_assignment(depth0, depth1, K0, K1, q0, t0, q1, t1,
                         grid: int = 8, depth_consistency: float = 0.05,
                         cycle_thr_px: float = 4.0):
    """(H, W) depths, (3, 3) intrinsics, world->cam (q, t) of both views.
    Returns gt (L,) int32, for each image0 grid point (row-major on the
    1/grid grid) the image1 cell of its warp or -1, and uv1 (L, 2), the
    warp itself (0 where gt is -1)."""
    with geometry_precision():
        depth0, depth1 = depth0.float(), depth1.float()
        K0, K1, q0, t0, q1, t1 = (a.float() for a in (K0, K1, q0, t0, q1, t1))
        dev = depth0.device
        h, w = depth0.shape
        h8, w8 = h // grid, w // grid
        # The grid points the matcher reports (cell * grid), not centres.
        ys = torch.arange(h8, dtype=torch.float32, device=dev) * grid
        xs = torch.arange(w8, dtype=torch.float32, device=dev) * grid
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts = torch.stack([gx, gy], -1).reshape(-1, 2)

        d0 = _bilinear_depth(depth0, pts)
        ok = d0 > 1e-6
        R0, R1 = quat_to_rotmat(q0), quat_to_rotmat(q1)
        Xc1, uv1 = _reproject(pts, d0, K0, R0, t0, K1, R1, t1)
        z1 = Xc1[..., 2]
        ok &= z1 > 1e-6
        ok &= ((uv1[..., 0] >= 0) & (uv1[..., 0] < w)
               & (uv1[..., 1] >= 0) & (uv1[..., 1] < h))
        d1 = _bilinear_depth(depth1, uv1)
        ok &= (d1 > 1e-6) & (torch.abs(d1 - z1) / torch.clamp_min(z1, 1e-9)
                             < depth_consistency)
        _, uv0b = _reproject(uv1, d1, K1, R1, t1, K0, R0, t0)
        ok &= torch.linalg.norm(uv0b - pts, dim=-1) < cycle_thr_px

        # The nearest grid point (floor(x / grid + 0.5)), as the fine
        # window is centred on it.
        cell_x = torch.clamp(torch.floor(uv1[..., 0] / grid + 0.5).long(),
                             0, w8 - 1)
        cell_y = torch.clamp(torch.floor(uv1[..., 1] / grid + 0.5).long(),
                             0, h8 - 1)
        gt = cell_y * w8 + cell_x
        return (torch.where(ok, gt, torch.full_like(gt, -1)).int(),
                torch.where(ok[:, None], uv1, torch.zeros_like(uv1)))
