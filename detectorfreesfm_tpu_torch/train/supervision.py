"""On-the-fly ground-truth tracks by depth warping.

Port of the JAX package's train/supervision.py: 8-px grid points of the
reference view are unprojected with its depth, warped into every other
view, and kept where they pass the depth-consistency, cycle-reprojection
and border checks; tracks seen in at least V - tolerance views are drawn
to a fixed count, and the input points are perturbed (grid rounding, pixel
jitter, scale jitter) so that the refiner learns to undo coarse-matching
noise.

The draws are JAX's (utils/prng.py) from the same key, and the top-k of
the random scores breaks ties (every ineligible candidate scores -1)
toward the lower index as `lax.top_k` does, by a stable descending sort.
The warps run in float32 with TF32 off, in place of JAX's
`Precision.HIGHEST`, on the device of the inputs.

One deliberate difference: the reference view's own warp is the grid
itself, exactly. JAX computes it through the round trip, and its float32
noise decides how each reference input rounds to the grid (every grid
point is a k + 0.5 tie), so no port can agree with it there bit for bit;
the two round the same tracks to neighbouring grid points 8 px apart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.geometry import quat_to_rotmat
from ..core.precision import geometry_precision
from ..utils import prng


class SupervisionBatch(NamedTuple):
    """Refiner inputs + targets for one image tuple (track dim T)."""

    node_img: torch.Tensor    # (T, V) int32, view index (0 = reference)
    node_xy: torch.Tensor     # (T, V, 2) perturbed input coordinates
    node_scale: torch.Tensor  # (T, V) relative scale (f/depth ratio)
    node_mask: torch.Tensor   # (T, V) bool
    gt_xy: torch.Tensor       # (T, V, 2) ground-truth warped coordinates
    track_valid: torch.Tensor  # (T,) bool, live (non-padded) tracks


def _bilinear_depth(depth, xy):
    """Sample (H, W) depth at (..., 2) float coords; 0 = invalid. Where a
    neighbour is 0 the nearest-neighbour depth is taken instead."""
    h, w = depth.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = x - x0
    wy = y - y0
    d00, d01 = depth[y0, x0], depth[y0, x1]
    d10, d11 = depth[y1, x0], depth[y1, x1]
    bil = ((d00 * (1 - wx) + d01 * wx) * (1 - wy)
           + (d10 * (1 - wx) + d11 * wx) * wy)
    nn = depth[torch.clamp(torch.round(y).long(), 0, h - 1),
               torch.clamp(torch.round(x).long(), 0, w - 1)]
    any_zero = (d00 <= 0) | (d01 <= 0) | (d10 <= 0) | (d11 <= 0)
    return torch.where(any_zero, nn, bil)


def stable_top_k(score, k: int):
    """Indices of the k largest scores, ties to the lower index (as
    `lax.top_k`)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _pixels(X, K):
    """Camera points (..., 3) of one view -> pixels with K (3, 3)."""
    z = X[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uv = X[..., :2] / z_safe[..., None]
    return torch.stack([uv[..., 0] * K[0, 0] + K[0, 2],
                        uv[..., 1] * K[1, 1] + K[1, 2]], -1)


def generate_tracks(depths, K, qvec, tvec, rng, grid_step: int = 8,
                    n_tracks: int = 200, visibility_tolerance: int = 3,
                    depth_consistency: float = 0.05,
                    cycle_thr_px: float = 3.0, border: int = 8,
                    jitter_px: float = 2.0, scale_jitter: float = 0.2
                    ) -> SupervisionBatch:
    """depths (V, H, W) (0 = no depth), K (V, 3, 3), qvec (V, 4) and tvec
    (V, 3) world->cam, float32 tensors on one device; rng a raw uint32[2]
    key. View 0 is the reference; returns n_tracks padded tracks."""
    with geometry_precision():
        return _generate_tracks(
            depths.float(), K.float(), qvec.float(), tvec.float(), rng,
            grid_step, n_tracks, visibility_tolerance, depth_consistency,
            cycle_thr_px, border, jitter_px, scale_jitter)


def _generate_tracks(depths, K, qvec, tvec, rng, grid_step, n_tracks,
                     visibility_tolerance, depth_consistency, cycle_thr_px,
                     border, jitter_px, scale_jitter):
    dev = depths.device
    v, h, w = depths.shape
    R = quat_to_rotmat(qvec)
    Rt = R.transpose(-1, -2)

    gy = torch.arange(grid_step // 2, h - grid_step // 2 + 1, grid_step,
                      device=dev)
    gx = torch.arange(grid_step // 2, w - grid_step // 2 + 1, grid_step,
                      device=dev)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    pts0 = torch.stack([gxx, gyy], -1).reshape(-1, 2).float()   # (G, 2)
    g = pts0.shape[0]

    d0 = _bilinear_depth(depths[0], pts0)
    has_depth = d0 > 1e-6

    K0 = K[0]
    c0 = torch.stack([K0[0, 2], K0[1, 2]])
    f0 = torch.stack([K0[0, 0], K0[1, 1]])
    xy_n = (pts0 - c0) / f0
    X_cam0 = torch.cat([xy_n * d0[:, None], d0[:, None]], -1)
    X_w = torch.einsum("gj,jk->gk", X_cam0 - tvec[0], R[0])

    Xc = torch.einsum("vij,gj->vgi", R, X_w) + tvec[:, None, :]  # (V, G, 3)
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uv = Xc[..., :2] / z_safe[..., None]
    fx, fy = K[:, 0, 0][:, None], K[:, 1, 1][:, None]
    cx, cy = K[:, 0, 2][:, None], K[:, 1, 2][:, None]
    px = torch.stack([uv[..., 0] * fx + cx, uv[..., 1] * fy + cy], -1)
    # View 0 onto itself is the grid, exactly. Its points sit on the
    # rounding ties of the reference input below (4 + 8k -> k + 0.5), so
    # JAX's float32 noise in this identity warp decides how each rounds;
    # the port takes the exact value, and round-half-even decides.
    px[0] = pts0

    in_border = ((px[..., 0] >= border) & (px[..., 0] < w - border)
                 & (px[..., 1] >= border) & (px[..., 1] < h - border))
    d_sampled = torch.stack([_bilinear_depth(depths[i], px[i])
                             for i in range(v)])
    depth_ok = ((d_sampled > 1e-6) & (torch.abs(d_sampled - z)
                                      / torch.clamp_min(z, 1e-9)
                                      < depth_consistency))
    # Cycle: unproject with the sampled depth, reproject into view 0.
    xy_src = (px - torch.stack([cx, cy], -1)) / torch.stack([fx, fy], -1)
    Xc_src = torch.cat([xy_src * d_sampled[..., None], d_sampled[..., None]],
                       -1)
    X_w2 = torch.einsum("vij,vgj->vgi", Rt, Xc_src - tvec[:, None, :])
    Xc0 = torch.einsum("ij,vgj->vgi", R[0], X_w2) + tvec[0]
    z0b = torch.where(torch.abs(Xc0[..., 2]) < 1e-9,
                      torch.full_like(Xc0[..., 2], 1e-9), Xc0[..., 2])
    px0 = Xc0[..., :2] / z0b[..., None] * f0 + c0
    cycle_ok = torch.linalg.norm(px0 - pts0[None], dim=-1) < cycle_thr_px

    visible = in_border & depth_ok & cycle_ok & (z > 1e-6) & has_depth[None]
    visible[0] = has_depth                        # ref always "visible"

    vis_count = torch.sum(visible.int(), dim=0)
    ok = vis_count >= max(v - visibility_tolerance, 2)
    r_sel, r_j0, r_j1, r_sc, r_grid = prng.split(rng, 5)
    score = torch.where(ok, prng.uniform(r_sel, (g,), device=dev),
                        torch.full((g,), -1.0, device=dev))
    k = min(n_tracks, g)
    sel = stable_top_k(score, k)
    if k < n_tracks:
        sel = torch.cat([sel, sel.new_zeros(n_tracks - k)])
    track_valid = (score[sel] > 0.0) & (
        torch.arange(n_tracks, device=dev) < k)

    vis_sel = visible[:, sel].T                              # (T, V)
    gt = px[:, sel].transpose(0, 1)                          # (T, V, 2)

    ref_gt = gt[:, 0]
    ref_in = (torch.round(ref_gt / grid_step) * grid_step
              + prng.uniform(r_grid, ref_gt.shape, -1.0, 1.0, device=dev))
    q_in = gt[:, 1:] + prng.uniform(r_j0, gt[:, 1:].shape, -jitter_px,
                                    jitter_px, device=dev)
    node_xy = torch.cat([ref_in[:, None], q_in], 1)

    f_mean = (K[:, 0, 0] + K[:, 1, 1]) * 0.5
    depth_nodes = torch.clamp_min(z[:, sel].transpose(0, 1), 1e-6)
    s = f_mean[None, :] / depth_nodes
    rel = s / torch.clamp_min(s[:, 0:1], 1e-9)
    rel = rel * torch.exp(prng.uniform(r_sc, rel.shape, -scale_jitter,
                                       scale_jitter, device=dev))
    rel[:, 0] = 1.0

    node_img = torch.arange(v, dtype=torch.int32, device=dev)[None].expand(
        n_tracks, v)
    return SupervisionBatch(
        node_img=node_img, node_xy=node_xy.float(), node_scale=rel.float(),
        node_mask=vis_sel & track_valid[:, None], gt_xy=gt.float(),
        track_valid=track_valid)
