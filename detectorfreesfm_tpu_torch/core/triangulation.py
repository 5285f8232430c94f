"""Multi-view triangulation (DLT) with masked views.

Port of the JAX package's core/triangulation.py: all tracks are
triangulated in one batched, fixed-shape call; tracks shorter than the
widest are padded and masked, so a scene's triangulation is one einsum and
one batched 4x4 eigendecomposition.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .geometry import quat_to_rotmat
from .precision import as_tensor, eigh, geometry_precision


def projection_matrices(qvec, tvec, K):
    """(..., 4)/(..., 3)/(..., 3, 3) -> (..., 3, 4) P = K [R | t]."""
    R = quat_to_rotmat(qvec)
    return K @ torch.cat([R, tvec[..., :, None]], dim=-1)


@geometry_precision()
def triangulate_dlt(P, uv, mask=None, eps: float = 1e-12, device=None):
    """Batched DLT triangulation.

    Args:
      P:    (..., V, 3, 4) per-view projection matrices.
      uv:   (..., V, 2) observed pixels per view.
      mask: (..., V) bool validity; padded views contribute zero rows.
      device: where it runs (None means CUDA); numpy inputs are moved there.

    Returns X (..., 3) world points and ok (...,) bool: the solution is
    finite and its homogeneous w is not ~0.

    Solves min ||A x|| by the eigenvector of the smallest eigenvalue of the
    4x4 normal matrix A^T A. The eigenvector's sign is backend-specific;
    X = x[:3] / x[3] does not depend on it.
    """
    dev = resolve_device(device)
    P = as_tensor(P, dev, torch.float32)
    uv = as_tensor(uv, dev, torch.float32)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r0 = u * P[..., 2, :] - P[..., 0, :]  # (..., V, 4)
    r1 = v * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([r0, r1], dim=-2)  # (..., 2V, 4)
    if mask is not None:
        m = as_tensor(mask, dev)
        A = A * torch.cat([m, m], dim=-1).to(A.dtype)[..., None]
    # Row normalization improves conditioning for large pixel coords.
    A = A / torch.linalg.norm(A, dim=-1, keepdim=True).clamp_min(eps)
    AtA = torch.einsum("...vi,...vj->...ij", A, A)
    _w, V4 = eigh(AtA)
    x_h = V4[..., :, 0]  # eigenvector of the smallest eigenvalue
    wd = x_h[..., 3]
    w_safe = torch.where(wd.abs() < eps,
                         torch.where(wd < 0, -eps, eps).to(wd.dtype), wd)
    X = x_h[..., :3] / w_safe[..., None]
    ok = torch.isfinite(X).all(dim=-1) & (wd.abs() > eps)
    return X, ok


def reprojection_errors(X, P, uv, eps: float = 1e-8):
    """Pixel reprojection error per view. X (..., 3); P (..., V, 3, 4);
    uv (..., V, 2). Returns err (..., V) L2 pixel error and depth (..., V)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    proj = torch.einsum("...vij,...j->...vi", P, Xh)
    z = proj[..., 2]
    z_safe = torch.where(z.abs() < eps,
                         torch.where(z < 0, -eps, eps).to(z.dtype), z)
    xy = proj[..., :2] / z_safe[..., None]
    return torch.linalg.norm(xy - uv, dim=-1), z


def triangulation_angles_deg(X, centers, mask=None):
    """Max pairwise triangulation angle per point, in degrees.
    X (..., 3) points; centers (..., V, 3) camera centers."""
    rays = centers - X[..., None, :]
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(
        1e-12)
    cos = torch.einsum("...vi,...wi->...vw", rays, rays)
    if mask is not None:
        m = mask[..., :, None] & mask[..., None, :]
        cos = torch.where(m, cos, torch.ones_like(cos))
    v = cos.shape[-1]
    eye = torch.eye(v, dtype=torch.bool, device=cos.device)
    cos = torch.where(eye, torch.ones_like(cos), cos)
    ang = torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))
    return ang.amax(dim=(-2, -1))
