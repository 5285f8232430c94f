"""Epipolar geometry: essential/fundamental matrices, residuals,
decomposition. Port of the JAX package's core/epipolar.py; batched torch
on the device of the inputs."""

from __future__ import annotations

import torch

from .geometry import quat_to_rotmat


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def essential_from_pose(qvec_rel, tvec_rel):
    """E = [t]_x R for the relative pose taking frame a to frame b."""
    return skew(tvec_rel) @ quat_to_rotmat(qvec_rel)


def fundamental_from_essential(E, K0, K1):
    """F = K1^-T E K0^-1."""
    K0i = torch.linalg.inv(K0)
    K1i = torch.linalg.inv(K1)
    return K1i.transpose(-1, -2) @ E @ K0i


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_distance(F, x0, x1, eps=1e-12):
    """First-order geometric epipolar error: F (..., 3, 3), x0/x1 (..., N, 2)
    (x1^T F x0 = 0) -> (..., N) squared Sampson distance."""
    p0 = _homogeneous(x0)
    p1 = _homogeneous(x1)
    Fx0 = torch.einsum("...ij,...nj->...ni", F, p0)
    Ftx1 = torch.einsum("...ji,...nj->...ni", F, p1)
    num = torch.einsum("...ni,...ni->...n", p1, Fx0) ** 2
    den = (Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2
           + Ftx1[..., 1] ** 2)
    return num / den.clamp_min(eps)


def symmetric_epipolar_distance(F, x0, x1, eps=1e-12):
    """Sum of squared point-to-epipolar-line distances in both images."""
    p0 = _homogeneous(x0)
    p1 = _homogeneous(x1)
    Fx0 = torch.einsum("...ij,...nj->...ni", F, p0)
    Ftx1 = torch.einsum("...ji,...nj->...ni", F, p1)
    d = torch.einsum("...ni,...ni->...n", p1, Fx0) ** 2
    return d * (1.0 / (Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2).clamp_min(eps)
                + 1.0 / (Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2).clamp_min(eps))


def decompose_essential(E):
    """E -> 4 candidate (R, t) pairs via SVD.

    Returns R: (..., 4, 3, 3), t: (..., 4, 3) with unit-norm t. The SVD's
    signs are backend-specific; the candidate SET does not depend on them."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * torch.where(torch.linalg.det(Vt) < 0, -1.0, 1.0)[..., None,
                                                                None]
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    R = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return R, ts


def triangulate_midpoint_depths(R, t, x0n, x1n, eps=1e-9):
    """Two-view depths (z0, z1) of normalized correspondences (..., N, 2)
    under frame 1 = (R, t), frame 0 = identity, by the linear two-ray
    least squares along the bearings (cheirality voting)."""
    d0 = _homogeneous(x0n)
    d1 = _homogeneous(x1n)
    d1w = torch.einsum("...ji,...nj->...ni", R, d1)
    c1 = -torch.einsum("...ji,...j->...i", R, t)[..., None, :]
    a = torch.sum(d0 * d0, dim=-1)
    b = -torch.sum(d0 * d1w, dim=-1)
    c = torch.sum(d1w * d1w, dim=-1)
    rhs0 = torch.sum(d0 * c1, dim=-1)
    rhs1 = -torch.sum(d1w * c1, dim=-1)
    det = a * c - b * b
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    z0 = (c * rhs0 - b * rhs1) / det
    z1w = (a * rhs1 - b * rhs0) / det
    return z0, z1w
