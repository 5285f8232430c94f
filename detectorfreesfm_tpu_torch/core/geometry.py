"""Core geometry: quaternions, SE(3), camera models, projection.

Port of the JAX package's core/geometry.py. Conventions (COLMAP):
  * Quaternions are (w, x, y, z), unit norm.
  * A pose (qvec, tvec) is world-to-camera:  x_cam = R(qvec) @ x_world + tvec.
  * Pixel coordinates follow COLMAP: the center of the top-left pixel is
    (0.5, 0.5).

The torch functions are batched over leading dims and run on the device of
their inputs, in the inputs' dtype. The `np_*` helpers are numpy copies for
host loops (mapper bookkeeping, COLMAP export).
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize to unit quaternion, keeping w >= 0 for canonical form."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)
    return torch.where(q[..., :1] < 0.0, -q, q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (..., 4) in (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def np_quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Pure-numpy (..., 4) wxyz -> (..., 3, 3), for host loops."""
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-15)
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def np_rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Pure-numpy (..., 3, 3) -> (..., 4) wxyz, the same branch-free
    Shepperd method as rotmat_to_quat."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    m01, m02, m10, m12, m20, m21 = (
        R[..., 0, 1], R[..., 0, 2], R[..., 1, 0],
        R[..., 1, 2], R[..., 2, 0], R[..., 2, 1],
    )
    tr = m00 + m11 + m22
    s = lambda x: np.sqrt(np.maximum(x, 1e-24))  # noqa: E731
    s0 = s(1.0 + tr)
    s1 = s(1.0 + m00 - m11 - m22)
    s2 = s(1.0 - m00 + m11 - m22)
    s3 = s(1.0 - m00 - m11 + m22)
    cands = np.stack([
        np.stack([s0 * s0, m21 - m12, m02 - m20, m10 - m01], axis=-1),
        np.stack([m21 - m12, s1 * s1, m01 + m10, m02 + m20], axis=-1),
        np.stack([m02 - m20, m01 + m10, s2 * s2, m12 + m21], axis=-1),
        np.stack([m10 - m01, m02 + m20, m12 + m21, s3 * s3], axis=-1),
    ], axis=-2)
    scores = np.stack([tr, m00, m11, m22], axis=-1)
    idx = np.argmax(scores, axis=-1)
    q = np.take_along_axis(cands, idx[..., None, None], axis=-2)[..., 0, :]
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-15)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion.

    Branch-free Shepperd's method: all four candidate quaternions, and the
    one seeded from the largest diagonal combination is kept (stable for
    any rotation, near pi included; argmax takes the first of ties, as
    jnp.argmax does)."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    m01, m02, m10, m12, m20, m21 = (
        R[..., 0, 1], R[..., 0, 2], R[..., 1, 0],
        R[..., 1, 2], R[..., 2, 0], R[..., 2, 1],
    )
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp_min(1e-24))

    s0 = safe_sqrt(1.0 + tr)
    q0 = torch.stack([s0 * s0, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([m21 - m12, s1 * s1, m01 + m10, m02 + m20], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([m02 - m20, m01 + m10, s2 * s2, m12 + m21], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, s3 * s3], dim=-1)

    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4cand, 4)
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE(3) as (qvec, tvec) pairs
# ---------------------------------------------------------------------------


def se3_apply(qvec, tvec, pts):
    """Apply world-to-camera transform to (..., N, 3) points."""
    R = quat_to_rotmat(qvec)
    return torch.einsum("...ij,...nj->...ni", R, pts) + tvec[..., None, :]


def se3_inverse(qvec, tvec):
    """Inverse transform: returns (qvec_inv, tvec_inv)."""
    q_inv = quat_conjugate(quat_normalize(qvec))
    R_inv = quat_to_rotmat(q_inv)
    t_inv = -torch.einsum("...ij,...j->...i", R_inv, tvec)
    return q_inv, t_inv


def se3_compose(qa, ta, qb, tb):
    """Compose: (qa, ta) ∘ (qb, tb), i.e. apply b first then a."""
    q = quat_multiply(qa, qb)
    Ra = quat_to_rotmat(qa)
    t = torch.einsum("...ij,...j->...i", Ra, tb) + ta
    return quat_normalize(q), t


def camera_center(qvec, tvec):
    """Camera center in world coordinates: C = -R^T t."""
    R = quat_to_rotmat(qvec)
    return -torch.einsum("...ji,...j->...i", R, tvec)


# --- so(3) exp / log (used by BA parameterization) -------------------------


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix.

    Written on the unnormalized skew matrix W with Taylor fallbacks near
    θ=0, so it is differentiable everywhere (BA/PnP take jacfwd at w=0);
    the unselected branch sees a substituted safe θ."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta_safe) / theta_safe)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    W = torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero],
                    dim=-1).reshape(w.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A * W + B * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle (..., 3)."""
    tr = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5).clamp(
        -1.0, 1.0)
    theta = torch.arccos(tr)
    w_raw = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    scale = torch.where(theta < 1e-6, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.sin(theta)).clamp_min(1e-12))
    w = w_raw * scale[..., None]
    # Near pi the anti-symmetric part vanishes: use the quaternion route.
    q = rotmat_to_quat(R)
    qv = q[..., 1:]
    qn = torch.linalg.norm(qv, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(qn[..., 0], q[..., 0])
    w_quat = qv / qn.clamp_min(1e-12) * angle[..., None]
    return torch.where((theta > 3.0)[..., None], w_quat, w)


# ---------------------------------------------------------------------------
# Camera models & projection
# ---------------------------------------------------------------------------

# COLMAP camera model ids (format spec).
SIMPLE_PINHOLE = 0  # f, cx, cy
PINHOLE = 1         # fx, fy, cx, cy
SIMPLE_RADIAL = 2   # f, cx, cy, k
RADIAL = 3          # f, cx, cy, k1, k2
OPENCV = 4          # fx, fy, cx, cy, k1, k2, p1, p2

CAMERA_MODEL_NUM_PARAMS = {
    0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12,
}
CAMERA_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}
CAMERA_MODEL_IDS = {v: k for k, v in CAMERA_MODEL_NAMES.items()}


def intrinsics_to_K(fx, fy, cx, cy) -> torch.Tensor:
    """Build (..., 3, 3) K from focal/principal-point tensors."""
    fx, fy, cx, cy = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=torch.get_default_dtype())
        if not isinstance(v, torch.Tensor) else v
        for v in (fx, fy, cx, cy)))
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack([fx, zero, cx, zero, fy, cy, zero, zero, one],
                       dim=-1).reshape(fx.shape + (3, 3))


def project(pts_w, qvec, tvec, K, eps: float = 1e-8):
    """Project (..., N, 3) world points into a pinhole camera.

    Returns uv (..., N, 2) pixel coordinates and depth (..., N)."""
    pts_c = se3_apply(qvec, tvec, pts_w)
    depth = pts_c[..., 2]
    z = torch.where(depth.abs() < eps,
                    torch.where(depth < 0, -eps, eps).to(depth.dtype), depth)
    xy = pts_c[..., :2] / z[..., None]
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    uv = torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)
    return uv, depth


def unproject(uv, depth, K):
    """Pixel + depth -> camera-frame 3D points. uv (..., N, 2), depth (..., N)."""
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def relative_pose(qa, ta, qb, tb):
    """Relative pose taking camera-a frame to camera-b frame: T_b ∘ T_a^-1."""
    qai, tai = se3_inverse(qa, ta)
    return se3_compose(qb, tb, qai, tai)


def rotation_angle_deg(R, eps: float = 1e-7):
    """Geodesic rotation angle of (..., 3, 3) in degrees."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = ((tr - 1.0) * 0.5).clamp(-1.0 + eps, 1.0 - eps)
    return torch.rad2deg(torch.arccos(cos))


def translation_angle_deg(t_a, t_b, eps: float = 1e-10):
    """Angle between translation directions in degrees, sign-invariant."""
    na = torch.linalg.norm(t_a, dim=-1)
    nb = torch.linalg.norm(t_b, dim=-1)
    cos = torch.sum(t_a * t_b, dim=-1) / (na * nb).clamp_min(eps)
    cos = cos.abs().clamp(0.0, 1.0 - 1e-7)
    ang = torch.rad2deg(torch.arccos(cos))
    both_zero = (na < eps) & (nb < eps)
    return torch.where(both_zero, torch.zeros_like(ang), ang)


# -- radial distortion (SIMPLE_RADIAL, COLMAP model id 2) ---------------------
# Forward model on normalized coords: x_d = x_u * (1 + k1 * r_u^2).


def np_radial_distort(xn: np.ndarray, k1: float) -> np.ndarray:
    """Distort normalized coords (..., 2): x_d = x_u (1 + k1 |x_u|^2)."""
    r2 = np.sum(xn * xn, axis=-1, keepdims=True)
    return xn * (1.0 + k1 * r2)


def np_radial_undistort(xd: np.ndarray, k1: float,
                        iters: int = 10) -> np.ndarray:
    """Invert the SIMPLE_RADIAL model by fixed-point iteration
    x <- x_d / (1 + k1 |x|^2)."""
    if k1 == 0.0:
        return xd
    x = xd.copy()
    for _ in range(iters):
        r2 = np.sum(x * x, axis=-1, keepdims=True)
        x = xd / (1.0 + k1 * r2)
    return x


def np_undistort_pixels(uv: np.ndarray, K: np.ndarray,
                        k1: float) -> np.ndarray:
    """Undistort pixel observations through K (pinhole uv out)."""
    if k1 == 0.0:
        return uv
    f = np.array([K[0, 0], K[1, 1]])
    c = np.array([K[0, 2], K[1, 2]])
    return np_radial_undistort((uv - c) / f, k1) * f + c


def np_distort_pixels(uv: np.ndarray, K: np.ndarray,
                      k1: float) -> np.ndarray:
    """Distort ideal pinhole pixels through K (observed-space uv out)."""
    if k1 == 0.0:
        return uv
    f = np.array([K[0, 0], K[1, 1]])
    c = np.array([K[0, 2], K[1, 2]])
    return np_radial_distort((uv - c) / f, k1) * f + c
