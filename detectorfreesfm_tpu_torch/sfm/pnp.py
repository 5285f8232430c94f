"""Absolute pose (PnP): batched P3P + 6-point DLT RANSAC with an annealed
Gauss-Newton local optimization.

Port of the JAX package's sfm/pnp.py. Hypotheses come from both minimal
families and share one consensus pass:
  * P3P (Grunert), its quartic solved by a fixed 60-iteration
    Durand-Kerner sweep in complex64, then Newton-polished;
  * the 6-point DLT (eigenvector of the 12x12 normal matrix).
As in twoview.py, the samples are the top-k of a Gumbel array the caller
passes (`utils.prng.gumbel`), and eigenvector signs are resolved from the
data (det > 0), so backend sign conventions do not reach the pose.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..core.geometry import quat_to_rotmat, rotmat_to_quat, so3_exp
from ..core.precision import as_tensor, geometry_precision
from ..device import resolve_device
from .twoview import _sample


class PnPResult(NamedTuple):
    qvec: torch.Tensor       # (..., 4) world->cam
    tvec: torch.Tensor       # (..., 3)
    inliers: torch.Tensor    # (..., N) bool
    n_inliers: torch.Tensor  # (...,) int32


def _guard(x, eps):
    """x with entries |x| < eps replaced by eps (JAX's where(|x|<e, e, x))."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def _dlt_pose(X, x, w):
    """Weighted DLT: (..., N, 3) world pts + (..., N, 2) normalized image
    coords -> (..., 3, 3) R, (..., 3) t (projected to SO(3))."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], dim=-1)  # (..., N, 12)
    r2 = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    p = vecs[..., :, 0].reshape(*X.shape[:-2], 3, 4)
    # The true P = s[R|t] (s > 0) has det(M) = s^3 > 0: fix the sign.
    sign = torch.sign(torch.linalg.det(p[..., :3]))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    p = p * sign[..., None, None]
    U, S, Vt = torch.linalg.svd(p[..., :3])
    R = U @ Vt
    scale = torch.sum(S, dim=-1) / 3.0
    t = p[..., 3] / scale[..., None].clamp_min(1e-12)
    return R, t


def _quartic_roots(coef, iters: int = 60):
    """Roots of c4 x^4 + ... + c0 (coef ascending (..., 5)) by
    Durand-Kerner in complex64: fixed iterations, branch-free. Returns
    (..., 4) complex roots."""
    lead = _guard(coef[..., 4:5], 1e-12)
    c = (coef / lead).to(torch.complex64)  # monic
    seed = torch.tensor([(0.4 + 0.9j) ** k for k in range(1, 5)],
                        dtype=torch.complex64, device=coef.device)
    z = seed.expand(*c.shape[:-1], 4).clone()
    eye = torch.eye(4, dtype=torch.complex64, device=coef.device)
    tiny = torch.tensor(1e-20, dtype=torch.complex64, device=coef.device)
    for _ in range(iters):
        p = torch.ones_like(z)
        for k in (3, 2, 1, 0):
            p = p * z + c[..., k:k + 1]
        d = z[..., :, None] - z[..., None, :] + eye
        denom = d[..., 0] * d[..., 1] * d[..., 2] * d[..., 3]
        denom = torch.where(denom.abs() < 1e-20, tiny, denom)
        z = z - p / denom
    return z


def _poly_mul(p, q, out_deg: int):
    """Coefficient convolution, ascending powers -> (..., out_deg+1)."""
    out = [torch.zeros_like(p[..., 0]) for _ in range(out_deg + 1)]
    for i in range(p.shape[-1]):
        for j in range(q.shape[-1]):
            if i + j <= out_deg:
                out[i + j] = out[i + j] + p[..., i] * q[..., j]
    return torch.stack(out, dim=-1)


def _eval(p, v):
    """Horner evaluation of ascending coefficients p (..., d+1) at v (..., 4)."""
    out = torch.zeros_like(v)
    for k in range(p.shape[-1] - 1, -1, -1):
        out = out * v + p[..., k:k + 1]
    return out


def _p3p_candidates(X, x):
    """Grunert P3P: (..., 3, 3) world points + (..., 3, 2) normalized image
    coords -> (R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4))."""
    f = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    f = f * torch.rsqrt(torch.sum(f * f, dim=-1, keepdim=True) + 1e-20)
    P1, P2, P3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]

    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    ca = torch.sum(f2 * f3, dim=-1)
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)

    b2s = torch.where(b2 < 1e-12, torch.full_like(b2, 1e-12), b2)
    A = (a2 - c2) / b2s
    # s2 = u s1, s3 = v s1; eliminating s1 and u leaves a quartic in v:
    #   E(v) = N^2 - 2 ca v N D + (v^2 - Q) D^2
    one = torch.ones_like(A)
    N = torch.stack([A + one, -2.0 * A * cb, A - one], dim=-1)
    D = torch.stack([2.0 * cg, -2.0 * ca], dim=-1)
    q_ = a2 / b2s
    VQ = torch.stack([-q_, 2.0 * q_ * cb, one - q_], dim=-1)
    ND = _poly_mul(N, D, 3)
    vND = torch.cat([torch.zeros_like(ND[..., :1]), ND], dim=-1)
    E = (_poly_mul(N, N, 4) - 2.0 * ca[..., None] * vND
         + _poly_mul(VQ, _poly_mul(D, D, 2), 4))

    roots = _quartic_roots(E)
    v = roots.real
    real_ok = roots.imag.abs() < 1e-4 * (1.0 + v.abs())

    # Newton-polish the (near-)real roots in real f32.
    dE = torch.stack([E[..., 1], 2.0 * E[..., 2], 3.0 * E[..., 3],
                      4.0 * E[..., 4]], dim=-1)
    for _ in range(3):
        v = v - _eval(E, v) / _guard(_eval(dE, v), 1e-12)

    u = _eval(N, v) / _guard(_eval(D, v), 1e-10)
    s1sq_den = 1.0 + v * v - 2.0 * v * cb[..., None]
    s1 = torch.sqrt(b2s[..., None] / torch.where(
        s1sq_den < 1e-12, torch.full_like(s1sq_den, 1e-12), s1sq_den))
    s2 = u * s1
    s3 = v * s1
    valid = (real_ok & (s1 > 1e-9) & (s2 > 1e-9) & (s3 > 1e-9)
             & (s1sq_den > 1e-12) & torch.isfinite(s1 + s2 + s3))

    # Newton-polish the depths on the law-of-cosines residuals.
    caa, cbb, cgg = ca[..., None], cb[..., None], cg[..., None]
    a2e, b2e, c2e = a2[..., None], b2s[..., None], c2[..., None]
    ridge = 1e-9 * torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(4):
        g = torch.stack([
            s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * caa - a2e,
            s1 * s1 + s3 * s3 - 2.0 * s1 * s3 * cbb - b2e,
            s1 * s1 + s2 * s2 - 2.0 * s1 * s2 * cgg - c2e,
        ], dim=-1)
        zero = torch.zeros_like(s1)
        J = torch.stack([
            torch.stack([zero, 2.0 * (s2 - s3 * caa),
                         2.0 * (s3 - s2 * caa)], dim=-1),
            torch.stack([2.0 * (s1 - s3 * cbb), zero,
                         2.0 * (s3 - s1 * cbb)], dim=-1),
            torch.stack([2.0 * (s1 - s2 * cgg),
                         2.0 * (s2 - s1 * cgg), zero], dim=-1),
        ], dim=-2)
        # solve_ex: a singular system gives a non-finite step (as in JAX),
        # not an exception, and no host sync.
        delta = torch.linalg.solve_ex(J + ridge, g[..., None])[0][..., 0]
        ok_step = torch.isfinite(delta).all(dim=-1)
        s1 = torch.where(ok_step, s1 - delta[..., 0], s1)
        s2 = torch.where(ok_step, s2 - delta[..., 1], s2)
        s3 = torch.where(ok_step, s3 - delta[..., 2], s3)
    valid = valid & (s1 > 1e-9) & (s2 > 1e-9) & (s3 > 1e-9)

    # Camera-frame points Y_i = s_i f_i; absolute orientation (Horn/SVD).
    Y = torch.stack([s1[..., None] * f1[..., None, :],
                     s2[..., None] * f2[..., None, :],
                     s3[..., None] * f3[..., None, :]], dim=-2)
    Pw = X[..., None, :, :].expand(Y.shape)
    Pc = Pw.mean(dim=-2, keepdim=True)
    Yc = Y.mean(dim=-2, keepdim=True)
    M = torch.einsum("...ni,...nj->...ij", Y - Yc, Pw - Pc)
    # Non-finite M (a bad root) would make the SVD raise: zero it; the
    # valid mask already rejects that candidate.
    M = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    U, _S, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    Dfix = torch.cat([torch.ones(*det.shape, 2, dtype=det.dtype,
                                 device=det.device), det[..., None]], dim=-1)
    R = U @ (Dfix[..., :, None] * Vt)
    t = Yc[..., 0, :] - torch.einsum("...ij,...j->...i", R, Pc[..., 0, :])
    return R, t, valid


def _reproj_err2(R, t, X, x):
    """Squared reprojection error in normalized coords; behind-camera points
    get +inf. R (..., 3, 3), t (..., 3), X/x (..., N, 3/2) -> (..., N)."""
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    uv = Xc[..., :2] / _guard(z[..., None], 1e-12)
    err = torch.sum((uv - x) ** 2, dim=-1)
    return torch.where(z > 1e-6, err, torch.full_like(err, float("inf")))


def _gn_residual(params, R, t, X, x):
    Rc = so3_exp(params[:3]) @ R
    Xc = X @ Rc.T + (t + params[3:])
    z = torch.where(Xc[..., 2:].abs() < 1e-9,
                    torch.full_like(Xc[..., 2:], 1e-9), Xc[..., 2:])
    return ((Xc[..., :2] / z) - x).reshape(-1)


_gn_jac = vmap(jacfwd(_gn_residual))
_gn_res = vmap(_gn_residual)


def _gauss_newton_pose(R, t, X, x, w, iters: int = 10):
    """Masked Gauss-Newton on the 6-dof pose (so3 ⊕ R^3), normalized
    coords, batched over the leading dim: R (B, 3, 3), t (B, 3),
    X (B, N, 3), x (B, N, 2), w (B, N)."""
    params = torch.zeros(R.shape[0], 6, dtype=X.dtype, device=X.device)
    ww = torch.repeat_interleave(w, 2, dim=-1)               # (B, 2N)
    eye = 1e-8 * torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        J = _gn_jac(params, R, t, X, x)                       # (B, 2N, 6)
        r = _gn_res(params, R, t, X, x)                       # (B, 2N)
        Jw = J * ww[..., None]
        JtJ = Jw.transpose(-1, -2) @ J + eye
        Jtr = torch.einsum("bni,bn->bi", Jw, r)
        params = params - torch.linalg.solve_ex(JtJ, Jtr[..., None])[0][
            ..., 0]
    return so3_exp(params[:, :3]) @ R, t + params[:, 3:]


@geometry_precision()
def estimate_absolute_pose_batch(X, x, mask, gumbel, thresholds,
                                 device=None) -> PnPResult:
    """PnP-RANSAC over a batch of registration attempts.

    X (B, N, 3) world points, x (B, N, 2) normalized image coords, mask
    (B, N) bool, gumbel (B, H, N) the sample draws, thresholds (B,) in
    normalized units. Hypotheses (H DLT + 4H P3P) are scored at 3x the
    threshold; the best is Gauss-Newton-polished on its consensus at 3x,
    1.5x and 1x, each polish kept only if it loses no final-threshold
    inlier; the result is the polished pose unless the best raw hypothesis
    has more inliers."""
    dev = resolve_device(device)
    X = as_tensor(X, dev, torch.float32)
    x = as_tensor(x, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    gumbel = as_tensor(gumbel, dev, torch.float32)
    thr = as_tensor(thresholds, dev, torch.float32)
    B, H, N = gumbel.shape
    idx = _sample(gumbel, mask, 6)                               # (B, H, 6)

    def take(a, i):
        k = i.shape[-1]
        flat = i.reshape(B, -1, 1).expand(-1, -1, a.shape[-1])
        return torch.gather(a, 1, flat).reshape(B, H, k, a.shape[-1])

    R_dlt, t_dlt = _dlt_pose(take(X, idx), take(x, idx),
                             torch.ones(idx.shape, dtype=X.dtype, device=dev))
    R_p3p, t_p3p, valid_p3p = _p3p_candidates(take(X, idx[..., :3]),
                                              take(x, idx[..., :3]))
    R_h = torch.cat([R_dlt, R_p3p.reshape(B, -1, 3, 3)], dim=1)
    t_h = torch.cat([t_dlt, t_p3p.reshape(B, -1, 3)], dim=1)
    hyp_ok = torch.cat([torch.ones(B, H, dtype=torch.bool, device=dev),
                        valid_p3p.reshape(B, -1)], dim=1)
    err = _reproj_err2(R_h, t_h, X[:, None], x[:, None])       # (B, 5H, N)
    err = torch.where(hyp_ok[..., None], err,
                      torch.full_like(err, float("inf")))

    rows = torch.arange(B, device=dev)
    t2 = (thr * thr)[:, None]
    inl_wide = (err < ((3.0 * thr) ** 2)[:, None, None]) & mask[:, None, :]
    best = torch.argmax(inl_wide.sum(-1, dtype=torch.int32), dim=-1)
    R_cur, t_cur = R_h[rows, best], t_h[rows, best]

    for factor in (3.0, 1.5, 1.0):
        err_cur = _reproj_err2(R_cur, t_cur, X, x)
        w = ((err_cur < ((factor * thr) ** 2)[:, None]) & mask).to(X.dtype)
        R_try, t_try = _gauss_newton_pose(R_cur, t_cur, X, x, w)
        n_cur = ((err_cur < t2) & mask).sum(-1)
        n_try = ((_reproj_err2(R_try, t_try, X, x) < t2) & mask).sum(-1)
        keep = n_try >= n_cur
        R_cur = torch.where(keep[:, None, None], R_try, R_cur)
        t_cur = torch.where(keep[:, None], t_try, t_cur)

    inl_raw = (err < t2[..., None]) & mask[:, None, :]
    counts_raw = inl_raw.sum(-1, dtype=torch.int32)
    best_raw = torch.argmax(counts_raw, dim=-1)
    inl_lo = (_reproj_err2(R_cur, t_cur, X, x) < t2) & mask
    use_lo = inl_lo.sum(-1) >= counts_raw[rows, best_raw]
    R_fin = torch.where(use_lo[:, None, None], R_cur, R_h[rows, best_raw])
    t_fin = torch.where(use_lo[:, None], t_cur, t_h[rows, best_raw])
    inliers = torch.where(use_lo[:, None], inl_lo, inl_raw[rows, best_raw])
    return PnPResult(qvec=rotmat_to_quat(R_fin), tvec=t_fin, inliers=inliers,
                     n_inliers=inliers.sum(-1, dtype=torch.int32))


def estimate_absolute_pose(X, x, mask, gumbel, threshold,
                           device=None) -> PnPResult:
    """One registration: X (N, 3), x (N, 2), mask (N,), gumbel (H, N)."""
    lead = (lambda a: a[None] if isinstance(a, torch.Tensor)
            else torch.as_tensor(a)[None])
    res = estimate_absolute_pose_batch(lead(X), lead(x), lead(mask),
                                       lead(gumbel), [float(threshold)],
                                       device)
    return PnPResult(*(v[0] for v in res))


@geometry_precision()
def refine_pose(qvec, tvec, X, x, mask, iters: int = 10, device=None):
    """Gauss-Newton pose polish after registration (normalized coords):
    qvec (4,), tvec (3,), X (N, 3), x (N, 2), mask (N,) -> (qvec, tvec)."""
    dev = resolve_device(device)
    q = as_tensor(qvec, dev, torch.float32)
    t = as_tensor(tvec, dev, torch.float32)
    X = as_tensor(X, dev, torch.float32)
    x = as_tensor(x, dev, torch.float32)
    w = as_tensor(mask, dev).to(torch.float32)
    R2, t2 = _gauss_newton_pose(quat_to_rotmat(q)[None], t[None], X[None],
                                x[None], w[None], iters)
    return rotmat_to_quat(R2[0]), t2[0]
