"""Two-view geometry: batched 8-point essential and 4-point homography
RANSAC with MSAC scoring and LO refits, pose recovery, and the homography
decomposition of planar pairs.

Port of the JAX package's sfm/twoview.py. RANSAC is a fixed-iteration,
fully batched program: all H hypotheses of all B pairs are sampled,
solved and scored against all N (padded, masked) correspondences in one
pass, with no data-dependent control flow.

The JAX estimators draw their samples inside, as the top-k of
`jax.random.gumbel(key, (H, N))`; the port's take that Gumbel array as an
input (`utils.prng.gumbel` makes it from the same keys). Samples keep
their top-k order. SVD/QR/eigh vectors are defined up to sign and the
signs are backend-specific: E and H come out up to sign; Sampson error,
transfer error, the decompositions and cheirality do not depend on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.epipolar import skew
from ..core.geometry import rotmat_to_quat
from ..core.precision import as_tensor, geometry_precision
from ..device import resolve_device


class TwoViewResult(NamedTuple):
    E: torch.Tensor          # (..., 3, 3) essential matrix (normalized coords)
    qvec: torch.Tensor       # (..., 4) rotation cam0 -> cam1
    tvec: torch.Tensor       # (..., 3) unit-norm translation
    inliers: torch.Tensor    # (..., N) bool
    n_inliers: torch.Tensor  # (...,) int32


class HomographyResult(NamedTuple):
    H: torch.Tensor          # (..., 3, 3) homography x1 ~ H x0
    inliers: torch.Tensor    # (..., N) bool
    n_inliers: torch.Tensor  # (...,) int32


def normalize_points(uv, K):
    """Pixels -> unit-plane coordinates: x = (u - cx)/fx, y = (v - cy)/fy."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([(uv[..., 0] - cx[..., None]) / fx[..., None],
                        (uv[..., 1] - cy[..., None]) / fy[..., None]], dim=-1)


def _nullvec(A: torch.Tensor) -> torch.Tensor:
    """Smallest singular vector of (..., M, 9) design matrices, on the
    design matrix itself (not its normal matrix, which squares the
    condition number):
      M == 8: the last column of the complete QR of A^T spans the exact
        null space;
      M > 8: thin QR A = QR, then the smallest right singular vector of the
        9x9 R."""
    if A.shape[-2] == 8:
        Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
        return Q[..., :, -1]
    _, R = torch.linalg.qr(A, mode="r")
    _, _, Vt = torch.linalg.svd(R)
    return Vt[..., -1, :]


def _eight_point(x0, x1, w):
    """Weighted 8-point: (..., N, 2) correspondences -> (..., 3, 3) E,
    projected onto the essential manifold."""
    ones = torch.ones_like(x0[..., :1])
    p0 = torch.cat([x0, ones], dim=-1)
    p1 = torch.cat([x1, ones], dim=-1)
    # A rows: kron(p1, p0) so that p1^T E p0 = 0
    A = (p1[..., :, None] * p0[..., None, :]).reshape(*x0.shape[:-1], 9)
    e = _nullvec(A * w[..., None])
    E = e.reshape(*e.shape[:-1], 3, 3)
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S_new = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return U @ (S_new[..., :, None] * Vt)


def sampson_error(E, x0, x1):
    """Squared Sampson distance in normalized coords. E (..., 3, 3),
    x0/x1 (..., N, 2) -> (..., N)."""
    ones = torch.ones_like(x0[..., :1])
    p0 = torch.cat([x0, ones], dim=-1)
    p1 = torch.cat([x1, ones], dim=-1)
    Ep0 = torch.einsum("...ij,...nj->...ni", E, p0)
    Etp1 = torch.einsum("...ji,...nj->...ni", E, p1)
    num = torch.sum(p1 * Ep0, dim=-1) ** 2
    den = (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2
           + Etp1[..., 1] ** 2)
    return num / den.clamp_min(1e-12)


def decompose_E(E):
    """E -> (R1, R2, t): the four candidate poses are (R_i, ±t)."""
    U, _, Vt = torch.linalg.svd(E)
    det_u = torch.linalg.det(U)
    det_v = torch.linalg.det(Vt)
    one = torch.ones_like(det_u)
    U = U * torch.stack([one, one, det_u], -1)[..., None, :]
    Vt = Vt * torch.stack([one, one, det_v], -1)[..., :, None]
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def _cheirality_count(R, t, x0, x1, mask):
    """Correspondences with positive depth in both views under (R, t), by
    the midpoint of the two viewing rays (camera 0 at the origin).
    R (..., 3, 3), t (..., 3), x0/x1 (..., N, 2), mask (..., N) -> (...,)."""
    ones = torch.ones_like(x0[..., :1])
    d0 = torch.cat([x0, ones], dim=-1)
    d1c0 = torch.einsum("...ji,...nj->...ni", R,
                        torch.cat([x1, ones], dim=-1))
    c1 = -torch.einsum("...ji,...j->...i", R, t)[..., None, :]
    a = torch.sum(d0 * d0, -1)
    b = -torch.sum(d0 * d1c0, -1)
    c = torch.sum(d1c0 * d1c0, -1)
    e0 = torch.sum(d0 * c1, -1)
    e1 = -torch.sum(d1c0 * c1, -1)
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    s = (c * e0 - b * e1) / det
    r = (a * e1 - b * e0) / det
    ok = (s > 1e-4) & (r > 1e-4) & mask
    return ok.sum(-1, dtype=torch.int32)


def _four_point_h(x0, x1, w):
    """Weighted DLT homography: (..., N, 2) -> (..., 3, 3) with x1 ~ H x0.
    Rows per correspondence (u0,v0)->(u1,v1), all first rows then all
    second rows, as in JAX:
      [ -u0 -v0 -1   0   0  0  u1*u0 u1*v0 u1 ]
      [  0   0   0 -u0 -v0 -1  v1*u0 v1*v0 v1 ]"""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    one = torch.ones_like(u0)
    zero = torch.zeros_like(u0)
    r1 = torch.stack([-u0, -v0, -one, zero, zero, zero,
                      u1 * u0, u1 * v0, u1], dim=-1)
    r2 = torch.stack([zero, zero, zero, -u0, -v0, -one,
                      v1 * u0, v1 * v0, v1], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    h = _nullvec(A)
    return h.reshape(*h.shape[:-1], 3, 3)


def homography_error(H, x0, x1):
    """Squared forward transfer error |x1 - H(x0)|^2 in normalized coords."""
    ones = torch.ones_like(x0[..., :1])
    Hp = torch.einsum("...ij,...nj->...ni", H, torch.cat([x0, ones], -1))
    z = Hp[..., 2]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return torch.sum((Hp[..., :2] / z[..., None] - x1) ** 2, dim=-1)


def _sample(gumbel, mask, k):
    """Indices (B, H, k) of the top-k masked Gumbel scores of each
    hypothesis row, in descending order, ties to the lower index: what
    jax.lax.top_k gives. torch.topk does not order ties (draws tie exactly
    at float32 resolution: a few rows in a thousand at N = 2048), so this
    is a stable descending sort."""
    scores = torch.where(mask[:, None, :], gumbel,
                         torch.full_like(gumbel, -float("inf")))
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _gather(x, idx):
    """x (B, N, D), idx (B, H, k) -> (B, H, k, D)."""
    b, h, k = idx.shape
    flat = idx.reshape(b, h * k, 1).expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(b, h, k, x.shape[-1])


def _lo_ransac(fit, error, x0, x1, mask, idx, t2, rounds=4):
    """Shared MSAC + LO-RANSAC core: hypotheses from the sampled indices,
    the MSAC-best of them, then `rounds` weighted refits on the current
    inliers, each kept only if its MSAC score does not get worse."""
    w_valid = mask.to(x0.dtype)
    model_h = fit(_gather(x0, idx), _gather(x1, idx),
                  torch.ones(idx.shape, dtype=x0.dtype, device=x0.device))
    err = error(model_h, x0[:, None], x1[:, None])          # (B, H, N)
    msac = torch.sum(torch.minimum(err, t2[:, None, None])
                     * w_valid[:, None, :], dim=-1)
    best = torch.argmin(msac, dim=-1)                       # first of ties
    rows = torch.arange(x0.shape[0], device=x0.device)
    model = model_h[rows, best]
    inliers = (err[rows, best] < t2[:, None]) & mask
    score = msac[rows, best]
    for _ in range(rounds):
        model_new = fit(x0, x1, inliers.to(x0.dtype) * w_valid)
        err_new = error(model_new, x0, x1)
        score_new = torch.sum(torch.minimum(err_new, t2[:, None]) * w_valid,
                              dim=-1)
        better = score_new <= score
        model = torch.where(better[:, None, None], model_new, model)
        inliers = torch.where(better[:, None],
                              (err_new < t2[:, None]) & mask, inliers)
        score = torch.where(better, score_new, score)
    return model, inliers


def _batch_inputs(x0, x1, mask, gumbel, thresholds, device):
    dev = resolve_device(device)
    x0 = as_tensor(x0, dev, torch.float32)
    x1 = as_tensor(x1, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    gumbel = as_tensor(gumbel, dev, torch.float32)
    t = as_tensor(thresholds, dev, torch.float32)
    return x0, x1, mask, gumbel, t * t


@geometry_precision()
def estimate_relative_pose_batch(x0, x1, mask, gumbel, thresholds,
                                 device=None) -> TwoViewResult:
    """Essential-matrix RANSAC + cheirality pose recovery over a batch of
    pairs padded to a shared N.

    x0, x1 (B, N, 2) normalized coords; mask (B, N) bool; gumbel (B, H, N)
    the sample draws (H hypotheses); thresholds (B,) Sampson thresholds in
    normalized units. Numpy inputs are moved to `device` (None: CUDA)."""
    x0, x1, mask, gumbel, t2 = _batch_inputs(x0, x1, mask, gumbel,
                                             thresholds, device)
    idx = _sample(gumbel, mask, 8)
    E, inliers = _lo_ransac(_eight_point, sampson_error, x0, x1, mask, idx,
                            t2)
    R1, R2, t = decompose_E(E)
    Rs = torch.stack([R1, R1, R2, R2], dim=1)                # (B, 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=1)                  # (B, 4, 3)
    votes = _cheirality_count(Rs, ts, x0[:, None], x1[:, None],
                              inliers[:, None])              # (B, 4)
    k = torch.argmax(votes, dim=-1)
    rows = torch.arange(x0.shape[0], device=x0.device)
    R_best, t_best = Rs[rows, k], ts[rows, k]
    return TwoViewResult(
        E=E, qvec=rotmat_to_quat(R_best),
        tvec=t_best / torch.linalg.norm(t_best, dim=-1,
                                        keepdim=True).clamp_min(1e-12),
        inliers=inliers, n_inliers=inliers.sum(-1, dtype=torch.int32))


@geometry_precision()
def estimate_homography_batch(x0, x1, mask, gumbel, thresholds,
                              device=None) -> HomographyResult:
    """4-point homography RANSAC (MSAC + LO) over a batch of pairs, for
    planar / pure-rotation detection. Arguments as
    estimate_relative_pose_batch; thresholds are transfer-error limits."""
    x0, x1, mask, gumbel, t2 = _batch_inputs(x0, x1, mask, gumbel,
                                             thresholds, device)
    idx = _sample(gumbel, mask, 4)
    H, inliers = _lo_ransac(_four_point_h, homography_error, x0, x1, mask,
                            idx, t2)
    return HomographyResult(H=H, inliers=inliers,
                            n_inliers=inliers.sum(-1, dtype=torch.int32))


def estimate_relative_pose(x0, x1, mask, gumbel, threshold,
                           device=None) -> TwoViewResult:
    """One pair: x0/x1 (N, 2), mask (N,), gumbel (H, N)."""
    res = estimate_relative_pose_batch(_lead(x0), _lead(x1), _lead(mask),
                                       _lead(gumbel), [float(threshold)],
                                       device)
    return TwoViewResult(*(v[0] for v in res))


def estimate_homography(x0, x1, mask, gumbel, threshold,
                        device=None) -> HomographyResult:
    """One pair: x0/x1 (N, 2), mask (N,), gumbel (H, N)."""
    res = estimate_homography_batch(_lead(x0), _lead(x1), _lead(mask),
                                    _lead(gumbel), [float(threshold)], device)
    return HomographyResult(*(v[0] for v in res))


def _lead(x):
    return x[None] if isinstance(x, torch.Tensor) else torch.as_tensor(x)[None]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


@geometry_precision()
def decompose_homography(H, x0, x1, mask, all_mask=None, device=None):
    """Pose from a normalized-coordinate homography (planar scene):
    H ~ R + t n^T / d. Returns (R, t_unit, n) of the best candidate.

    Candidates are voted by cheirality over the H-inliers `mask`; the
    eigenvector signs are canonicalized (largest-|component| entry
    positive) so the candidate order does not depend on the backend's SVD;
    candidates within 2% of the best vote (a float comparison) are told
    apart by the capped Sampson error of their E = [t]x R over `all_mask`
    (default `mask`): off-plane true matches satisfy only the true
    solution's epipolar geometry."""
    dev = resolve_device(device)
    H = as_tensor(H, dev, torch.float32)
    x0 = as_tensor(x0, dev, torch.float32)
    x1 = as_tensor(x1, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    all_mask = mask if all_mask is None else as_tensor(all_mask, dev,
                                                       torch.bool)
    _U, S, _Vt = torch.linalg.svd(H)
    H_n = H / S[1]
    ones = torch.ones_like(x0[..., :1])
    p0 = torch.cat([x0, ones], dim=-1)
    p1 = torch.cat([x1, ones], dim=-1)
    dots = torch.sum(p1 * (p0 @ H_n.T), -1) * mask.to(H_n.dtype)
    H_n = H_n * torch.sign(torch.sum(dots))
    _, S2, V2t = torch.linalg.svd(H_n.T @ H_n)
    V2 = V2t.T
    comp = torch.take_along_dim(
        V2, torch.argmax(V2.abs(), dim=0)[None, :], dim=0)[0]
    V2 = V2 * torch.where(comp < 0, -1.0, 1.0)[None, :]
    det_sign = torch.sign(torch.linalg.det(V2))
    one = torch.ones_like(det_sign)
    V2 = V2 * torch.stack([one, det_sign, one])[None, :]
    s1, s3 = S2[0], S2[2]
    v1, v2, v3 = V2[:, 0], V2[:, 1], V2[:, 2]
    denom = torch.sqrt((s1 - s3).clamp_min(1e-12))
    a = torch.sqrt((1.0 - s3).clamp_min(0.0))
    b = torch.sqrt((s1 - 1.0).clamp_min(0.0))
    u1 = (a * v1 + b * v3) / denom
    u2 = (a * v1 - b * v3) / denom

    def pose_from(u):
        U1 = torch.stack([v2, u, _cross(v2, u)], dim=1)
        W1 = torch.stack([H_n @ v2, H_n @ u, _cross(H_n @ v2, H_n @ u)],
                         dim=1)
        R = W1 @ U1.T
        n = _cross(v2, u)
        return R, (H_n - R) @ n, n

    cands = []
    for u in (u1, u2):
        R, t, n = pose_from(u)
        cands.append((R, t, n))
        cands.append((R, -t, -n))
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    ns = torch.stack([c[2] for c in cands])
    t_unit = ts / torch.linalg.norm(ts, dim=-1, keepdim=True).clamp_min(1e-12)
    votes = _cheirality_count(Rs, t_unit, x0[None], x1[None], mask[None])
    cap = 1e-4  # (normalized units)^2; ~4 px at f=1000
    wa = all_mask.to(H.dtype)
    err = sampson_error(skew(t_unit) @ Rs, x0[None], x1[None])
    epi = (torch.sum(torch.clamp_max(err, cap) * wa, dim=-1)
           / torch.sum(wa).clamp_min(1.0))
    max_v = votes.max()
    eligible = votes.float() >= max_v.float() * 0.98
    k = torch.argmax(torch.where(eligible, -epi,
                                 torch.full_like(epi, -float("inf"))))
    return Rs[k], t_unit[k], ns[k]
