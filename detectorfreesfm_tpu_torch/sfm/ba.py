"""Bundle adjustment: Schur-complement Levenberg-Marquardt.

Port of the JAX package's sfm/ba.py:

  * Observations are (O,) arrays with one masked dummy slot; per-point
    track tables feed the dense Schur assembly.
  * With a mesh (parallel/mesh.py), the observations are also padded to a
    multiple of its "data" rows (JAX's `o_pad`) and split into contiguous
    blocks, one per device: each LM step computes the per-observation
    residuals, Jacobians and Huber weights of a block on its device, with
    the cameras and points replicated there, and brings them back to the
    first device, in observation order, where the reductions, the solve
    and the LM driver run. Those terms are elementwise in the
    observations, so the sharded solve is bit-equal to the one-device
    solve (as JAX's is, mapper.py), at the cost of copying
    O x (2 + 16 + 6 + 1) floats to the first device per step.
  * Per-observation 2x8 camera and 2x3 point Jacobians come from
    `vmap(jacfwd)` of the projection residual, as in JAX.
  * Camera block = 6-dof pose ⊕ log-focal ⊕ radial k1 (8 params); the
    focal/k1 columns are masked by the refine flags, and gauge cameras
    freeze their pose columns (see bundle_adjust for the gauges).
  * The reduced camera system is solved by a dense Cholesky
    (`cholesky_ex`: a matrix that is not positive definite gives a NaN
    step, which the LM driver rejects, as JAX's cho_solve does), or past
    120 cameras by matrix-free PCG with the Schur-Jacobi preconditioner.
  * Huber weights re-evaluated each iteration (IRLS form).

Reductions are `index_add_` in torch's deterministic mode (on CUDA a
sort-based accumulation, not float atomics): the mapper calls BA on real
scenes where it stops unconverged after 30 iterations, and there
atomics' run-to-run last bits grew into a different model (1 193 or 948
points on demo_cached_832 from the same input, on an H100). The host driver
normalizes the scene in float64 numpy; the solve runs in float32 with
TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..core.geometry import np_quat_to_rotmat, np_rotmat_to_quat, so3_exp
from ..core.precision import geometry_precision
from ..device import resolve_device
from ..parallel.mesh import pad_to_multiple, shard_leading_axis

CAM_DOF = 8  # 3 rot + 3 trans + 1 log-focal + 1 radial k1
# PCG iterations between two host reads of its stopping flag (one sync each)
_CG_CHECK_EVERY = 10


class BAProblem(NamedTuple):
    """BA problem: obs arrays carry one dummy slot; masks mark live ones."""

    cam_R: torch.Tensor       # (C, 3, 3) world->cam rotations
    cam_t: torch.Tensor       # (C, 3)
    intr: torch.Tensor        # (C, 5) fx, fy, cx, cy, k1 (SIMPLE_RADIAL)
    points: torch.Tensor      # (P, 3)
    obs_uv: torch.Tensor      # (O, 2) pixel observations
    obs_cam: torch.Tensor     # (O,) int64
    obs_pt: torch.Tensor      # (O,) int64
    obs_mask: torch.Tensor    # (O,) bool
    track_obs: torch.Tensor   # (P, T) int64 obs index per point (pad: dummy)
    track_mask: torch.Tensor  # (P, T) bool
    fixed_cams: torch.Tensor  # (C,) bool - anchor cameras (focal gauge)
    pose_free: torch.Tensor   # (C, 6) float - per-pose-column freedom
    refine_focal: bool
    refine_dist: bool
    # With a mesh: per "data" row, (obs_uv, obs_cam, obs_pt) padded to a
    # multiple of the rows and cut into blocks on the rows' devices.
    shards: tuple = ()


def _index_add(out, ids, data):
    """out.index_add_(0, ids, data), the same sums in the same order on
    every run (torch's deterministic mode, restored after)."""
    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return out.index_add_(0, ids, data)
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)


def _segment_sum(data, ids, n):
    out = torch.zeros((n,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return _index_add(out, ids, data)


# The per-observation terms use no matrix product and no reduction, only
# elementwise operations in a fixed order: each row's bits are then the
# same whatever batch it is in. cuBLAS's batched 3x3 products round rows
# differently with their position and batch size (past 65 535 products
# in one call, on an H100), which would make a sharded solve differ from
# the one-device one.
def _mv3(M, v):
    """M @ v for a 3x3 M and a 3-vector v."""
    return M[..., 0] * v[..., 0:1] + M[..., 1] * v[..., 1:2] \
        + M[..., 2] * v[..., 2:3]


def _mm3(A, B):
    """A @ B for 3x3 matrices."""
    return A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :] \
        + A[..., :, 2:3] * B[..., 2:3, :]


def _so3_exp3(w):
    """core.geometry.so3_exp of one axis-angle (3,), with _mm3 and an
    explicit sum of squares."""
    theta2 = (w[0:1] * w[0:1] + w[1:2] * w[1:2] + w[2:3] * w[2:3])[:, None]
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
                    dim=-1).reshape(3, 3)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A * W + B * _mm3(W, W)


def _proj(R, t, f_scale, intr, X, dk=0.0):
    """Project one world point with SIMPLE_RADIAL distortion; f_scale
    multiplies (fx, fy) and dk is a local additive update to intr[4].
    Written on 1-element slices, not 0-dim scalars: under jacfwd a python
    float combined with a 0-dim dual tensor promotes the tangent to float64
    (torch 2.x)."""
    Xc = _mv3(R, X) + t
    z = Xc[2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    xy = Xc[:2] / z
    d = 1.0 + (intr[4:5] + dk) * (xy[0:1] * xy[0:1] + xy[1:2] * xy[1:2])
    return intr[0:2] * f_scale * (xy * d) + intr[2:4]


def _obs_residual(delta_cam, delta_pt, R0, t0, intr0, X0, uv):
    """Residual as a function of the local update (8,) ⊕ (3,)."""
    R = _mm3(_so3_exp3(delta_cam[:3]), R0)
    t = t0 + delta_cam[3:6]
    pred = _proj(R, t, torch.exp(delta_cam[6]), intr0, X0 + delta_pt,
                 dk=delta_cam[7])
    return pred - uv


_residuals = vmap(_obs_residual)
_jacobians_ab = vmap(jacfwd(_obs_residual, argnums=(0, 1)))


def _huber_weight(r2, delta):
    """IRLS sqrt-weight for the Huber loss on squared residual norm r2."""
    r = torch.sqrt(r2.clamp_min(1e-18))
    return torch.where(r <= delta, torch.ones_like(r), torch.sqrt(delta / r))


def _obs_terms(cam_R, cam_t, intr, points, obs_uv, obs_cam, obs_pt,
               huber_delta):
    """Per-observation residuals r (O, 2), Jacobians A (O, 2, 8) and
    B (O, 2, 3), and Huber sqrt-weights w (O,) at the given state."""
    R0 = cam_R[obs_cam]
    t0 = cam_t[obs_cam]
    K0 = intr[obs_cam]
    X0 = points[obs_pt]
    o = obs_uv.shape[0]
    zc = torch.zeros(o, CAM_DOF, dtype=X0.dtype, device=X0.device)
    zp = torch.zeros(o, 3, dtype=X0.dtype, device=X0.device)
    r = _residuals(zc, zp, R0, t0, K0, X0, obs_uv)
    A, B = _jacobians_ab(zc, zp, R0, t0, K0, X0, obs_uv)
    # jacfwd gives A and B as strided views of one (O, 2, 11) block; the
    # products downstream round otherwise on such views than on the
    # contiguous blocks that a sharded solve gathers, so both get those.
    return (r, A.contiguous(), B.contiguous(),
            _huber_weight(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1], huber_delta))


def _jacobians(prob: BAProblem):
    """Per-observation residuals r (O, 2) and Jacobians A (O, 2, 8),
    B (O, 2, 3) at the current state."""
    return _terms(prob, 2.0)[:3]


def _terms(prob: BAProblem, huber_delta: float):
    """_obs_terms of every observation slot, on the first device: computed
    there, or with shards on each block's device and brought back in
    observation order (the pad rows past the dummy slot dropped)."""
    state = (prob.cam_R, prob.cam_t, prob.intr, prob.points)
    if not prob.shards:
        return _obs_terms(*state, prob.obs_uv, prob.obs_cam, prob.obs_pt,
                          huber_delta)
    reps = {}
    parts = []  # every block launched before any is brought back
    for obs in prob.shards:
        dev = obs[0].device
        if dev not in reps:
            reps[dev] = [x.to(dev) for x in state]
        parts.append(_obs_terms(*reps[dev], *obs, huber_delta))
    first, o = prob.points.device, prob.obs_uv.shape[0]
    return tuple(torch.cat([p[k].to(first) for p in parts])[:o]
                 for k in range(4))


def _weighted_system(prob: BAProblem, huber_delta: float):
    r, A, B, w = _terms(prob, huber_delta)
    w = w * prob.obs_mask.to(w.dtype)
    # Per-camera column mask: pose columns from the gauge mask, the focal
    # column frozen on anchors, the distortion column live on all.
    C = prob.cam_R.shape[0]
    dtype = A.dtype
    anchor_free = (1.0 - prob.fixed_cams.to(dtype))[:, None]
    cam_col = torch.cat([
        prob.pose_free.to(dtype),
        float(prob.refine_focal) * anchor_free,
        torch.full((C, 1), float(prob.refine_dist), dtype=dtype,
                   device=A.device),
    ], dim=1)                                                 # (C, 8)
    A = A * cam_col[prob.obs_cam][:, None, :]
    return (r * w[:, None], A * w[:, None, None], B * w[:, None, None],
            cam_col)


def ba_cost(prob: BAProblem, huber_delta: float = 2.0) -> torch.Tensor:
    """Total robust cost (Huber rho of pixel residuals) over live obs."""
    R0 = prob.cam_R[prob.obs_cam]
    t0 = prob.cam_t[prob.obs_cam]
    K0 = prob.intr[prob.obs_cam]
    X0 = prob.points[prob.obs_pt]
    Xc = torch.einsum("oij,oj->oi", R0, X0) + t0
    z = torch.where(Xc[:, 2].abs() < 1e-9, torch.full_like(Xc[:, 2], 1e-9),
                    Xc[:, 2])
    x, y = Xc[:, 0] / z, Xc[:, 1] / z
    d = 1.0 + K0[:, 4] * (x * x + y * y)
    pred = torch.stack([K0[:, 0] * (x * d) + K0[:, 2],
                        K0[:, 1] * (y * d) + K0[:, 3]], dim=-1)
    r2 = torch.sum((pred - prob.obs_uv) ** 2, -1)
    dl = huber_delta
    rho = torch.where(r2 <= dl * dl, r2,
                      2.0 * dl * torch.sqrt(r2.clamp_min(1e-18)) - dl * dl)
    return torch.sum(rho * prob.obs_mask.to(rho.dtype))


def _blocks(prob: BAProblem, lam, huber_delta):
    """The damped normal-equation blocks shared by both solvers."""
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    dtype = prob.points.dtype
    rw, Aw, Bw, cam_col = _weighted_system(prob, huber_delta)
    U = _segment_sum(torch.einsum("oik,oil->okl", Aw, Aw), prob.obs_cam, C)
    b_cam = _segment_sum(-torch.einsum("oik,oi->ok", Aw, rw), prob.obs_cam, C)
    V = _segment_sum(torch.einsum("oik,oil->okl", Bw, Bw), prob.obs_pt, P)
    b_pt = _segment_sum(-torch.einsum("oik,oi->ok", Bw, rw), prob.obs_pt, P)
    eyeC = torch.eye(CAM_DOF, dtype=dtype, device=U.device)
    eyeP = torch.eye(3, dtype=dtype, device=U.device)
    U = U + lam * (U * eyeC) + 1e-8 * eyeC
    V = V + lam * (V * eyeP) + 1e-8 * eyeP
    V_inv = torch.linalg.inv_ex(V)[0]
    W = torch.einsum("oik,oil->okl", Aw, Bw)                  # (O, 8, 3)
    Y = torch.einsum("okl,olm->okm", W, V_inv[prob.obs_pt])
    red = _segment_sum(torch.einsum("okm,om->ok", Y, b_pt[prob.obs_pt]),
                       prob.obs_cam, C)
    occupied = _segment_sum(prob.obs_mask.to(dtype), prob.obs_cam, C) > 0
    free_col = cam_col * occupied[:, None].to(dtype)          # (C, 8)
    return U, b_cam - red, V_inv, b_pt, W, Y, free_col


def _apply(prob: BAProblem, delta_c, V_inv, b_pt, W):
    """Back-substitute the points and apply the update."""
    P = prob.points.shape[0]
    WtD = _segment_sum(torch.einsum("okl,ok->ol", W, delta_c[prob.obs_cam]),
                       prob.obs_pt, P)
    delta_p = torch.einsum("pkl,pl->pk", V_inv, b_pt - WtD)
    cam_R = so3_exp(delta_c[:, :3]) @ prob.cam_R
    cam_t = prob.cam_t + delta_c[:, 3:6]
    f_scale = torch.exp(delta_c[:, 6])
    intr = prob.intr.clone()
    intr[:, 0] = intr[:, 0] * f_scale
    intr[:, 1] = intr[:, 1] * f_scale
    intr[:, 4] = intr[:, 4] + delta_c[:, 7]
    return cam_R, cam_t, intr, prob.points + delta_p


def lm_step(prob: BAProblem, lam, huber_delta: float = 2.0):
    """One damped Schur LM solve with the dense camera system. Returns the
    proposed (cam_R, cam_t, intr, points); the host loop accepts or
    rejects it by ba_cost."""
    C = prob.cam_R.shape[0]
    dtype = prob.points.dtype
    U, b_red, V_inv, b_pt, W, Y, free_col = _blocks(prob, lam, huber_delta)

    # S = U - sum over each point's camera pairs of Y_i W_j^T, assembled
    # from the per-point track tables (pad entries point at the dummy obs).
    tm = prob.track_mask[..., None, None].to(dtype)
    Wt = W[prob.track_obs] * tm                               # (P, T, 8, 3)
    Yt = Y[prob.track_obs] * tm
    cams_t = prob.obs_cam[prob.track_obs]                     # (P, T)
    pair = torch.einsum("ptkm,pslm->ptskl", Yt, Wt)           # (P,T,T,8,8)
    lin = (cams_t[:, :, None] * C + cams_t[:, None, :]).reshape(-1)
    S = torch.zeros(C * C, CAM_DOF, CAM_DOF, dtype=dtype, device=U.device)
    _index_add(S, lin, pair.reshape(-1, CAM_DOF, CAM_DOF))
    S = -S.reshape(C, C, CAM_DOF, CAM_DOF)
    diag = torch.arange(C, device=U.device)
    S[diag, diag] += U
    # Masked columns -> unit diagonal entries (keeps the Cholesky SPD).
    S = S * free_col[:, None, :, None] * free_col[None, :, None, :]
    S[diag, diag] += torch.diag_embed(1.0 - free_col)
    b_red = b_red * free_col

    S_dense = S.permute(0, 2, 1, 3).reshape(C * CAM_DOF, C * CAM_DOF)
    L, info = torch.linalg.cholesky_ex(S_dense)
    delta = torch.cholesky_solve(b_red.reshape(-1, 1), L)[:, 0]
    # Not positive definite: NaN step, as JAX's cho_solve gives.
    delta = torch.where(info == 0, delta, torch.full_like(delta,
                                                          float("nan")))
    return _apply(prob, delta.reshape(C, CAM_DOF), V_inv, b_pt, W)


def lm_step_pcg(prob: BAProblem, lam, huber_delta: float = 2.0,
                cg_iters: int = 100, cg_rtol: float = 1e-2):
    """One damped LM step solving the camera Schur system with matrix-free
    preconditioned conjugate gradients (Schur-Jacobi preconditioner).

    JAX's stopping rule, exactly: iterate while it < cg_iters and
    ||r||^2 > (cg_rtol ||b||)^2. Each iteration updates only while that
    holds (a converged state is frozen by masks), and the host reads the
    flag once every _CG_CHECK_EVERY iterations, so the iterate returned is
    JAX's and the host syncs cg_iters / _CG_CHECK_EVERY times at most.
    Returns (cam_R, cam_t, intr, points, iterations used)."""
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    dtype = prob.points.dtype
    U, b_red, V_inv, b_pt, W, Y, free_col = _blocks(prob, lam, huber_delta)
    b_red = b_red * free_col

    def S_mv(v):
        vf = v * free_col
        u = torch.einsum("ckl,cl->ck", U, vf)
        z = _segment_sum(torch.einsum("okl,ok->ol", W, vf[prob.obs_cam]),
                         prob.obs_pt, P)
        corr = _segment_sum(torch.einsum("okm,om->ok", Y, z[prob.obs_pt]),
                            prob.obs_cam, C)
        return (u - corr) * free_col + v * (1.0 - free_col)

    eyeC = torch.eye(CAM_DOF, dtype=dtype, device=U.device)
    D = U - _segment_sum(torch.einsum("okm,olm->okl", Y, W), prob.obs_cam, C)
    D = (D * free_col[:, :, None] * free_col[:, None, :]
         + torch.diag_embed(1.0 - free_col))
    D_inv = torch.linalg.inv_ex(D + 1e-8 * eyeC)[0]

    def M_inv(v):
        return torch.einsum("ckl,cl->ck", D_inv, v)

    x = torch.zeros(C, CAM_DOF, dtype=dtype, device=U.device)
    r = b_red - S_mv(x)
    z = M_inv(r)
    p = z
    rz = torch.sum(r * z)
    tol2 = (cg_rtol * cg_rtol) * torch.sum(b_red * b_red)
    it = torch.zeros((), dtype=torch.int64, device=U.device)
    zero = torch.zeros((), dtype=dtype, device=U.device)
    done = 0
    while done < cg_iters:
        for _ in range(min(_CG_CHECK_EVERY, cg_iters - done)):
            active = (it < cg_iters) & (torch.sum(r * r) > tol2)
            Sp = S_mv(p)
            denom = torch.sum(p * Sp)
            alpha = torch.where(denom.abs() > 1e-20, rz / denom, zero)
            x_n = x + alpha * p
            r_n = r - alpha * Sp
            z_n = M_inv(r_n)
            rz_n = torch.sum(r_n * z_n)
            beta = torch.where(rz.abs() > 1e-20, rz_n / rz, zero)
            p_n = z_n + beta * p
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
            it = it + active.to(it.dtype)
        done += _CG_CHECK_EVERY
        if not bool((torch.sum(r * r) > tol2) & (it < cg_iters)):
            break
    delta_c = x * free_col
    return (*_apply(prob, delta_c, V_inv, b_pt, W), int(it))


@geometry_precision()
def bundle_adjust(
    qvec: np.ndarray,        # (C, 4)
    tvec: np.ndarray,        # (C, 3)
    intr: np.ndarray,        # (C, 4) fx, fy, cx, cy  or  (C, 5) ... + k1
    points: np.ndarray,      # (P, 3)
    obs_uv: np.ndarray,      # (O, 2)
    obs_cam: np.ndarray,     # (O,)
    obs_pt: np.ndarray,      # (O,)
    fixed_cams: np.ndarray | None = None,
    refine_focal: bool = False,
    refine_dist: bool = False,
    max_iters: int = 30,
    huber_delta: float = 2.0,
    max_track: int | None = None,
    schur_mode: str = "auto",  # "dense" | "pcg" | "auto" (pcg past 120 cams)
    cg_iters: int = 100,
    cg_rtol: float = 1e-2,
    gauge: str = "auto",       # "similarity" | "full" | "auto"
    verbose: bool = False,
    device=None,
    info: dict | None = None,
    mesh=None,               # parallel.mesh.Mesh: shard obs over "data"
):
    """Host LM driver around the Schur step, on `device` (None: CUDA), or
    with `mesh` sharded over its "data" rows and solved on its first
    device (see the module docstring).

    Inputs are live (unpadded) numpy arrays. Returns (qvec, tvec, intr,
    points, final_cost_per_obs) as float64 numpy. If `info` is a dict it
    receives the LM iterations run and accepted and the CG iterations.

    Gauges: "similarity" needs exactly two fixed cameras and freezes
    camera A's pose and the one translation component of camera B most
    aligned with the baseline (7 DOF); "full" freezes every fixed camera's
    pose; "auto" is similarity iff exactly two are fixed."""
    if mesh is not None and device is not None:
        raise ValueError("pass a device or a mesh, not both")
    dev = mesh.first if mesh is not None else resolve_device(device)
    C, P, O = len(qvec), len(points), len(obs_uv)
    in_cols = intr.shape[1]
    if in_cols == 4:  # pinhole callers: k1 = 0 column appended internally
        intr = np.concatenate([intr, np.zeros((C, 1))], axis=1)
    if O == 0 or P == 0:
        return qvec, tvec, intr[:, :in_cols], points, 0.0
    use_pcg = schur_mode == "pcg" or (schur_mode == "auto" and C > 120)

    # Scene normalization for f32 conditioning (float64 numpy, as JAX).
    center = points.mean(0)
    scale = float(np.median(np.linalg.norm(points - center, axis=1)) + 1e-9)
    pts_n = (points - center) / scale
    R_all = np_quat_to_rotmat(np.asarray(qvec, np.float64))
    t_n = (np.einsum("cij,j->ci", R_all, center) + tvec) / scale

    fixed = np.asarray(
        fixed_cams if fixed_cams is not None else np.zeros(C, bool), bool)
    pose_free_np = np.ones((C, 6), np.float32)
    fix_idx = np.flatnonzero(fixed)
    if gauge not in ("similarity", "full", "auto"):
        raise ValueError(f"unknown gauge {gauge!r}")
    if gauge == "similarity" and len(fix_idx) != 2:
        raise ValueError(
            f"gauge='similarity' needs exactly 2 fixed cameras, got "
            f"{len(fix_idx)}")
    if gauge == "similarity" or (gauge == "auto" and len(fix_idx) == 2):
        a, b = int(fix_idx[0]), int(fix_idx[1])
        pose_free_np[a] = 0.0
        d = t_n[b] - R_all[b] @ R_all[a].T @ t_n[a]
        if np.max(np.abs(d)) > 1e-12:
            pose_free_np[b, 3 + int(np.argmax(np.abs(d)))] = 0.0
        else:  # zero baseline: degenerate pair, pin it fully
            pose_free_np[b] = 0.0
    else:
        pose_free_np[fixed] = 0.0

    # Per-point padded track -> obs table for the dense Schur assembly
    # (the PCG path is matrix-free and gets a minimal dummy).
    if use_pcg:
        T = 1
        track_obs = np.full((P, 1), O, np.int64)
        track_mask = np.zeros((P, 1), bool)
    else:
        order = np.argsort(obs_pt, kind="stable")
        counts = np.bincount(obs_pt, minlength=P)
        T = int(max_track or max(int(counts.max()), 2))
        track_obs = np.full((P, T), O, np.int64)
        track_mask = np.zeros((P, T), bool)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pt_sorted = obs_pt[order]
        rank = np.arange(O) - starts[pt_sorted]
        keep = rank < T
        track_obs[pt_sorted[keep], rank[keep]] = order[keep]
        track_mask[pt_sorted[keep], rank[keep]] = True

    def pad(a, v):  # one dummy observation slot (index O)
        return np.concatenate([a, np.full((1,) + a.shape[1:], v, a.dtype)])

    def dv(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    prob = BAProblem(
        cam_R=dv(R_all), cam_t=dv(t_n), intr=dv(intr), points=dv(pts_n),
        obs_uv=dv(pad(obs_uv.astype(np.float32), 0.0)),
        obs_cam=dv(pad(obs_cam.astype(np.int64), 0), torch.int64),
        obs_pt=dv(pad(obs_pt.astype(np.int64), 0), torch.int64),
        obs_mask=dv(pad(np.ones(O, bool), False), torch.bool),
        track_obs=dv(track_obs, torch.int64),
        track_mask=dv(track_mask, torch.bool),
        fixed_cams=dv(fixed, torch.bool), pose_free=dv(pose_free_np),
        refine_focal=bool(refine_focal), refine_dist=bool(refine_dist))
    n_shard = len(mesh.data_devices) if mesh is not None else 1
    if n_shard > 1:
        # JAX's o_pad: the dummy slot, then pad rows up to a multiple of
        # the rows (their terms are dropped before any reduction).
        o_pad = pad_to_multiple(O + 1, n_shard)

        def padded(a, v):
            return np.concatenate(
                [a, np.full((o_pad - O,) + a.shape[1:], v, a.dtype)])

        prob = prob._replace(shards=tuple(map(tuple, shard_leading_axis(
            (padded(obs_uv.astype(np.float32), 0.0),
             padded(obs_cam.astype(np.int64), 0),
             padded(obs_pt.astype(np.int64), 0)), mesh))))

    lam = 1e-3
    cost = float(ba_cost(prob, huber_delta))
    n_iter = n_accept = cg_total = 0
    for it in range(max_iters):
        n_iter += 1
        cg_used = 0
        lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
        if use_pcg:
            cam_R, cam_t, new_intr, new_pts, cg_used = lm_step_pcg(
                prob, lam_t, huber_delta, cg_iters, cg_rtol)
            cg_total += cg_used
        else:
            cam_R, cam_t, new_intr, new_pts = lm_step(prob, lam_t,
                                                      huber_delta)
        cand = prob._replace(cam_R=cam_R, cam_t=cam_t, intr=new_intr,
                             points=new_pts)
        new_cost = float(ba_cost(cand, huber_delta))
        if verbose:
            extra = f" cg {cg_used}" if use_pcg else ""
            print(f"  LM it {it}: cost {cost:.4f} -> {new_cost:.4f} "
                  f"lam {lam:.2e}{extra}")
        if np.isfinite(new_cost) and new_cost < cost:
            rel = (cost - new_cost) / max(cost, 1e-12)
            prob = cand
            cost = new_cost
            n_accept += 1
            lam = max(lam / 3.0, 1e-8)
            if rel < 1e-6:
                break
        else:
            lam = min(lam * 5.0, 1e6)
            if lam >= 1e6:
                break
    if info is not None:
        info.update(iterations=n_iter, accepted=n_accept,
                    cg_iterations=cg_total,
                    solver="pcg" if use_pcg else "dense", shards=n_shard)

    R_out = prob.cam_R.double().cpu().numpy()
    q_out = np_rotmat_to_quat(R_out)
    t_out = prob.cam_t.double().cpu().numpy() * scale - np.einsum(
        "cij,j->ci", R_out, center)
    pts_out = prob.points.double().cpu().numpy() * scale + center
    return (q_out.astype(np.float64), t_out,
            prob.intr.double().cpu().numpy()[:, :in_cols], pts_out,
            cost / max(O, 1))
