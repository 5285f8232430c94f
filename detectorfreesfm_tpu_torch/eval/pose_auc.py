"""Pairwise relative-pose AUC evaluation.

Protocol identical to the reference (src/evaluator/evaluator.py:136,342-354 and
src/utils/metric_utils.py:112-131): over all C(n,2) image pairs, the error is
max(rotation angle, translation-direction angle) between estimated and GT
relative poses; unregistered images contribute infinite error; AUC of the
error-recall curve is reported at several degree thresholds.

This is a host-side metric, so it runs in numpy float64 (float32 arccos near 1
is too ill-conditioned to report sub-degree errors); the all-pairs relative
poses are still computed as one vectorized batch. A copy of the JAX
package's eval/pose_auc.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..core.geometry import np_quat_to_rotmat as _np_quat_to_rotmat

DEFAULT_THRESHOLDS = (1, 3, 5, 10, 20)

_trapz = getattr(np, "trapezoid", None) or np.trapz


def pose_auc(errors: np.ndarray, thresholds: Sequence[float]) -> List[float]:
    """AUC of the recall curve of `errors` at each threshold (trapezoid rule).

    Infinite errors are kept: they flatten the curve (penalized), matching the
    reference's unregistered-image handling.
    """
    errors = np.sort(np.asarray(errors, dtype=np.float64))
    n = len(errors)
    if n == 0:
        return [0.0 for _ in thresholds]
    recall = (np.arange(n) + 1) / n
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last_index], [recall[max(last_index - 1, 0)]]])
        e = np.concatenate([errors[:last_index], [t]])
        aucs.append(float(_trapz(r, x=e) / t))
    return aucs


def all_pairs_relative_errors(
    qvecs_est: np.ndarray,
    tvecs_est: np.ndarray,
    registered: np.ndarray,
    qvecs_gt: np.ndarray,
    tvecs_gt: np.ndarray,
) -> np.ndarray:
    """Pairwise max(R-err, t-err) in degrees for all i<j pairs.

    Inputs are (n, 4) / (n, 3) world-to-camera arrays aligned by image index;
    `registered` is an (n,) bool mask. Unregistered members yield inf.
    """
    n = len(qvecs_gt)
    iu, ju = np.triu_indices(n, k=1)

    def rel(q, t):
        """Relative pose i->j for each pair: R = Rj Ri^T, t = tj - R ti."""
        R = _np_quat_to_rotmat(np.asarray(q, dtype=np.float64))
        t = np.asarray(t, dtype=np.float64)
        R_rel = R[ju] @ np.swapaxes(R[iu], -1, -2)
        t_rel = t[ju] - np.einsum("nij,nj->ni", R_rel, t[iu])
        return R_rel, t_rel

    R_e, t_e = rel(qvecs_est, tvecs_est)
    R_g, t_g = rel(qvecs_gt, tvecs_gt)
    # Rotation geodesic angle of R_e R_g^T
    R_d = R_e @ np.swapaxes(R_g, -1, -2)
    tr = np.clip((R_d[..., 0, 0] + R_d[..., 1, 1] + R_d[..., 2, 2] - 1) * 0.5, -1.0, 1.0)
    r_err = np.degrees(np.arccos(tr))
    # Translation direction angle (sign-invariant, as in the reference)
    ne = np.linalg.norm(t_e, axis=-1)
    ng = np.linalg.norm(t_g, axis=-1)
    cos = np.abs(np.sum(t_e * t_g, axis=-1)) / np.maximum(ne * ng, 1e-15)
    t_err = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    t_err = np.where((ne < 1e-12) & (ng < 1e-12), 0.0, t_err)
    err = np.maximum(r_err, t_err)
    ok = registered[iu] & registered[ju]
    err[~ok] = np.inf
    return err


def evaluate_poses(
    est: Dict[str, tuple],
    gt: Dict[str, tuple],
    thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
) -> Dict[str, float]:
    """est/gt map image name -> (qvec, tvec); images absent from est count as
    unregistered. Returns {"auc@T": value} plus the raw error count."""
    names = sorted(gt.keys())
    n = len(names)
    qg = np.stack([np.asarray(gt[k][0], dtype=np.float64) for k in names])
    tg = np.stack([np.asarray(gt[k][1], dtype=np.float64) for k in names])
    qe = np.zeros((n, 4)); qe[:, 0] = 1.0
    te = np.zeros((n, 3))
    reg = np.zeros(n, dtype=bool)
    for i, k in enumerate(names):
        if k in est:
            qe[i], te[i] = np.asarray(est[k][0]), np.asarray(est[k][1])
            reg[i] = True
    errs = all_pairs_relative_errors(qe, te, reg, qg, tg)
    aucs = pose_auc(errs, thresholds)
    out = {f"auc@{t}": a for t, a in zip(thresholds, aucs)}
    out["n_pairs"] = float(len(errs))
    out["n_registered"] = float(reg.sum())
    return out
