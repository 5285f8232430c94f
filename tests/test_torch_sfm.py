"""The port's two-view, PnP and BA estimators and its track builder
against the JAX package's, on the same seeded inputs and the same draws.

Run as a script, this file records the JAX numbers that chip_smoke.py's
geometry phase holds the card to: the dense fp32 JAX engine's matches on
generate_scene(seed=0, size=832, n_views=4) and the cached
tests/data/demo_cached_832 matches, through the smoke's own glue with the
JAX package's estimators and the mapper's content-hash keys:

    JAX_PLATFORMS=cpu python tests/test_torch_sfm.py --record
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from detectorfreesfm_tpu.sfm import ba as jba  # noqa: E402
from detectorfreesfm_tpu.sfm import pnp as jpnp  # noqa: E402
from detectorfreesfm_tpu.sfm import twoview as jtv  # noqa: E402
from detectorfreesfm_tpu_torch.sfm import ba as tba  # noqa: E402
from detectorfreesfm_tpu_torch.sfm import pnp as tpnp  # noqa: E402
from detectorfreesfm_tpu_torch.sfm import twoview as ttv  # noqa: E402
from detectorfreesfm_tpu_torch.utils import prng  # noqa: E402


def _rot(rng, sigma):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(0, sigma, 3)).as_matrix()


def _pairs(seed, B=3, N=256, planar=(), outliers=0.3, noise=1e-3):
    """B two-view problems in normalized coords, padded to N with a
    shrinking live count per row; `planar` rows put every point on a
    fronto-parallel plane."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, N, 2), np.float32)
    x1 = np.zeros_like(x0)
    mask = np.zeros((B, N), bool)
    for b in range(B):
        n = N - 30 * b
        X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]
        if b in planar:
            X[:, 2] = 5.0
        R, t = _rot(rng, 0.1), np.array([1.0, 0.1, 0.05])
        Xc = X @ R.T + t
        a = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
        c = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise, (n, 2))
        out = rng.uniform(size=n) < outliers
        c[out] = rng.uniform(-0.3, 0.3, (out.sum(), 2))
        x0[b, :n], x1[b, :n], mask[b, :n] = a, c, True
    keys = prng.stable_rngs([("verify", "p", b, 0) for b in range(B)])
    return x0, x1, mask, keys, np.full(B, 3e-3, np.float32)


def _gumbel(keys, shape):
    return prng.gumbel(keys, shape, device="cpu")


def _jnp(*xs):
    return [jnp.asarray(x) for x in xs]


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


# Tolerances: inlier sets identical on general-position scenes; poses
# within 2e-4 (quaternion components) and 1e-3 (unit translation), the
# float32 spread of two LAPACK-backed QR/SVD chains.


def test_relative_pose_batch_equals_jax():
    x0, x1, mask, keys, thr = _pairs(0)
    H = 128
    ref = jtv.estimate_relative_pose_batch(*_jnp(x0, x1, mask, keys, thr),
                                           n_hypotheses=H)
    got = ttv.estimate_relative_pose_batch(
        x0, x1, mask, _gumbel(keys, (H, x0.shape[1])), thr, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_array_equal(got.n_inliers.numpy(),
                                  np.asarray(ref.n_inliers))
    np.testing.assert_allclose(got.qvec.numpy(), np.asarray(ref.qvec),
                               atol=2e-4)
    np.testing.assert_allclose(got.tvec.numpy(), np.asarray(ref.tvec),
                               atol=1e-3)
    # E up to sign (null vectors are defined up to sign)
    E_t, E_j = got.E.numpy(), np.asarray(ref.E)
    sign = np.sign(np.sum(E_t * E_j, axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(E_t * sign, E_j, atol=1e-4)
    # the single-pair entry point (JAX's estimate_relative_pose, one key)
    one = ttv.estimate_relative_pose(x0[1], x1[1], mask[1],
                                     _gumbel(keys[1], (H, x0.shape[1])),
                                     float(thr[1]), device="cpu")
    ref1 = jtv.estimate_relative_pose(*_jnp(x0[1], x1[1], mask[1], keys[1]),
                                      float(thr[1]), n_hypotheses=H)
    np.testing.assert_array_equal(one.inliers.numpy(),
                                  np.asarray(ref1.inliers))
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    uv = (x0[0] * 500 + 300).astype(np.float32)
    np.testing.assert_allclose(
        ttv.normalize_points(torch.from_numpy(uv), torch.from_numpy(K)),
        np.asarray(jtv.normalize_points(*_jnp(uv, K))), atol=1e-6)


def test_homography_batch_equals_jax():
    x0, x1, mask, keys, thr = _pairs(1, planar=(0, 1, 2))
    H = 64
    ref = jtv.estimate_homography_batch(*_jnp(x0, x1, mask, keys, thr),
                                        n_hypotheses=H)
    got = ttv.estimate_homography_batch(
        x0, x1, mask, _gumbel(keys, (H, x0.shape[1])), thr, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    Hn_t = got.H.numpy() / np.linalg.norm(got.H.numpy(), axis=(1, 2),
                                          keepdims=True)
    Hn_j = np.asarray(ref.H) / np.linalg.norm(np.asarray(ref.H), axis=(1, 2),
                                              keepdims=True)
    sign = np.sign(np.sum(Hn_t * Hn_j, axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(Hn_t * sign, Hn_j, atol=1e-4)
    one = ttv.estimate_homography(x0[0], x1[0], mask[0],
                                  _gumbel(keys[0], (H, x0.shape[1])),
                                  float(thr[0]), device="cpu")
    ref1 = jtv.estimate_homography(*_jnp(x0[0], x1[0], mask[0], keys[0]),
                                   float(thr[0]), n_hypotheses=H)
    np.testing.assert_array_equal(one.inliers.numpy(),
                                  np.asarray(ref1.inliers))


def test_planar_scene_takes_the_same_e_or_h_decision():
    """tests/test_twoview_degeneracy.py's planar scene: the port and JAX,
    fed the same draws, take the same E-versus-H decision (verify_pairs'
    planar_h_ratio rule) with inlier IoU >= 0.98, and decompose_homography
    gives the same pose (2e-3 on R, 1e-2 on unit t)."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_twoview_degeneracy import _planar_pair

    x0, x1, _R, _t = _planar_pair(n=256)
    n_pad = 256
    X0 = np.zeros((1, n_pad, 2), np.float32)
    X1 = np.zeros_like(X0)
    M = np.zeros((1, n_pad), bool)
    X0[0, :len(x0)], X1[0, :len(x0)], M[0, :len(x0)] = x0, x1, True
    thr = np.array([2e-3], np.float32)
    ke = prng.stable_rngs([("verify", "a", "b", 0)])
    kh = prng.stable_rngs([("homog", "a", "b")])
    je = jtv.estimate_relative_pose_batch(*_jnp(X0, X1, M, ke, thr),
                                          n_hypotheses=512)
    jh = jtv.estimate_homography_batch(*_jnp(X0, X1, M, kh, thr),
                                       n_hypotheses=256)
    te = ttv.estimate_relative_pose_batch(
        X0, X1, M, _gumbel(ke, (512, n_pad)), thr, device="cpu")
    th = ttv.estimate_homography_batch(
        X0, X1, M, _gumbel(kh, (256, n_pad)), thr, device="cpu")

    def decide(n_e, n_h):
        return n_h / max(n_e, 1) > 0.8 and n_h >= n_e

    dj = decide(int(je.n_inliers[0]), int(jh.n_inliers[0]))
    dt = decide(int(te.n_inliers[0]), int(th.n_inliers[0]))
    assert dj == dt
    assert _iou(np.asarray(jh.inliers[0]), th.inliers[0].numpy()) >= 0.98
    assert _iou(np.asarray(je.inliers[0]), te.inliers[0].numpy()) >= 0.98
    Rj, tj, _ = jtv.decompose_homography(jh.H[0], *_jnp(X0[0], X1[0]),
                                         jh.inliers[0], jnp.asarray(M[0]))
    Rt, tt, _ = ttv.decompose_homography(th.H[0], X0[0], X1[0],
                                         th.inliers[0], M[0], device="cpu")
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=2e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-2)


def _pnp_problems(seed, B=3, N=200, outliers=0.4, noise=1e-3):
    rng = np.random.default_rng(seed)
    X = np.zeros((B, N, 3), np.float32)
    x = np.zeros((B, N, 2), np.float32)
    mask = np.zeros((B, N), bool)
    poses = []
    for b in range(B):
        n = N - 40 * b
        P = rng.uniform(-1, 1, (n, 3)) + [0, 0, 4]
        R, t = _rot(rng, 0.2), rng.normal(0, 0.3, 3)
        poses.append((R, t))
        Pc = P @ R.T + t
        uv = Pc[:, :2] / Pc[:, 2:] + rng.normal(0, noise, (n, 2))
        out = rng.uniform(size=n) < outliers
        uv[out] = rng.uniform(-0.5, 0.5, (out.sum(), 2))
        X[b, :n], x[b, :n], mask[b, :n] = P, uv, True
    keys = prng.stable_rngs([("register", f"im{b}", 100, 0)
                             for b in range(B)])
    return X, x, mask, keys, np.full(B, 4e-3, np.float32), poses


def test_absolute_pose_batch_and_refine_equal_jax():
    X, x, mask, keys, thr, _poses = _pnp_problems(1)
    H = 64
    ref = jpnp.estimate_absolute_pose_batch(*_jnp(X, x, mask, keys, thr),
                                            n_hypotheses=H)
    got = tpnp.estimate_absolute_pose_batch(
        X, x, mask, _gumbel(keys, (H, X.shape[1])), thr, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.qvec.numpy(), np.asarray(ref.qvec),
                               atol=1e-5)
    np.testing.assert_allclose(got.tvec.numpy(), np.asarray(ref.tvec),
                               atol=1e-4)
    one = tpnp.estimate_absolute_pose(X[2], x[2], mask[2],
                                      _gumbel(keys[2], (H, X.shape[1])),
                                      float(thr[2]), device="cpu")
    ref1 = jpnp.estimate_absolute_pose(*_jnp(X[2], x[2], mask[2], keys[2]),
                                       float(thr[2]), n_hypotheses=H)
    np.testing.assert_array_equal(one.inliers.numpy(),
                                  np.asarray(ref1.inliers))
    qj, tj = jpnp.refine_pose(ref.qvec[0], ref.tvec[0], *_jnp(X[0], x[0]),
                              ref.inliers[0])
    qt, tt = tpnp.refine_pose(got.qvec[0], got.tvec[0], X[0], x[0],
                              got.inliers[0], device="cpu")
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


def test_p3p_roots_and_candidates_equal_jax():
    """Durand-Kerner roots (complex64) against JAX's on random quartics
    (1e-4); and P3P on 32 exact, outlier-free 3-point samples: each package
    finds a valid candidate within 1e-3 of the true pose in at least 28 of
    them, and where both do, those candidates agree within 1e-3. Both miss
    the true root on the same few ill-conditioned samples, whose roots
    cluster and which f32 resolves differently on each backend (measured:
    2-3 of 32 per seed for each package); RANSAC's consensus absorbs it."""
    X, x, _m, _k, _t, poses = _pnp_problems(2, B=1, N=96, outliers=0.0,
                                            noise=0.0)
    R_true, t_true = poses[0]
    Xs = X[0].reshape(32, 3, 3)
    xs = x[0].reshape(32, 3, 2)
    Rj, tj, vj = (np.asarray(a) for a in jpnp._p3p_candidates(
        *_jnp(Xs, xs)))
    Rt, tt, vt = (a.numpy() for a in tpnp._p3p_candidates(
        torch.from_numpy(Xs), torch.from_numpy(xs)))

    def best(R, t, v):
        d = (np.abs(R - R_true).max(axis=(-2, -1))
             + np.abs(t - t_true).max(-1))
        d = np.where(v, d, np.inf)
        k = d.argmin(-1)
        rows = np.arange(len(k))
        return R[rows, k], t[rows, k], d[rows, k] < 1e-3

    bRj, btj, hit_j = best(Rj, tj, vj)
    bRt, btt, hit_t = best(Rt, tt, vt)
    assert hit_j.sum() >= 28 and hit_t.sum() >= 28, (hit_j.sum(),
                                                      hit_t.sum())
    both = hit_j & hit_t
    np.testing.assert_allclose(bRt[both], bRj[both], atol=1e-3)
    np.testing.assert_allclose(btt[both], btj[both], atol=1e-3)
    coef = np.random.default_rng(3).normal(0, 1, (16, 5)).astype(np.float32)
    rj = np.asarray(jpnp._quartic_roots(jnp.asarray(coef)))
    rt = tpnp._quartic_roots(torch.from_numpy(coef)).numpy()
    dist = np.abs(rt[:, :, None] - rj[:, None, :])   # same roots, any order
    assert dist.min(2).max() < 1e-4 and dist.min(1).max() < 1e-4


# --- bundle adjustment --------------------------------------------------------


def _ba_problem(n_cams=6, n_pts=120, seed=12, noise=0.5):
    sys.path.insert(0, os.path.dirname(__file__))
    from test_sfm import _synthetic_scene

    from detectorfreesfm_tpu_torch.core.geometry import np_rotmat_to_quat

    pts, K, Rs, ts, uvs = _synthetic_scene(n_cams=n_cams, n_pts=n_pts,
                                           seed=seed)
    rng = np.random.default_rng(seed + 1)
    qvec = np_rotmat_to_quat(np.stack(Rs))
    tvec = np.stack(ts)
    tvec[2:] += rng.normal(0, 0.05, (n_cams - 2, 3))
    pts_noisy = pts + rng.normal(0, 0.03, pts.shape)
    obs_uv = np.concatenate(uvs) + rng.normal(0, noise, (n_cams * n_pts, 2))
    obs_cam = np.repeat(np.arange(n_cams), n_pts)
    obs_pt = np.tile(np.arange(n_pts), n_cams)
    intr = np.tile(np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
                   (n_cams, 1))
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    return (qvec, tvec, intr, pts_noisy, obs_uv, obs_cam, obs_pt), fixed


def _problems(args, fixed, refine_focal=True, refine_dist=True):
    """The same BAProblem for both packages (the driver's normalization)."""
    qvec, tvec, intr, pts, obs_uv, obs_cam, obs_pt = args
    from detectorfreesfm_tpu_torch.core.geometry import np_quat_to_rotmat

    C, P, O = len(qvec), len(pts), len(obs_uv)
    intr5 = np.concatenate([intr, np.full((C, 1), 0.01)], 1)
    R = np_quat_to_rotmat(qvec)
    order = np.argsort(obs_pt, kind="stable")
    T = int(np.bincount(obs_pt).max())
    track_obs = np.full((P, T), O, np.int64)
    track_mask = np.zeros((P, T), bool)
    starts = np.concatenate([[0], np.cumsum(np.bincount(obs_pt))[:-1]])
    rank = np.arange(O) - starts[obs_pt[order]]
    track_obs[obs_pt[order], rank] = order
    track_mask[obs_pt[order], rank] = True
    pose_free = np.ones((C, 6), np.float32)
    pose_free[fixed] = 0.0
    pad = lambda a, v: np.concatenate(  # noqa: E731
        [a, np.full((1,) + a.shape[1:], v, a.dtype)])
    common = dict(cam_R=R, cam_t=tvec, intr=intr5, points=pts,
                  obs_uv=pad(obs_uv, 0.0), obs_cam=pad(obs_cam, 0),
                  obs_pt=pad(obs_pt, 0), obs_mask=pad(np.ones(O, bool), False),
                  track_obs=track_obs, track_mask=track_mask,
                  fixed_cams=fixed, pose_free=pose_free)
    jp = jba.BAProblem(**{
        k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else (
            bool if v.dtype == bool else jnp.float32))
        for k, v in common.items()},
        refine_focal=jnp.asarray(refine_focal),
        refine_dist=jnp.asarray(refine_dist))
    tp = tba.BAProblem(**{
        k: torch.as_tensor(v, dtype=torch.int64 if v.dtype.kind == "i" else (
            torch.bool if v.dtype == bool else torch.float32))
        for k, v in common.items()},
        refine_focal=refine_focal, refine_dist=refine_dist)
    return jp, tp


def test_ba_jacobians_equal_jax():
    """vmap(jacfwd) of the projection residual: the camera (2x8) and point
    (2x3) Jacobians, k1 and focal columns included, within 1e-3 relative
    (pixel-scale entries)."""
    args, fixed = _ba_problem()
    jp, tp = _problems(args, fixed)
    rj, Aj, Bj = jba._jacobians(jp)
    rt, At, Bt = tba._jacobians(tp)
    for a, b in ((rt, rj), (At, Aj), (Bt, Bj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3,
                                   atol=1e-3 * np.abs(b).max())


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_ba_one_lm_step_equals_jax(solver):
    """One damped LM step of each solver: the proposed poses and points
    within 1e-4 of JAX's, the same ba_cost, the same CG iterations."""
    args, fixed = _ba_problem()
    jp, tp = _problems(args, fixed)
    lam = 1e-3
    if solver == "dense":
        ref = jba.lm_step(jp, jnp.float32(lam))
        got = tba.lm_step(tp, torch.tensor(lam))
    else:
        ref = jba.lm_step_pcg(jp, jnp.float32(lam))
        got = tba.lm_step_pcg(tp, torch.tensor(lam))
        assert got[4] == int(ref[4])
    for a, b in zip(got[:4], ref[:4]):  # focals ~500: relative there
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-4)
    np.testing.assert_allclose(float(tba.ba_cost(tp)), float(jba.ba_cost(jp)),
                               rtol=1e-5)


def test_ba_pcg_reaches_the_dense_step():
    """The PCG iterate, run to a tight tolerance, is the dense Cholesky
    step (1e-4 on poses and points, 1e-6 relative on focals)."""
    args, fixed = _ba_problem()
    _jp, tp = _problems(args, fixed)
    dense = tba.lm_step(tp, torch.tensor(1e-3))
    pcg = tba.lm_step_pcg(tp, torch.tensor(1e-3), cg_iters=300, cg_rtol=1e-7)
    for a, b in zip(dense, pcg[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-4)


@pytest.mark.parametrize("gauge,refine_focal", [
    ("similarity", True), ("full", False), ("auto", False)])
def test_bundle_adjust_equals_jax(gauge, refine_focal):
    """The whole LM driver per gauge: final cost per observation within 1%
    of JAX's, poses within 1e-3, points within 1e-3 (scene units ~5)."""
    args, fixed = _ba_problem()
    kw = dict(fixed_cams=fixed, max_iters=15, gauge=gauge,
              refine_focal=refine_focal)
    ref = jba.bundle_adjust(*args, **kw)
    info = {}
    got = tba.bundle_adjust(*args, device="cpu", info=info, **kw)
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-2)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-3)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-3)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-3)
    assert info["solver"] == "dense" and info["iterations"] >= 1


def test_bundle_adjust_pcg_matches_dense():
    """tests/test_sfm.py's dense-vs-PCG check on the port (same bounds)."""
    args, fixed = _ba_problem(noise=0.0)
    kw = dict(fixed_cams=fixed, max_iters=15, device="cpu")
    qd, td, _, _, cd = tba.bundle_adjust(*args, schur_mode="dense", **kw)
    info = {}
    qp, tp, _, _, cp = tba.bundle_adjust(*args, schur_mode="pcg", info=info,
                                         **kw)
    assert info["solver"] == "pcg" and info["cg_iterations"] > 0
    np.testing.assert_allclose(cd, cp, rtol=0.1, atol=1e-3)
    np.testing.assert_allclose(qd, qp, atol=2e-3)
    np.testing.assert_allclose(td, tp, atol=2e-2)


def test_cholesky_failure_gives_the_rejected_nan_step():
    """A rank-deficient camera system (a camera whose points sit at one
    depth along its axis, with k1 and focal free and no observations
    elsewhere) is not positive definite: JAX's cho_solve gives NaN and so
    does the port's cholesky_ex path, and the LM driver rejects the step
    instead of raising."""
    args, fixed = _ba_problem(n_cams=3, n_pts=40)
    jp, tp = _problems(args, fixed)
    # Break positive definiteness: a negative damping cancels the diagonal.
    ref = jba.lm_step(jp, jnp.float32(-1.5))
    got = tba.lm_step(tp, torch.tensor(-1.5))
    assert not np.isfinite(np.asarray(ref[1])).all()
    assert not torch.isfinite(got[1]).all()
    assert not np.isfinite(float(jba.ba_cost(jp._replace(
        cam_R=ref[0], cam_t=ref[1], intr=ref[2], points=ref[3]))))
    assert not np.isfinite(float(tba.ba_cost(tp._replace(
        cam_R=got[0], cam_t=got[1], intr=got[2], points=got[3]))))


def test_bundle_adjust_rejects_bad_gauges():
    args, fixed = _ba_problem(n_cams=3, n_pts=20)
    one = np.zeros(3, bool)
    one[0] = True
    with pytest.raises(ValueError, match="exactly 2 fixed"):
        tba.bundle_adjust(*args, fixed_cams=one, gauge="similarity",
                          device="cpu")
    with pytest.raises(ValueError, match="unknown gauge"):
        tba.bundle_adjust(*args, fixed_cams=fixed, gauge="bogus",
                          device="cpu")


# --- tracks ---------------------------------------------------------------------


def _track_inputs(seed, n_imgs=6, n_kp=400, n_pts=300):
    """Matches of n_pts scene points seen in random image subsets, plus a
    few wrong matches that chain tracks into conflicts."""
    rng = np.random.default_rng(seed)
    kp_of = {i: rng.permutation(n_kp)[:n_pts] for i in range(n_imgs)}
    seen = rng.uniform(size=(n_pts, n_imgs)) < 0.6
    matches = {}
    for a in range(n_imgs):
        for b in range(a + 1, n_imgs):
            both = np.flatnonzero(seen[:, a] & seen[:, b])
            m = np.stack([kp_of[a][both], kp_of[b][both]], 1)
            bad = rng.integers(0, n_kp, (3, 2))
            matches[(a, b)] = np.concatenate([m, bad]).astype(np.int32)
    return {i: n_kp for i in range(n_imgs)}, matches


@pytest.mark.parametrize("seed", [0, 1])
def test_tracks_native_python_and_jax_agree(seed):
    """The port's g++-built union-find, its Python one and the JAX
    package's build_tracks give identical tracks."""
    from detectorfreesfm_tpu.sfm.tracks import build_tracks as jax_tracks
    from detectorfreesfm_tpu_torch.sfm import tracks as T

    n_kpts, matches = _track_inputs(seed)
    native = T.build_tracks(n_kpts, matches, builder="native")
    assert T.last_builder == "native"
    python = T.build_tracks(n_kpts, matches, builder="python")
    assert T.last_builder == "python"
    ref = jax_tracks(n_kpts, matches)
    obs = [t.observations for t in native]
    assert len(obs) > 100
    assert obs == [t.observations for t in python]
    assert obs == [t.observations for t in ref]
    capped = T.build_tracks(n_kpts, matches, min_track_length=3,
                            max_track_length=4)
    assert [t.observations for t in capped] == [
        t.observations for t in jax_tracks(n_kpts, matches, 3, 4)]
    assert T.library_path().parent.name == "native"
    assert "build" in T.library_path().parts


# --- the script mode: JAX numbers for chip_smoke.py -------------------------


class JaxGeometry:
    """The JAX package's estimators behind chip_smoke.PortGeometry's
    interface (numpy in and out), keyed by the same raw uint32 keys."""

    def relpose(self, x0, x1, mask, keys, thr, n_hyp):
        r = jtv.estimate_relative_pose_batch(*_jnp(x0, x1, mask, keys, thr),
                                             n_hypotheses=n_hyp)
        return dict(n=np.asarray(r.n_inliers), inliers=np.asarray(r.inliers),
                    q=np.asarray(r.qvec, np.float64),
                    t=np.asarray(r.tvec, np.float64))

    def homography(self, x0, x1, mask, keys, thr, n_hyp):
        r = jtv.estimate_homography_batch(*_jnp(x0, x1, mask, keys, thr),
                                          n_hypotheses=n_hyp)
        return dict(n=np.asarray(r.n_inliers), inliers=np.asarray(r.inliers),
                    H=np.asarray(r.H))

    def decompose(self, H, x0, x1, inliers, mask):
        from detectorfreesfm_tpu.core.geometry import rotmat_to_quat

        R, t, _n = jtv.decompose_homography(*_jnp(H, x0, x1, inliers, mask))
        return (np.asarray(rotmat_to_quat(R), np.float64),
                np.asarray(t, np.float64))

    def triangulate(self, P, uv, mask):
        from detectorfreesfm_tpu.core.triangulation import triangulate_dlt

        X, ok = triangulate_dlt(*_jnp(P, uv, mask))
        return np.asarray(X), np.asarray(ok)

    def pnp(self, X, x, mask, keys, thr, n_hyp):
        r = jpnp.estimate_absolute_pose_batch(*_jnp(X, x, mask, keys, thr),
                                              n_hypotheses=n_hyp)
        return dict(n=np.asarray(r.n_inliers), inliers=np.asarray(r.inliers),
                    q=np.asarray(r.qvec, np.float64),
                    t=np.asarray(r.tvec, np.float64))

    def refine(self, q, t, X, x, mask):
        q2, t2 = jpnp.refine_pose(*_jnp(q.astype(np.float32),
                                        t.astype(np.float32), X, x, mask))
        return np.asarray(q2, np.float64), np.asarray(t2, np.float64)

    def ba(self, args, kw):
        return jba.bundle_adjust(*args, **kw), {}

    def tracks(self, n_kpts, matches, builder="native"):
        from detectorfreesfm_tpu.sfm.tracks import build_tracks

        return build_tracks(n_kpts, matches)


def record_jax_reference():
    """Print the JAX package's geometry numbers on the smoke's inputs."""
    import json
    import time

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(__file__))
    import chip_smoke
    from test_torch_engine import _jax_engine_matches, _scene

    from detectorfreesfm_tpu.data.h5io import load_h5
    from detectorfreesfm_tpu.ops.grid_merge import merge_matches_to_keypoints
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    t0 = time.time()
    images, _d, _K, _q, _t = _scene(832, 4)
    names = [f"view_{i}" for i in range(4)]
    raw = _jax_engine_matches(images, names, exhaustive_pairs(names), 832)
    keypoints, _s, match_indices = merge_matches_to_keypoints(raw)
    data = os.path.join(REPO, "tests", "data", "demo_cached_832")
    demo_kps = load_h5(os.path.join(data, "keypoints.h5"))
    demo_matches = {tuple(k.split("|")): v.astype(np.int32) for k, v in
                    load_h5(os.path.join(data, "matches.h5")).items()}
    ref = chip_smoke.geometry_reference(JaxGeometry(), keypoints,
                                        match_indices, demo_kps, demo_matches)
    print(json.dumps(dict(ref, seconds=time.time() - t0)), flush=True)


if __name__ == "__main__":
    if "--record" not in sys.argv:
        sys.exit("usage: python tests/test_torch_sfm.py --record")
    record_jax_reference()


def test_smoke_geometry_gates_hold_the_card_to_jax():
    """chip_smoke.py's geometry gates accept the recorded JAX numbers, a
    count on JAX's other one-ulp attractor, and a switch flip on a
    knife-edge pair whose E and H inlier sets agree; they reject a count
    2% off, a flipped decision on a clear pair, a knife-edge flip whose
    E and H sets differ, a worse seed pose and a worse BA cost."""
    import copy

    import chip_smoke

    ref = chip_smoke.JAX_GEOMETRY
    got = copy.deepcopy(ref)
    chip_smoke._check_gates(got, ref)
    multi = [k for k, v in ref["count_trials"].items() if len(v) > 1]
    for k in multi:
        part = "two_view_a" if k in ref["two_view_a"] else "two_view_b"
        got[part][k]["n_e"], got[part][k]["n_h"] = ref["count_trials"][k][-1]
    # the card's outcome on the knife-edge synthetic pair (its first run)
    got["two_view_a"]["view_1|view_3"] = dict(n_e=1972, n_h=1972,
                                              switch=True, kept=True,
                                              eh_iou=0.999)
    chip_smoke._check_gates(got, ref)
    pair = next(k for k, v in ref["two_view_b"].items()
                if len(ref["count_trials"][k]) == 1)

    def broken(edit):
        bad = copy.deepcopy(got)
        edit(bad)
        with pytest.raises(RuntimeError, match="chip_smoke check failed"):
            chip_smoke._check_gates(bad, ref)

    broken(lambda b: b["two_view_b"][pair].update(
        n_e=int(ref["two_view_b"][pair]["n_e"] * 1.02) + 1))
    broken(lambda b: b["two_view_b"][pair].update(switch=True))
    broken(lambda b: b["two_view_a"]["view_1|view_3"].update(eh_iou=0.9))
    broken(lambda b: b["pose_err_a"].update(
        {"view_0|view_1": (1.0, 0.0)}))
    broken(lambda b: b.update(ba4_cost_per_obs=ref["ba4_cost_per_obs"] * 1.1))
    broken(lambda b: b.update(n_points=int(ref["n_points"] * 0.98)))
