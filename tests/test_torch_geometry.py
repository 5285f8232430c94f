"""The port's core geometry (geometry, epipolar, triangulation, precision)
and its reproduction of JAX's random draws (utils/prng.py), against the
JAX package on the same seeded inputs.

Tolerances are stated per test: float32 functions agree within a few
float32 ulps of their output scale (1e-5 on unit-scale values), the numpy
copies bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectorfreesfm_tpu.core import epipolar as JE
from detectorfreesfm_tpu.core import geometry as JG
from detectorfreesfm_tpu.core import triangulation as JT
from detectorfreesfm_tpu_torch.core import epipolar as TE
from detectorfreesfm_tpu_torch.core import geometry as TG
from detectorfreesfm_tpu_torch.core import triangulation as TT
from detectorfreesfm_tpu_torch.utils import prng


def _q(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(a, b, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(a.numpy() if isinstance(a, torch.Tensor)
                               else a, np.asarray(b), atol=atol, rtol=rtol)


def _near_pi_rotations():
    """Rotations by pi (and pi - 1e-3) about assorted axes: the trace is
    -1 and rotmat_to_quat must seed from the largest diagonal entry."""
    axes = np.array([(1, 0, 0), (0, 1, 0), (0, 0, 1), (0.6, 0.8, 0.0),
                     (0.0, 0.6, -0.8), (1, 1, 1)], np.float64)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w = np.concatenate([axes * np.pi, axes * (np.pi - 1e-3)])
    return np.asarray(JG.so3_exp(jnp.asarray(w, jnp.float32)))


@pytest.mark.parametrize("case", ["random", "near_pi"])
def test_quaternions_equal_jax(case):
    """quat_to_rotmat / rotmat_to_quat (Shepperd, w-first, canonical w >= 0)
    and the numpy copies: torch within 1e-6 of jnp, numpy bit for bit."""
    rng = np.random.default_rng(0)
    if case == "random":
        q = _q(rng, 64)
        R = np.asarray(JG.quat_to_rotmat(jnp.asarray(q)))
        _close(TG.quat_to_rotmat(_t(q)), R, atol=1e-6)
    else:
        R = _near_pi_rotations()
    _close(TG.rotmat_to_quat(_t(R)), JG.rotmat_to_quat(jnp.asarray(R)),
           atol=1e-6)
    R64 = R.astype(np.float64)
    np.testing.assert_array_equal(TG.np_rotmat_to_quat(R64),
                                  JG.np_rotmat_to_quat(R64))
    q64 = TG.np_rotmat_to_quat(R64)
    np.testing.assert_array_equal(TG.np_quat_to_rotmat(q64),
                                  JG.np_quat_to_rotmat(q64))


def test_se3_and_so3_equal_jax():
    """se3 apply/inverse/compose, camera centers, relative pose, so3 exp
    and log (including the Taylor branch at 0 and the near-pi branch),
    quat_normalize/multiply: within 1e-5."""
    rng = np.random.default_rng(1)
    qa, qb = _q(rng, 8), _q(rng, 8)
    ta, tb = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
    pts = rng.normal(size=(8, 5, 3)).astype(np.float32)
    J = [jnp.asarray(x) for x in (qa, ta, qb, tb, pts)]
    T = [_t(x) for x in (qa, ta, qb, tb, pts)]
    _close(TG.se3_apply(T[0], T[1], T[4]), JG.se3_apply(J[0], J[1], J[4]))
    for a, b in zip(TG.se3_inverse(T[0], T[1]), JG.se3_inverse(J[0], J[1])):
        _close(a, b)
    for a, b in zip(TG.se3_compose(*T[:4]), JG.se3_compose(*J[:4])):
        _close(a, b)
    for a, b in zip(TG.relative_pose(*T[:4]), JG.relative_pose(*J[:4])):
        _close(a, b)
    _close(TG.camera_center(T[0], T[1]), JG.camera_center(J[0], J[1]))
    _close(TG.quat_multiply(T[0], T[2]), JG.quat_multiply(J[0], J[2]))
    _close(TG.quat_normalize(-T[0]), JG.quat_normalize(-J[0]))
    w = rng.normal(size=(32, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(
        0, 3.1, (32, 1)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-5
    _close(TG.so3_exp(_t(w)), JG.so3_exp(jnp.asarray(w)))
    R = np.concatenate([np.asarray(JG.so3_exp(jnp.asarray(w))),
                        _near_pi_rotations()]).astype(np.float32)
    _close(TG.so3_log(_t(R)), JG.so3_log(jnp.asarray(R)), atol=2e-4)


def test_so3_exp_jacobian_at_zero_equals_jax():
    """BA and PnP differentiate so3_exp at w = 0 (forward mode): the port's
    jacfwd equals jax.jacfwd there and is finite."""
    w = np.zeros(3, np.float32)
    ref = np.asarray(jax.jacfwd(JG.so3_exp)(jnp.asarray(w)))
    got = torch.func.jacfwd(TG.so3_exp)(_t(w))
    assert torch.isfinite(got).all()
    _close(got, ref, atol=1e-7)


def test_projection_and_angles_equal_jax():
    """project/unproject, intrinsics_to_K, rotation and translation angles
    and the numpy SIMPLE_RADIAL helpers: within 1e-4 px / 1e-4 deg, the
    numpy copies bit for bit."""
    rng = np.random.default_rng(3)
    q, t = _q(rng, 1)[0], rng.normal(size=3).astype(np.float32)
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    pts = (rng.normal(size=(50, 3)) + [0, 0, 6]).astype(np.float32)
    pts[0] = [0, 0, 0]  # near-zero depth guard
    uv_j, d_j = JG.project(*(jnp.asarray(x) for x in (pts, q, t, K)))
    uv_t, d_t = TG.project(*(_t(x) for x in (pts, q, t, K)))
    _close(uv_t, uv_j, atol=1e-2, rtol=1e-5)
    _close(d_t, d_j)
    _close(TG.unproject(uv_t, d_t, _t(K)), JG.unproject(uv_j, d_j,
                                                         jnp.asarray(K)),
           atol=1e-3, rtol=1e-4)
    _close(TG.intrinsics_to_K(_t(np.float32(500.0)), _t(np.float32(480.0)),
                              _t(np.float32(320.0)), _t(np.float32(240.0))),
           JG.intrinsics_to_K(500.0, 480.0, 320.0, 240.0))
    R = np.asarray(JG.so3_exp(jnp.asarray(rng.normal(size=(16, 3)),
                                          jnp.float32)))
    _close(TG.rotation_angle_deg(_t(R)), JG.rotation_angle_deg(
        jnp.asarray(R)), atol=1e-3)
    ta, tb = (rng.normal(size=(16, 3)).astype(np.float32) for _ in range(2))
    tb[0] = 0.0
    ta[1] = tb[1] = 0.0
    _close(TG.translation_angle_deg(_t(ta), _t(tb)),
           JG.translation_angle_deg(jnp.asarray(ta), jnp.asarray(tb)),
           atol=1e-3)
    xy = rng.normal(size=(20, 2)) * 0.3
    Kd = K.astype(np.float64)
    uv = xy * 500 + 300
    for k1 in (0.0, -0.08, 0.05):
        for name in ("np_radial_distort", "np_radial_undistort"):
            np.testing.assert_array_equal(getattr(TG, name)(xy, k1),
                                          getattr(JG, name)(xy, k1))
        for name in ("np_undistort_pixels", "np_distort_pixels"):
            np.testing.assert_array_equal(getattr(TG, name)(uv, Kd, k1),
                                          getattr(JG, name)(uv, Kd, k1))
    assert TG.CAMERA_MODEL_IDS == JG.CAMERA_MODEL_IDS
    assert TG.CAMERA_MODEL_NUM_PARAMS == JG.CAMERA_MODEL_NUM_PARAMS


def test_epipolar_equals_jax():
    """skew, essential/fundamental matrices, Sampson and symmetric epipolar
    distances (relative 1e-4), the candidate set of decompose_essential
    (each JAX candidate is one of the port's: SVD signs differ by backend)
    and the midpoint depths."""
    rng = np.random.default_rng(4)
    q0, q1 = _q(rng, 2)
    t0, t1 = rng.normal(size=(2, 3)).astype(np.float32)
    K = np.array([[600.0, 0, 300], [0, 600.0, 250], [0, 0, 1]], np.float32)
    pts = (rng.normal(size=(40, 3)) * 2 + [0, 0, 8]).astype(np.float32)
    uv0, _ = JG.project(*(jnp.asarray(x) for x in (pts, q0, t0, K)))
    uv1, _ = JG.project(*(jnp.asarray(x) for x in (pts, q1, t1, K)))
    uv0, uv1 = np.asarray(uv0), np.asarray(uv1)
    uv1 = uv1 + rng.normal(0, 1.0, uv1.shape).astype(np.float32)
    qr, tr = JG.relative_pose(*(jnp.asarray(x) for x in (q0, t0, q1, t1)))
    qr, tr = np.asarray(qr), np.asarray(tr)
    _close(TE.skew(_t(tr)), JE.skew(jnp.asarray(tr)))
    E_j = JE.essential_from_pose(jnp.asarray(qr), jnp.asarray(tr))
    E_t = TE.essential_from_pose(_t(qr), _t(tr))
    _close(E_t, E_j)
    F_j = JE.fundamental_from_essential(E_j, jnp.asarray(K), jnp.asarray(K))
    F_t = TE.fundamental_from_essential(E_t, _t(K), _t(K))
    _close(F_t, F_j, atol=1e-9, rtol=1e-4)
    for name in ("sampson_distance", "symmetric_epipolar_distance"):
        _close(getattr(TE, name)(F_t, _t(uv0), _t(uv1)),
               getattr(JE, name)(F_j, jnp.asarray(uv0), jnp.asarray(uv1)),
               atol=1e-4, rtol=1e-3)
    R_j, t_j = (np.asarray(a) for a in JE.decompose_essential(E_j))
    R_t, t_t = (a.numpy() for a in TE.decompose_essential(E_t))
    for k in range(4):
        d = [np.abs(R_t[m] - R_j[k]).max() + np.abs(t_t[m] - t_j[k]).max()
             for m in range(4)]
        assert min(d) < 1e-4, (k, d)
    x0 = (uv0 - K[:2, 2]) / K[0, 0]
    x1 = (uv1 - K[:2, 2]) / K[0, 0]
    R = np.asarray(JG.quat_to_rotmat(jnp.asarray(qr)))
    for a, b in zip(TE.triangulate_midpoint_depths(_t(R), _t(tr), _t(x0),
                                                   _t(x1)),
                    JE.triangulate_midpoint_depths(*(jnp.asarray(x) for x in
                                                     (R, tr, x0, x1)))):
        _close(a, b, atol=1e-4, rtol=1e-4)


def _tri_problem(seed, n=64, V=5):
    rng = np.random.default_rng(seed)
    q = _q(rng, V)
    t = (rng.normal(size=(V, 3)) * 0.5).astype(np.float32)
    t[:, 2] += 6.0
    K = np.tile(np.array([[700.0, 0, 400], [0, 700, 300], [0, 0, 1]],
                         np.float32), (V, 1, 1))
    X = rng.normal(size=(n, 3)).astype(np.float32)
    P = np.asarray(JT.projection_matrices(*(jnp.asarray(x) for x in
                                            (q, t, K))))
    Xh = np.concatenate([X, np.ones((n, 1), np.float32)], 1)
    proj = np.einsum("vij,nj->nvi", P, Xh)
    uv = (proj[..., :2] / proj[..., 2:]).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    mask = rng.uniform(size=(n, V)) < 0.7
    mask[:, :2] = True  # every track >= 2 views
    return q, t, K, X, np.broadcast_to(P, (n,) + P.shape).copy(), uv, mask


def test_triangulation_equals_jax():
    """projection_matrices, masked DLT (eigh of the 4x4 normal matrix: the
    eigenvector's sign is backend-specific, X is not), per-view
    reprojection errors and triangulation angles; X within 1e-4 relative,
    errors within 1e-3 px, angles within 1e-3 deg."""
    q, t, K, X_true, P, uv, mask = _tri_problem(0)
    _close(TT.projection_matrices(_t(q), _t(t), _t(K)),
           JT.projection_matrices(*(jnp.asarray(x) for x in (q, t, K))),
           atol=1e-3, rtol=1e-5)
    Xj, okj = JT.triangulate_dlt(*(jnp.asarray(x) for x in (P, uv, mask)))
    Xt, okt = TT.triangulate_dlt(P, uv, mask, device="cpu")
    _close(Xt, Xj, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert np.abs(Xt.numpy() - X_true).max() < 0.05
    ej, zj = JT.reprojection_errors(Xj, jnp.asarray(P), jnp.asarray(uv))
    et, zt = TT.reprojection_errors(Xt, _t(P), _t(uv))
    _close(et, ej, atol=1e-3, rtol=1e-3)
    _close(zt, zj, atol=1e-4, rtol=1e-4)
    R = np.asarray(JG.quat_to_rotmat(jnp.asarray(q)))
    C = np.broadcast_to(-np.einsum("vji,vj->vi", R, t),
                        (len(uv),) + t.shape).astype(np.float32)
    _close(TT.triangulation_angles_deg(Xt, _t(C), _t(mask)),
           JT.triangulation_angles_deg(Xj, jnp.asarray(C),
                                       jnp.asarray(mask)), atol=1e-3)


def test_triangulation_in_eigh_chunks_equals_one_call(monkeypatch):
    """Above precision.EIGH_MAX_BATCH matrices the DLT's eigh runs in
    chunks (cuSOLVER on the card refuses large batches): the same points
    and flags, bit for bit, as one call."""
    from detectorfreesfm_tpu_torch.core import precision

    _q, _t_, _K, _X, P, uv, mask = _tri_problem(0)
    whole = TT.triangulate_dlt(P, uv, mask, device="cpu")
    monkeypatch.setattr(precision, "EIGH_MAX_BATCH", 7)
    assert len(uv) > 7
    chunked = TT.triangulate_dlt(P, uv, mask, device="cpu")
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)
    A = torch.randn(3, 10, 12, 12, generator=torch.Generator().manual_seed(0))
    A = A @ A.transpose(-1, -2)
    for a, b in zip(precision.eigh(A), torch.linalg.eigh(A)):
        assert torch.equal(a, b)


def test_entry_points_set_fp32_geometry_precision(monkeypatch):
    """Every geometry entry point turns TF32 off itself (core/precision),
    whatever ran before it, and gives the caller's settings back on
    return: geometry does not decide the matcher's precision."""
    q, t, K, _X, P, uv, mask = _tri_problem(1, n=8)
    seen = []
    eigh = torch.linalg.eigh

    def spy(a):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return eigh(a)

    monkeypatch.setattr(torch.linalg, "eigh", spy)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    try:
        for matmul in ("high", "medium"):
            torch.backends.cudnn.allow_tf32 = True
            torch.set_float32_matmul_precision(matmul)
            TT.triangulate_dlt(P, uv, mask, device="cpu")
            assert seen[-1] == (False, False, "highest")
            assert torch.backends.cuda.matmul.allow_tf32 is True
            assert torch.backends.cudnn.allow_tf32 is True
            assert torch.get_float32_matmul_precision() == matmul
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def test_default_device_needs_cuda(monkeypatch):
    """device=None means CUDA: geometry entry points raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, t, K, _X, P, uv, mask = _tri_problem(1, n=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.triangulate_dlt(P, uv, mask)


# --- utils/prng: JAX's draws without JAX -----------------------------------


@pytest.mark.parametrize("shape", [(512, 300), (7, 1000), (64, 2048)])
def test_gumbel_equals_jax_random(shape):
    """Raw bits and uniforms bit for bit; Gumbel values within 2e-6; the
    same top-8 indices per row, in order (RANSAC's samples, as the
    estimators draw them: ties to the lower index)."""
    from detectorfreesfm_tpu_torch.sfm.twoview import _sample

    keys = prng.stable_rngs([("verify", "a", "b", 0), ("homog", "a", "b"),
                             ("register", "im", 300, 2)])
    for k in keys:
        jk = jnp.asarray(k)
        bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got_bits = prng.random_bits(k, shape, "cpu")
        np.testing.assert_array_equal(got_bits.numpy(),
                                      bits.astype(np.int64))
        tiny = np.finfo(np.float32).tiny
        u = np.asarray(jax.random.uniform(jk, shape, minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(
            prng.uniform_from_bits(got_bits).numpy(), u)
        ref = np.asarray(jax.random.gumbel(jk, shape))
        got = prng.gumbel(k, shape, device="cpu")
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)
        top_ref = np.asarray(jax.lax.top_k(jnp.asarray(ref), 8)[1])
        ones = torch.ones(1, shape[1], dtype=torch.bool)
        np.testing.assert_array_equal(_sample(got[None], ones, 8)[0].numpy(),
                                      top_ref)


def test_gumbel_batched_keys_equal_vmap():
    """A batch of keys gives what jax.vmap over the keys gives."""
    keys = prng.stable_rngs([("verify", i, i + 1, 0) for i in range(5)])
    ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (16, 33)))(
        jnp.asarray(keys)))
    np.testing.assert_allclose(
        prng.gumbel(keys, (16, 33), device="cpu").numpy(), ref,
        atol=2e-6, rtol=0)


def test_gumbel_default_device_needs_cuda(monkeypatch):
    """The draws are an entry point too: device=None means CUDA, and
    without it they raise instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = prng.stable_rngs([("verify", "a", "b", 0)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prng.gumbel(keys, (4, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prng.random_bits(keys[0], (4, 16))


def test_stable_rngs_equal_mapper():
    """The copy of IncrementalMapper._stable_rngs, for seeds 0 and 7."""
    from detectorfreesfm_tpu.sfm.mapper import IncrementalMapper, MapperConfig

    entries = [("verify", "a.jpg", "b.jpg", 0), ("homog", "a.jpg", "b.jpg"),
               ("register", "c.jpg", 123, 4), ("init_e", 1, 2, 300)]
    for seed in (0, 7):
        ref = IncrementalMapper(MapperConfig(seed=seed))._stable_rngs(entries)
        got = prng.stable_rngs(entries, seed=seed)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref)
