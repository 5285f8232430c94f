"""The port on a CUDA card: each kernel against its plain version, and the
fused engine against the dense one. Every test is marked `cuda` and skips
without a card. The file imports neither jax nor the JAX package, so that
it runs on a GPU machine that has neither; there, skip the repo's
conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from detectorfreesfm_tpu_torch.ops import fused_dsm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")


def _features(b, l, s, c, seed=0):
    rng = np.random.default_rng(seed)
    f0 = rng.normal(0, 1, (b, l, c)).astype(np.float32)
    f1 = rng.normal(0, 1, (b, s, c)).astype(np.float32)
    for bb in range(b):
        dst = rng.choice(s, 40, replace=False)
        f1[bb, dst] = f0[bb, :40] + rng.normal(0, 0.05, (40, c))
    m0 = rng.uniform(size=(b, l)) > 0.05
    m1 = rng.uniform(size=(b, s)) > 0.05
    return [torch.from_numpy(x).cuda() for x in (f0 * 3, f1 * 3, m0, m1)]


@pytest.mark.cuda
@pytest.mark.parametrize("fast_exp", [False, True])
def test_kernels_match_plain_versions(fast_exp):
    """Ragged shapes (not multiples of the 64-row tiles): lse within 2e-3
    (0.05 with fast exp, whose ±3% depends on each sum's shift), row and
    column argmax agreement >= 0.995, one launch counted per pass."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    f0, f1, m0, m1 = _features(2, 1000, 777, 256)
    ops = fused_dsm.split_features(f0, f1, m0, m1)
    before = dict(fused_dsm.launches)
    lse_r, lse_c = fused_dsm.dsm_pass1(*ops, fast_exp)
    ref_r, ref_c = fused_dsm.dsm_pass1_plain(*ops, fast_exp)
    tol = 0.05 if fast_exp else 2e-3
    assert (lse_r - ref_r)[m0].abs().max().item() <= tol
    assert (lse_c - ref_c)[m1].abs().max().item() <= tol
    ref_r, ref_c = fused_dsm.dsm_pass1_plain(*ops)  # the exact biases
    _, rarg, _, carg = fused_dsm.dsm_pass2(*ops, ref_r, ref_c)
    _, prarg, _, pcarg = fused_dsm.dsm_pass2_plain(*ops, ref_r, ref_c)
    assert (rarg == prarg)[m0].float().mean().item() >= 0.995
    assert (carg == pcarg)[m1].float().mean().item() >= 0.995
    assert fused_dsm.launches["dsm_pass1"] == before["dsm_pass1"] + 1
    assert fused_dsm.launches["dsm_pass2"] == before["dsm_pass2"] + 1


@pytest.mark.cuda
def test_ties_across_tiles_take_the_first_index():
    """Identical f0 rows in row tiles 0, 2 and 14 tie for one column's
    maximum, identical f1 rows in column tiles 0, 1 and 10 for one row's:
    the column combine and the row sweep both keep the first index."""
    _needs_cuda()
    rng = np.random.default_rng(3)
    n, c = 1000, 256
    f0 = rng.normal(0, 1, (1, n, c)).astype(np.float32)
    f1 = rng.normal(0, 1, (1, n, c)).astype(np.float32)
    v, w = (x * 40.0 / np.linalg.norm(x) for x in rng.normal(0, 1, (2, c)))
    f0[0, [3, 130, 900]] = v
    f1[0, 11] = v
    f0[0, 500] = w
    f1[0, [5, 70, 700]] = w
    f0, f1 = torch.from_numpy(f0).cuda(), torch.from_numpy(f1).cuda()
    ones = torch.ones(1, n, dtype=torch.bool, device="cuda")
    ops = fused_dsm.split_features(f0, f1, ones, ones)
    zeros = torch.zeros(1, n, device="cuda")
    got = fused_dsm.dsm_pass2(*ops, zeros, zeros)
    want = fused_dsm.dsm_pass2_plain(*ops, zeros, zeros)
    assert got[3][0, 11].item() == want[3][0, 11].item() == 3
    assert got[1][0, 500].item() == want[1][0, 500].item() == 5
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernel_cannot_take():
    _needs_cuda()
    f0, f1, m0, m1 = _features(1, 64, 64, 256)
    ops = list(fused_dsm.split_features(f0, f1, m0, m1))
    strided = ops[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dsm.dsm_pass1(strided, *ops[1:])
    narrow = [t[..., :128].contiguous() for t in ops[:4]]
    with pytest.raises(ValueError, match="C == 256"):
        fused_dsm.dsm_pass1(*narrow, *ops[4:])
    with pytest.raises(ValueError, match="bfloat16"):
        fused_dsm.dsm_pass2(ops[0].float(), *ops[1:], m0.float(), m1.float())


@pytest.mark.cuda
def test_fused_engine_matches_dense_engine_on_gpu():
    """3 views at 256 px, coarse_fine, 4 px rounding: the engine through the
    kernels gives the dense engine's match rows (IoU >= 0.95 per pair)."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        generate_scene,
    )
    from detectorfreesfm_tpu_torch.match.engine import (
        EngineConfig,
        PairMatchingEngine,
    )
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    imgs = generate_scene(1, SyntheticConfig(size=256, n_views=3))[0]
    names = [f"v{i}" for i in range(3)]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = exhaustive_pairs(names)
    out = {}
    for fused in (False, True):
        cfg = EngineConfig(img_resize=256, fine_enabled=True,
                           round_matches_ratio=4, fused_matching=fused,
                           batch_size=2)
        engine = PairMatchingEngine(
            cfg, load_matcher_params(WEIGHTS, cfg.matcher_config()))
        out[fused] = engine.match_pairs(pairs, images)
    for p in pairs:
        rows = [{tuple(r) for r in np.concatenate(
            [out[f][p]["kpts0"], out[f][p]["kpts1"]], 1).tolist()}
            for f in (False, True)]
        assert len(rows[0]) > 20
        assert len(rows[0] & rows[1]) / len(rows[0] | rows[1]) >= 0.95, p


# --- the geometry slice: the port on the card against the port on the CPU --


def _two_view_inputs(seed=0, B=4, N=512, planar=()):
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, N, 2), np.float32)
    x1 = np.zeros_like(x0)
    mask = np.zeros((B, N), bool)
    for b in range(B):
        n = N - 50 * b
        X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]
        if b in planar:
            X[:, 2] = 5.0
        w = rng.normal(0, 0.1, 3)
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        Xc = X @ R.T + [1.0, 0.1, 0.05]
        a = X[:, :2] / X[:, 2:] + rng.normal(0, 1e-3, (n, 2))
        c = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (n, 2))
        out = rng.uniform(size=n) < 0.3
        c[out] = rng.uniform(-0.3, 0.3, (out.sum(), 2))
        x0[b, :n], x1[b, :n], mask[b, :n] = a, c, True
    return x0, x1, mask, np.full(B, 3e-3, np.float32)


def _gumbel(B, H, N, tag):
    from detectorfreesfm_tpu_torch.utils import prng

    keys = prng.stable_rngs([(tag, b) for b in range(B)])
    return keys, prng.gumbel(keys, (H, N), device="cpu")


@pytest.mark.cuda
def test_gumbel_draws_on_the_card_equal_the_cpu():
    """The threefry bits and uniforms are integer work: bit for bit on the
    card; Gumbel values within 2e-6 (log rounds per backend)."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.utils import prng

    keys = prng.stable_rngs([("verify", "a", "b", 0), ("homog", "a", "b")])
    for k in keys:
        assert torch.equal(prng.random_bits(k, (64, 999), "cuda").cpu(),
                           prng.random_bits(k, (64, 999), "cpu"))
    g_gpu = prng.gumbel(keys, (64, 999), device="cuda").cpu()
    g_cpu = prng.gumbel(keys, (64, 999), device="cpu")
    assert (g_gpu - g_cpu).abs().max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["essential", "homography"])
def test_two_view_batch_on_the_card_equals_the_cpu(kind):
    """Same draws, same pairs: inlier counts within 1% (rounded up to a
    whole inlier) and inlier-set IoU >= 0.98; essential poses within 0.05
    deg of the CPU's."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.sfm import twoview

    x0, x1, mask, thr = _two_view_inputs(
        planar=(2, 3) if kind == "homography" else ())
    _keys, g = _gumbel(len(x0), 256, x0.shape[1], kind)
    fn = (twoview.estimate_relative_pose_batch if kind == "essential"
          else twoview.estimate_homography_batch)
    gpu = fn(x0, x1, mask, g, thr, device="cuda")
    cpu = fn(x0, x1, mask, g, thr, device="cpu")
    n_g, n_c = gpu.n_inliers.cpu().numpy(), cpu.n_inliers.numpy()
    assert (np.abs(n_g - n_c) <= np.ceil(0.01 * n_c)).all(), (n_g, n_c)
    for b in range(len(x0)):
        a, c = gpu.inliers[b].cpu().numpy(), cpu.inliers[b].numpy()
        assert (a & c).sum() / max((a | c).sum(), 1) >= 0.98
    if kind == "essential":
        dots = (gpu.qvec.cpu() * cpu.qvec).sum(-1).abs().clamp(max=1.0)
        assert torch.rad2deg(2 * torch.arccos(dots)).max().item() <= 0.05


@pytest.mark.cuda
def test_pnp_and_triangulation_on_the_card_equal_the_cpu():
    """PnP-RANSAC (P3P in complex64 on the card) and masked DLT: the same
    inlier counts (within 1%), rotations within 0.05 deg, points within
    1e-3 of the CPU's and 1e-2 of the truth (depth ~6, exact pixels)."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.core.triangulation import triangulate_dlt
    from detectorfreesfm_tpu_torch.sfm import pnp

    rng = np.random.default_rng(1)
    B, N = 3, 300
    X = (rng.uniform(-1, 1, (B, N, 3)) + [0, 0, 4]).astype(np.float32)
    t = rng.normal(0, 0.3, (B, 1, 3))
    Xc = X + t
    x = (Xc[..., :2] / Xc[..., 2:] + rng.normal(0, 1e-3, (B, N, 2))).astype(
        np.float32)
    out = rng.uniform(size=(B, N)) < 0.4
    x[out] = rng.uniform(-0.5, 0.5, (out.sum(), 2))
    mask = np.ones((B, N), bool)
    thr = np.full(B, 4e-3, np.float32)
    _k, g = _gumbel(B, 256, N, "register")
    gpu = pnp.estimate_absolute_pose_batch(X, x, mask, g, thr, device="cuda")
    cpu = pnp.estimate_absolute_pose_batch(X, x, mask, g, thr, device="cpu")
    n_g, n_c = gpu.n_inliers.cpu().numpy(), cpu.n_inliers.numpy()
    assert (np.abs(n_g - n_c) <= np.ceil(0.01 * n_c)).all(), (n_g, n_c)
    dots = (gpu.qvec.cpu() * cpu.qvec).sum(-1).abs().clamp(max=1.0)
    assert torch.rad2deg(2 * torch.arccos(dots)).max().item() <= 0.05
    q_g, t_g = pnp.refine_pose(gpu.qvec[0], gpu.tvec[0], X[0], x[0],
                               gpu.inliers[0], device="cuda")
    q_c, t_c = pnp.refine_pose(gpu.qvec[0].cpu(), gpu.tvec[0].cpu(), X[0],
                               x[0], gpu.inliers[0].cpu(), device="cpu")
    assert (q_g.cpu() - q_c).abs().max().item() <= 1e-5

    P = np.tile(np.eye(3, 4, dtype=np.float32) * 700, (64, 4, 1, 1))
    P[..., 2, 2] = 1.0
    P[:, :, 0, 3] = np.arange(4) * 350.0  # baselines of 0.5 units
    Xw = (rng.normal(size=(64, 3)) + [0, 0, 6]).astype(np.float32)
    Xh = np.concatenate([Xw, np.ones((64, 1), np.float32)], 1)
    proj = np.einsum("nvij,nj->nvi", P, Xh)
    uv = (proj[..., :2] / proj[..., 2:]).astype(np.float32)
    m = rng.uniform(size=(64, 4)) < 0.8
    m[:, :2] = True
    Xg, okg = triangulate_dlt(P, uv, m, device="cuda")
    Xc_, okc = triangulate_dlt(P, uv, m, device="cpu")
    assert torch.equal(okg.cpu(), okc)
    # fp32 eigh of the 4x4 normal matrix, cuSOLVER against LAPACK
    assert torch.allclose(Xg.cpu(), Xc_, rtol=1e-3, atol=1e-3)
    assert np.abs(Xg.cpu().numpy() - Xw).max() < 1e-2


def _ba_args(C=8, P=300, seed=2):
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    pts = rng.uniform(-2, 2, (P, 3)) + [0, 0, 8.0]
    q = np.zeros((C, 4))
    q[:, 0] = 1.0
    t = np.zeros((C, 3))
    t[:, 0] = -np.linspace(-1.5, 1.5, C)
    uv = []
    for c in range(C):
        Xc = pts + t[c]
        uv.append((Xc / Xc[:, 2:]) @ K.T)
    obs_uv = np.concatenate(uv)[:, :2] + rng.normal(0, 0.5, (C * P, 2))
    obs_cam = np.repeat(np.arange(C), P)
    obs_pt = np.tile(np.arange(P), C)
    t_noisy = t.copy()
    t_noisy[2:] += rng.normal(0, 0.02, (C - 2, 3))
    intr = np.tile([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], (C, 1))
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    return ((q, t_noisy, intr, pts + rng.normal(0, 0.02, pts.shape), obs_uv,
             obs_cam, obs_pt), fixed)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_bundle_adjust_on_the_card_equals_the_cpu(solver):
    """Each Schur solver on the card against the CPU: final cost per
    observation within 1% and poses within 1e-3 (the card's atomics
    reorder the reductions); the PCG freezes at JAX's stopping rule."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.sfm.ba import bundle_adjust

    args, fixed = _ba_args()
    kw = dict(fixed_cams=fixed, max_iters=10, schur_mode=solver,
              refine_focal=True)
    info_g, info_c = {}, {}
    g = bundle_adjust(*args, device="cuda", info=info_g, **kw)
    c = bundle_adjust(*args, device="cpu", info=info_c, **kw)
    assert abs(g[4] - c[4]) <= 0.01 * c[4], (g[4], c[4])
    assert np.abs(g[1] - c[1]).max() <= 1e-3
    assert info_g["solver"] == info_c["solver"] == solver


@pytest.mark.cuda
def test_cholesky_failure_on_the_card_is_a_nan_step():
    """cholesky_ex on the card: a system that is not positive definite
    gives a NaN step (JAX's cho_solve result), not an exception."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.sfm import ba

    args, fixed = _ba_args(C=3, P=40)
    qvec, tvec, intr, pts, obs_uv, obs_cam, obs_pt = args
    from detectorfreesfm_tpu_torch.core.geometry import np_quat_to_rotmat

    C, P, O = len(qvec), len(pts), len(obs_uv)
    dev = "cuda"

    def dv(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    pad = lambda a, v: np.concatenate(  # noqa: E731
        [a, np.full((1,) + a.shape[1:], v, a.dtype)])
    track_obs = (np.arange(C)[None, :] * P + np.arange(P)[:, None])
    prob = ba.BAProblem(
        cam_R=dv(np_quat_to_rotmat(qvec)), cam_t=dv(tvec),
        intr=dv(np.concatenate([intr, np.zeros((C, 1))], 1)), points=dv(pts),
        obs_uv=dv(pad(obs_uv, 0.0)),
        obs_cam=dv(pad(obs_cam, 0), torch.int64),
        obs_pt=dv(pad(obs_pt, 0), torch.int64),
        obs_mask=dv(pad(np.ones(O, bool), False), torch.bool),
        track_obs=dv(track_obs, torch.int64),
        track_mask=dv(np.ones((P, C), bool), torch.bool),
        fixed_cams=dv(fixed, torch.bool),
        pose_free=dv(np.where(fixed[:, None], 0.0, 1.0) * np.ones((C, 6))),
        refine_focal=True, refine_dist=True)
    step = ba.lm_step(prob, torch.tensor(-1.5, device=dev))
    assert not torch.isfinite(step[1]).all()


def _demo_cached():
    from detectorfreesfm_tpu_torch.data.h5io import load_h5

    d = os.path.join(REPO, "tests", "data", "torch", "demo_cached")
    kps = load_h5(os.path.join(d, "keypoints.h5"), False)
    raw = load_h5(os.path.join(d, "matches.h5"), False)
    return kps, {tuple(k.split("|")): v.astype(np.int32)
                 for k, v in raw.items()}


@pytest.mark.cuda
def test_mapper_verify_pairs_on_the_card_equals_the_cpu():
    """demo_cached with focal search: the same kept pairs, inlier counts
    within 1% (rounded up to a whole inlier)."""
    _needs_cuda()
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke
    from detectorfreesfm_tpu_torch.sfm.mapper import (
        IncrementalMapper,
        MapperConfig,
    )

    kps, matches = _demo_cached()
    sizes = {n: chip_smoke.DEMO_SIZES[n] for n in kps}
    cfg = MapperConfig(**chip_smoke.demo_mapper_kwargs(kps, 416))
    out = []
    for dev in ("cuda", "cpu"):
        mapper = IncrementalMapper(cfg, device=dev)
        rec = mapper._setup(kps, sizes, None)
        out.append(mapper.verify_pairs(rec, matches, focal_search=True))
    card, cpu = out
    assert sorted(card) == sorted(cpu) and len(cpu) > 20
    for k, r in cpu.items():
        tol = int(np.ceil(0.01 * r["n_inliers"]))
        assert abs(card[k]["n_inliers"] - r["n_inliers"]) <= tol, k


@pytest.mark.cuda
def test_refiner_forward_on_the_card_equals_the_cpu():
    """The r4 refiner at crop 19 / window 15: coords within 1e-3 px."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.core.precision import geometry_precision
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner,
    )
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_refiner_params,
    )

    rng = np.random.default_rng(0)
    I, T, V = 3, 64, 6
    inputs = (rng.uniform(0, 1, (I, 96, 96, 1)).astype(np.float32),
              rng.integers(0, I, (T, V)), rng.uniform(
                  0, 96, (T, V, 2)).astype(np.float32),
              rng.uniform(0.7, 1.4, (T, V)).astype(np.float32),
              rng.uniform(size=(T, V)) > 0.2)
    path = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")
    out = []
    for dev in ("cuda", "cpu"):
        model = MultiviewRefiner().eval()
        model.load_state_dict(load_refiner_params(path, device=dev))
        model.to(dev)
        with geometry_precision(), torch.no_grad():
            out.append(model(*(torch.as_tensor(a, device=dev)
                               for a in inputs)).coords.cpu())
    assert (out[0] - out[1]).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_mapper_and_refinement_run_on_cuda_by_default():
    """IncrementalMapper(), load_refiner_params and refine_reconstruction
    without a device run on the card."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.refine.loop import (
        RefineConfig,
        refine_reconstruction,
    )
    from detectorfreesfm_tpu_torch.sfm.mapper import (
        IncrementalMapper,
        MapperConfig,
    )
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_refiner_params,
    )

    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (150, 3)) + [0, 0, 6]
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    kps = {}
    for i in range(4):
        a = (i - 1.5) * 0.3
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        Xc = (pts - [6 * np.sin(a), 0, 6 - 6 * np.cos(a)]) @ R.T
        kps[f"im{i}"] = ((Xc / Xc[:, 2:]) @ K.T)[:, :2]
    ids = np.stack([np.arange(150)] * 2, 1).astype(np.int32)
    mapper = IncrementalMapper(MapperConfig(abs_pose_min_num_inliers=15))
    assert mapper.device.type == "cuda"
    rec = mapper.run(kps, {(a, b): ids for a in kps for b in kps if a < b},
                     {n: (320, 240) for n in kps}, {n: K for n in kps})
    assert len(rec.registered_images) == 4
    params = load_refiner_params(os.path.join(
        REPO, "weights", "demo_refiner_r4_bf16.msgpack"))
    assert all(v.is_cuda for v in params.values())
    torch.cuda.reset_peak_memory_stats()
    info = {}
    refine_reconstruction(
        rec, {i: rng.uniform(size=(240, 320)).astype(np.float32)
              for i in rec.images}, params,
        RefineConfig(n_iters=1, windows=(7,), chunk_tracks=64,
                     max_track_length=4), mapper=mapper, info=info)
    assert info["iterations_completed"] == 1 and info["error"] is None
    assert torch.cuda.max_memory_allocated() > 0
