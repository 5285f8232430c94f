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


@pytest.mark.cuda
def test_bf16_forward_reduces_bf16_gemms_in_fp32():
    """A bf16 matcher forward on the card runs with cuBLAS's bf16
    reduced-precision reduction off inside it (torch's default is on;
    XLA reduces bf16 GEMMs in fp32), TF32 off, bf16 activations, fp32
    parameters and finite matches."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.models.loftr import (DetectorFreeMatcher,
                                                        MatcherConfig)

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    torch.manual_seed(0)
    model = DetectorFreeMatcher(MatcherConfig(
        compute_dtype="bfloat16", fine_enabled=True)).cuda().eval()
    seen = []

    def probe(mod, args, out):
        seen.append((
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cuda.matmul.allow_tf32, out.dtype))

    layer = model.coarse_transformer.layer_0_self
    hooks = [m.register_forward_hook(probe) for m in (layer.q_proj,
                                                      layer.mlp2)]
    x = torch.rand(2, 256, 256, 1, device="cuda")
    with torch.no_grad():
        out = model(x, x.flip(1))
    for h in hooks:
        h.remove()
    assert seen and all(s == (False, False, torch.bfloat16) for s in seen)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert out.coords1.dtype == torch.float32
    assert torch.isfinite(out.coords1).all()


@pytest.mark.cuda
def test_bf16_fused_matches_dense_at_832px():
    """One 832 px pair through the bf16 r5 matcher (coarse_fine, 4 px
    rounding): the kernels, fed upcast bf16 features, give the dense
    path's match rows at IoU >= 0.95."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    imgs = generate_scene(0, SyntheticConfig(size=832, n_views=2))[0]
    images = {f"v{i}": from_array(imgs[i]) for i in range(2)}
    pair = ("v0", "v1")
    before = dict(fused_dsm.launches)
    rows = []
    for fused in (False, True):
        cfg = EngineConfig(img_resize=832, fine_enabled=True,
                           round_matches_ratio=4, fused_matching=fused,
                           compute_dtype="bfloat16")
        engine = PairMatchingEngine(
            cfg, load_matcher_params(WEIGHTS, cfg.matcher_config()))
        m = engine.match_pairs([pair], images)[pair]
        rows.append({tuple(r) for r in np.concatenate(
            [m["kpts0"], m["kpts1"]], 1).tolist()})
    assert fused_dsm.launches["dsm_pass1"] == before["dsm_pass1"] + 1
    assert len(rows[0]) > 500
    assert len(rows[0] & rows[1]) / len(rows[0] | rows[1]) >= 0.95


@pytest.mark.cuda
def test_view_store_on_the_card_equals_the_per_pair_forward():
    """6 views at 832 px, fp32, coarse_fine, 4 px rounding, batch 2: the
    pairs of views 0-3, then in a second call those of views 2-5, give the
    match rows of the matcher's `forward` run pair by pair (IoU >= 0.95).
    Under a profiler the second call runs its 4 views once (12 sides read
    from the store) and records no new shape, so no cuDNN timing falls
    inside it."""
    _needs_cuda()
    from torch.profiler import ProfilerActivity, profile

    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params
    from detectorfreesfm_tpu_torch.utils.profiler import snapshot

    imgs = generate_scene(2, SyntheticConfig(size=832, n_views=6))[0]
    names = [f"v{i}" for i in range(6)]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    first, second = exhaustive_pairs(names[:4]), exhaustive_pairs(names[2:])
    cfg = EngineConfig(img_resize=832, fine_enabled=True,
                       round_matches_ratio=4, batch_size=2)
    engine = PairMatchingEngine(
        cfg, load_matcher_params(WEIGHTS, cfg.matcher_config()))
    out = engine.match_pairs(first, images)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out.update(engine.match_pairs(second, images))
    counters = snapshot()["counters"]
    assert counters["engine/new_shapes"] == 0
    assert (counters["engine/views"], counters["engine/view_uses"]) == (4, 12)
    dev = engine.device
    for a, b in first + second:
        x0, x1 = (torch.from_numpy(images[n].data)[None, ..., None].to(dev)
                  for n in (a, b))
        hw = torch.tensor([[832, 832]], device=dev)
        with torch.no_grad():
            r = engine.model(x0, x1, hw, hw)
        v = r.valid[0].cpu().numpy()
        ref = np.round(np.concatenate([r.coords0[0].cpu().numpy()[v],
                                       r.coords1[0].cpu().numpy()[v]], 1)
                       / 4) * 4
        rows = [{tuple(x) for x in ref.tolist()},
                {tuple(x) for x in np.concatenate(
                    [out[(a, b)]["kpts0"], out[(a, b)]["kpts1"]], 1).tolist()}]
        assert len(rows[0]) > 100, (a, b)
        assert len(rows[0] & rows[1]) / len(rows[0] | rows[1]) >= 0.95, (a, b)


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


def _cached_match_scene(root, n_views=5, n_pts=250, seed=31):
    """A scene directory of PNG files with cached match stores, written by
    the port alone (no PIL, no JAX): tests/test_pipeline.py's kind of
    scene, projections of random points into cameras on an arc."""
    from detectorfreesfm_tpu_torch.data import png
    from detectorfreesfm_tpu_torch.data.h5io import save_h5

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n_pts, 3)) + [0, 0, 6]
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    kps = {}
    for i in range(n_views):
        a = (i - (n_views - 1) / 2) * 0.2
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        Xc = (pts - [6 * np.sin(a), 0, 6 - 6 * np.cos(a)]) @ R.T
        uv = ((Xc / Xc[:, 2:]) @ K.T)[:, :2]
        kps[f"im{i:02d}.png"] = uv + rng.normal(0, 0.4, uv.shape)
    image_dir = os.path.join(root, "images")
    os.makedirs(image_dir)
    for n in kps:
        png.write_png(os.path.join(image_dir, n),
                      rng.integers(0, 256, (480, 640), dtype=np.uint8))
    ids = np.stack([np.arange(n_pts)] * 2, 1).astype(np.int32)
    stores = {}
    for out in ("cpu", "cuda"):
        d = os.path.join(root, out)
        os.makedirs(d)
        save_h5(kps, os.path.join(d, "keypoints.h5"))
        save_h5({f"{a}|{b}": ids for a in kps for b in kps if a < b},
                os.path.join(d, "matches.h5"))
        stores[out] = d
    return image_dir, stores, {n: K for n in kps}


@pytest.mark.cuda
def test_reconstruct_scene_on_the_card_equals_the_cpu(tmp_path):
    """The scene pipeline from cached matches (mapper, one refinement
    iteration with the r4 refiner, colours, exports) on the card and on
    the CPU: the same registered set, points within 2%."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch import pipeline
    from detectorfreesfm_tpu_torch.refine.loop import RefineConfig
    from detectorfreesfm_tpu_torch.sfm.mapper import MapperConfig
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_refiner_params,
    )

    image_dir, stores, intrins = _cached_match_scene(str(tmp_path))
    cfg = pipeline.PipelineConfig(
        img_resize=640, n_refine_iters=1,
        mapper=MapperConfig(abs_pose_min_num_inliers=15),
        refine=RefineConfig(windows=(9,), chunk_tracks=128,
                            filter_thresholds=(8.0,)))
    weights = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")
    recs = {dev: pipeline.reconstruct_scene(
        image_dir, stores[dev], cfg, intrinsics=intrins, device=dev,
        refiner_params=load_refiner_params(weights, device=dev))
        for dev in ("cpu", "cuda")}
    reg = {dev: sorted(r.images[i].name for i in r.registered_images)
           for dev, r in recs.items()}
    assert reg["cuda"] == reg["cpu"] and len(reg["cpu"]) == 5
    n = {dev: len(r.points) for dev, r in recs.items()}
    assert abs(n["cuda"] - n["cpu"]) <= 0.02 * n["cpu"], n
    for dev in recs:
        assert os.path.exists(os.path.join(stores[dev], "model_refined_0",
                                           "images.bin"))


@pytest.mark.cuda
def test_triangulation_of_a_large_batch_on_the_card():
    """65 536 DLT problems in one call (cuSOLVER's batched eigensolver
    refuses batches of 40 000 and more; precision.eigh chunks them): the
    points equal the CPU's within 1e-3 relative."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.core.triangulation import triangulate_dlt

    rng = np.random.default_rng(5)
    n, V = 65536, 4
    X = rng.normal(size=(n, 3)) + [0, 0, 6]
    P = np.zeros((n, V, 3, 4), np.float32)
    uv = np.zeros((n, V, 2), np.float32)
    for v in range(V):
        Pv = np.concatenate([np.eye(3), [[v * 0.5], [0], [0]]], 1)
        P[:, v] = np.diag([500.0, 500, 1]) @ Pv
        h = np.einsum("ij,nj->ni", P[0, v], np.c_[X, np.ones(n)])
        uv[:, v] = h[:, :2] / h[:, 2:]
    mask = np.ones((n, V), bool)
    Xg, okg = triangulate_dlt(P, uv, mask, device="cuda")
    Xc, okc = triangulate_dlt(P, uv, mask, device="cpu")
    assert bool(okg.all()) and torch.equal(okg.cpu(), okc)
    np.testing.assert_allclose(Xg.cpu().numpy(), Xc.numpy(), rtol=1e-3,
                               atol=1e-3)


def _train_tuple(size=128, views=3, seed=0):
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)

    imgs, d, K, q, t = generate_scene(seed, SyntheticConfig(
        size=size, n_views=views))
    return {"images": imgs[..., None][None], "depths": d[None],
            "K": K[None].astype(np.float32),
            "qvec": q[None].astype(np.float32),
            "tvec": t[None].astype(np.float32)}


@pytest.mark.cuda
def test_trainer_step_on_the_card_equals_the_cpu():
    """One refiner Trainer step from the same parameters and key: the loss
    and the gradient norm on the card equal the CPU's to 1e-4."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        RefinerConfig)
    from detectorfreesfm_tpu_torch.train.trainer import TrainConfig, Trainer
    from detectorfreesfm_tpu_torch.utils import prng

    cfg = TrainConfig(refiner=RefinerConfig(crop_size=11, window=7),
                      n_tracks=32)
    batch = _train_tuple()
    out = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, device=dev)
        state = tr.init_state(batch)
        tr.train_step(state, batch, prng.PRNGKey(3))
        out[dev] = tr.history[0]
    for k in ("loss", "grad_norm"):
        assert abs(out["cuda"][k] - out["cpu"][k]) <= 1e-4 * abs(
            out["cpu"][k]), (k, out)


@pytest.mark.cuda
@pytest.mark.parametrize("fine", [False, True])
def test_matcher_trainer_step_on_the_card_equals_the_cpu(fine):
    """One MatcherTrainer step (coarse, and joint fine) from the r5 warm
    start, as `train-matcher --init-ckpt` takes it: loss and gradient norm
    on the card equal the CPU's to 1e-4, and the fused kernels stay off
    the path. (From a fresh flax-style init the norm differs by ~2e-4:
    with BatchNorm at mean 0, variance 1, bias 0, ReLU inputs that one
    device sums to an exact 0 and the other to a float32 residue move
    single channels' gradients, as tests/test_torch_train_matcher.py
    shows against JAX.)"""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.models.loftr import MatcherConfig
    from detectorfreesfm_tpu_torch.train.matcher_trainer import (
        MatcherTrainConfig, MatcherTrainer, tuple_to_pair_batch)

    tup = _train_tuple(size=128, views=2)
    batch = tuple_to_pair_batch([{k: v[0] for k, v in tup.items()}])
    cfg = MatcherTrainConfig(matcher=MatcherConfig(
        fine_enabled=fine, fused_matching=True))
    out = {}
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    for dev in ("cpu", "cuda"):
        tr = MatcherTrainer(cfg, device=dev)
        state = tr.init_state(batch)
        state = state._replace(params=tr.load_params(WEIGHTS, state.params))
        tr.train_step(state, batch)
        out[dev] = tr.history[0]
    assert fused_dsm.launches == {"dsm_pass1": 0, "dsm_pass2": 0}
    for k in ("loss", "grad_norm"):
        assert abs(out["cuda"][k] - out["cpu"][k]) <= 1e-4 * abs(
            out["cpu"][k]), (k, out)


def _clouds(seed=0):
    """tests/test_torch_eval.py's scene-scale clouds: a true cloud and a
    noisy reconstruction of half of it with far-away junk."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-3, 3, (3000, 3)) + np.array([0.0, 0.0, 8.0])
    rec = np.concatenate([
        gt[:1500] + rng.normal(scale=0.03, size=(1500, 3)),
        rng.uniform(20, 21, (200, 3))])
    return rec, gt


@pytest.mark.cuda
def test_accuracy_completeness_on_the_card_equals_the_cpu():
    """eval/pointcloud.py on the card (its default device) and on the CPU:
    fractions within 1e-6 at three tolerances, NN distances within 1e-5,
    with blocks that do not divide the cloud."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.eval import pointcloud

    rec, gt = _clouds()
    tols = (0.02, 0.05, 0.1)
    card = pointcloud.accuracy_completeness(rec, gt, tols)
    cpu = pointcloud.accuracy_completeness(rec, gt, tols, device="cpu")
    assert card.keys() == cpu.keys()
    for k in cpu:
        assert abs(card[k] - cpu[k]) <= 1e-6, (k, card[k], cpu[k])
    for q, r in ((rec, gt), (gt, rec)):
        np.testing.assert_allclose(
            pointcloud.nn_distances(q, r, block=1000),
            pointcloud.nn_distances(q, r, block=1000, device="cpu"),
            rtol=0, atol=1e-5)


def _known_pose_scene(root, n_cams=4, n_pts=200, seed=77):
    """tests/test_eval_dataset.py's triangulation scene (its generator
    copied here without jax): cameras on an arc looking at a blob of
    points, noisy projections with random dropout as cached matches, PNG
    images, the true K and world-to-camera poses."""
    from detectorfreesfm_tpu_torch.core.geometry import np_rotmat_to_quat
    from detectorfreesfm_tpu_torch.data import png
    from detectorfreesfm_tpu_torch.data.h5io import save_h5

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n_pts, 3)) + np.array([0, 0, 6.0])
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    poses, uvs = [], []
    for i in range(n_cams):
        ang = (i - (n_cams - 1) / 2) * 0.35
        eye = np.array([4.0 * np.sin(ang), 0.5 * np.sin(i),
                        6.0 - 4.0 * np.cos(ang)])
        z = np.array([0, 0, 6.0]) - eye
        z /= np.linalg.norm(z)
        x = np.cross([0.0, -1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        t = -R @ eye
        uv = ((pts @ R.T + t) / (pts @ R.T + t)[:, 2:]) @ K.T
        poses.append((np_rotmat_to_quat(R), t))
        uvs.append(uv[:, :2] + rng.normal(0, 0.4, (n_pts, 2)))
    visible = rng.uniform(size=(n_cams, n_pts)) > 0.25
    rng = np.random.default_rng(11)
    kps, kpt_of_pt = {}, {}
    for i in range(n_cams):
        visible[i] &= ((uvs[i] > 0) & (uvs[i] < [640, 480])).all(1)
        ids = np.flatnonzero(visible[i])
        perm = rng.permutation(len(ids))
        kps[f"im{i:02d}.png"] = uvs[i][ids][perm]
        kpt_of_pt[i] = {int(ids[perm[k]]): k for k in range(len(ids))}
    matches = {
        f"im{i:02d}.png|im{j:02d}.png": np.array(
            [[kpt_of_pt[i][int(p)], kpt_of_pt[j][int(p)]]
             for p in np.flatnonzero(visible[i] & visible[j])],
            np.int32).reshape(-1, 2)
        for i in range(n_cams) for j in range(i + 1, n_cams)}
    image_dir = os.path.join(root, "images")
    os.makedirs(image_dir)
    for n in kps:
        png.write_png(os.path.join(image_dir, n),
                      rng.integers(0, 255, (480, 640), dtype=np.uint8))
    stores = {}
    for out in ("cpu", "cuda"):
        d = os.path.join(root, out)
        os.makedirs(d)
        save_h5(kps, os.path.join(d, "keypoints.h5"))
        save_h5(matches, os.path.join(d, "matches.h5"))
        stores[out] = d
    return image_dir, stores, {n: K for n in kps}, {
        f"im{i:02d}.png": poses[i] for i in range(n_cams)}


@pytest.mark.cuda
def test_known_pose_triangulation_on_the_card_equals_the_cpu(tmp_path):
    """reconstruct_scene's triangulation mode (cached matches, true poses,
    no refinement) on the card and on the CPU: the same point count, the
    mean reprojection error within 1e-4 px, every pose its input within
    1e-5."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch import pipeline
    from detectorfreesfm_tpu_torch.sfm.mapper import MapperConfig

    image_dir, stores, intrins, poses = _known_pose_scene(str(tmp_path))
    cfg = pipeline.PipelineConfig(
        img_resize=640, n_refine_iters=0, triangulation_mode=True,
        mapper=MapperConfig(abs_pose_min_num_inliers=10))
    recs = {dev: pipeline.reconstruct_scene(
        image_dir, stores[dev], cfg, intrinsics=intrins, poses=poses,
        device=dev) for dev in ("cpu", "cuda")}
    n = {dev: len(r.points) for dev, r in recs.items()}
    assert n["cuda"] == n["cpu"] > 100, n
    err = {dev: float(np.concatenate(list(
        r.reprojection_errors().values())).mean())
        for dev, r in recs.items()}
    assert abs(err["cuda"] - err["cpu"]) <= 1e-4, err
    for name, (q, t) in poses.items():
        im = recs["cuda"].image_by_name(name)
        np.testing.assert_allclose(im.qvec, q, rtol=0, atol=1e-5)
        np.testing.assert_allclose(im.tvec, t, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("size,fused", [(832, False), (1600, True)])
def test_fused_auto_takes_the_kernels_above_12k_tokens(tmp_path,
                                                       monkeypatch, size,
                                                       fused):
    """The verb's --fused auto on the card: dense at 832 px (10 816 coarse
    tokens), the kernels at 1600 px (40 000), at the card's batch of 8."""
    _needs_cuda()
    import contextlib
    import io

    from detectorfreesfm_tpu_torch import cli, pipeline
    from detectorfreesfm_tpu_torch.sfm.reconstruction import Reconstruction

    seen = {}

    def fake_scene(image_dir, output_dir, cfg, info, **kw):
        seen["cfg"] = cfg
        info.update(refine_iterations_completed=0, refine_error=None,
                    refine_device_error=False)
        return Reconstruction()

    monkeypatch.setattr(pipeline, "reconstruct_scene", fake_scene)
    monkeypatch.setattr(pipeline, "matches_stored", lambda out: True)
    image_dir, _stores, _K, _poses = _known_pose_scene(str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["reconstruct", "--images", image_dir, "--output",
                         str(tmp_path / "out"), "--img-resize", str(size),
                         "--refine-iters", "0"]) == 0
    ecfg = seen["cfg"].engine_config()
    assert ecfg.fused_matching is fused and ecfg.batch_size == 8
    assert ecfg.img_resize == size


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["aspan", "matchformer"])
def test_alt_matcher_forward_on_the_card_equals_the_cpu(arch):
    """The other families' forward on the card (ASpan with the bundled
    weights, MatchFormer from a seeded flax-style init) against the CPU's
    on one 256 px pair in fp32: the dense confidence within 1e-4 of its
    largest value and the mutual-NN match rows at IoU >= 0.99 (threshold
    0 for the random MatchFormer); the model runs on CUDA tensors, and the
    dual-softmax passes stay off its path. On the card ASpan's flow heads
    and window attention and MatchFormer's SR attention run their own
    kernels (ops/flow_expectation.py, ops/span_attention.py,
    ops/sr_attention.py); on the CPU their plain chains."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.models import build_matcher
    from detectorfreesfm_tpu_torch.utils.checkpoint import (flax_init_,
                                                            load_arch_params)

    imgs = generate_scene(0, SyntheticConfig(size=256, n_views=2))[0]
    img0, img1 = (torch.from_numpy(imgs[i:i + 1, ..., None])
                  for i in (0, 1))
    kw = {} if arch == "aspan" else dict(match_threshold=0.0)
    model = build_matcher(arch, **kw)
    if arch == "aspan":
        model.load_state_dict(load_arch_params(
            os.path.join(REPO, "weights", "demo_aspan_bf16.msgpack"),
            "aspan"))
    else:
        flax_init_(model, torch.Generator().manual_seed(0))
    model.eval()
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0
    out = {}
    for dev in ("cpu", "cuda"):
        model.to(dev)
        with torch.no_grad():
            m, conf = model(img0.to(dev), img1.to(dev), return_conf=True)
        assert conf.device.type == dev
        v = m.valid[0].cpu().numpy()
        rows = np.concatenate([m.coords0[0].cpu().numpy(),
                               m.coords1[0].cpu().numpy()], 1)[v]
        out[dev] = ({tuple(r) for r in rows.tolist()}, conf.cpu().numpy())
    assert fused_dsm.launches == {"dsm_pass1": 0, "dsm_pass2": 0}
    (cpu_rows, cpu_conf), (gpu_rows, gpu_conf) = out["cpu"], out["cuda"]
    assert len(cpu_rows) > 40
    assert len(cpu_rows & gpu_rows) / len(cpu_rows | gpu_rows) >= 0.99
    assert np.abs(gpu_conf - cpu_conf).max() <= 1e-4 * cpu_conf.max()


@pytest.mark.cuda
def test_efficientloftr_forward_on_the_card_equals_the_cpu():
    """EfficientLoFTR at its published widths on one 256 px pair in fp32,
    on seeded weights with BatchNorm statistics set on the pair's frames
    by the plain reference (portbench/reference/efficientloftr.py's
    seeded_weights), threshold 0: on the card
    and on the CPU the dense confidence within 1e-4 of its largest value,
    the match cells at IoU >= 0.99, and both keypoints of the matches in
    both within 1e-3 px, but for at most one whose first fine stage picked
    another cell of a near-equal pair (seen on the benchmark's cell at
    ~1e-4 of the slots). Under a profiler every aggregated query on the
    card runs through the kernel of ops/sr_attention.py (the benchmark's
    agg_fused_pct of 100), none on the CPU."""
    _needs_cuda()
    import sys

    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile

    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.models import build_matcher
    from detectorfreesfm_tpu_torch.utils import profiler
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        flax_variables_to_state_dict)
    from portbench import harness
    from portbench.reference.efficientloftr import seeded_weights

    imgs = generate_scene(0, SyntheticConfig(size=256, n_views=3))[0]
    x = torch.from_numpy(imgs[..., None])
    model = build_matcher("efficientloftr", match_threshold=0.0)
    model.load_state_dict(flax_variables_to_state_dict(seeded_weights(
        harness.load_json("configs", "efficientloftr"), 2 ** 31 + 3,
        x[[0, 0], ..., 0], x[[1, 2], ..., 0])))
    model.eval()
    out = {}
    for dev in ("cpu", "cuda"):
        model.to(dev)
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
            m, conf = model(x[:1].to(dev), x[1:2].to(dev), return_conf=True)
        counters = profiler.snapshot()["counters"]
        v = m.valid[0].cpu()
        cells = (m.coords0[0][v].cpu() / 8).round().long()
        keys = (cells[:, 1] * 32 + cells[:, 0]).tolist()
        out[dev] = ({k: (m.coords0[0][v][i].cpu(), m.coords1[0][v][i].cpu())
                     for i, k in enumerate(keys)}, conf.cpu(), counters)
    (cpu, cpu_conf, cpu_n), (gpu, gpu_conf, gpu_n) = out["cpu"], out["cuda"]
    assert cpu_n["eloftr/attn_fused"] == 0 < cpu_n["eloftr/attn_queries"]
    assert gpu_n["eloftr/attn_fused"] == gpu_n["eloftr/attn_queries"] > 0
    assert float((gpu_conf - cpu_conf).abs().max()) <= 1e-4 * float(
        cpu_conf.max())
    assert len(cpu) > 40
    both = cpu.keys() & gpu.keys()
    assert len(both) / len(cpu.keys() | gpu.keys()) >= 0.99
    gaps = [max(float((a - b).abs().max()) for a, b in zip(cpu[k], gpu[k]))
            for k in both]
    assert sum(g > 1e-3 for g in gaps) <= 1


@pytest.mark.cuda
def test_trace_shows_both_passes_inside_match_forward(tmp_path):
    """utils.profiler.trace_to of one fused batch (2 pairs at 256 px):
    the Chrome trace holds the engine's `engine/match_forward` range and,
    inside it, the kernels of dsm_pass1 and dsm_pass2 (CUPTI sees kernels
    launched through ctypes too)."""
    _needs_cuda()
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke
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
    from detectorfreesfm_tpu_torch.utils.profiler import trace_to

    imgs = generate_scene(1, SyntheticConfig(size=256, n_views=3))[0]
    names = [f"v{i}" for i in range(3)]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = exhaustive_pairs(names)[:2]
    cfg = EngineConfig(img_resize=256, fused_matching=True, batch_size=2)
    engine = PairMatchingEngine(
        cfg, load_matcher_params(WEIGHTS, cfg.matcher_config()))
    engine.match_pairs(pairs, images)  # warm-up: builds the kernels
    with trace_to(str(tmp_path)):
        engine.match_pairs(pairs, images)
    found = chip_smoke.trace_kernels_in_range(str(tmp_path),
                                              "engine/match_forward")
    assert found["ranges"] == 1, found
    assert found["kernels_in_range"]["dsm_pass1"] >= 1, found
    assert found["kernels_in_range"]["dsm_pass2"] >= 1, found


@pytest.mark.cuda
def test_kernels_launch_on_the_card_of_their_inputs():
    """Inputs on the last visible card while the first is current: both
    passes run there (the library's SM count, shared-memory limit and
    stream are that card's) and agree with their plain versions; the
    current card is left as it was. Needs two cards (the smoke's mesh
    phase runs the same gate where two are present)."""
    _needs_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    last = torch.device("cuda", n - 1)
    f0, f1, m0, m1 = (t.to(last) for t in _features(2, 1000, 777, 256))
    ops = fused_dsm.split_features(f0, f1, m0, m1)
    with torch.cuda.device(0):
        lse_r, lse_c = fused_dsm.dsm_pass1(*ops)
        _, rarg, _, carg = fused_dsm.dsm_pass2(*ops, lse_r, lse_c)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(last)
    ref_r, ref_c = fused_dsm.dsm_pass1_plain(*ops)
    _, prarg, _, pcarg = fused_dsm.dsm_pass2_plain(*ops, lse_r, lse_c)
    assert lse_r.device == last and rarg.device == last
    assert (lse_r - ref_r)[m0].abs().max().item() <= 2e-3
    assert (lse_c - ref_c)[m1].abs().max().item() <= 2e-3
    assert (rarg == prarg)[m0].float().mean().item() >= 0.995
    assert (carg == pcarg)[m1].float().mean().item() >= 0.995


@pytest.mark.cuda
def test_engine_on_a_two_entry_mesh_of_one_card_equals_one_entry():
    """[cuda:0, cuda:0]: 3 pairs at 256 px, fused, batch 1 per entry (two
    steps, the last padded), give the one-entry engine's matches exactly,
    with one launch of each pass per entry and step."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.parallel.mesh import make_mesh
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    imgs = generate_scene(1, SyntheticConfig(size=256, n_views=3))[0]
    names = [f"v{i}" for i in range(3)]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = exhaustive_pairs(names)
    cfg = EngineConfig(img_resize=256, fine_enabled=True,
                       round_matches_ratio=4, fused_matching=True)
    params = load_matcher_params(WEIGHTS, cfg.matcher_config())
    one = PairMatchingEngine(cfg, params, device="cuda:0").match_pairs(
        pairs, images)
    two = PairMatchingEngine(cfg, params,
                             mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
    assert two.models[0] is two.models[1]
    before = dict(fused_dsm.launches)
    got = two.match_pairs(pairs, images)
    assert {k: fused_dsm.launches[k] - before[k] for k in before} == {
        "dsm_pass1": 4, "dsm_pass2": 4}
    assert list(got) == pairs
    for p in pairs:
        assert len(one[p]["conf"]) > 20
        for k in ("kpts0", "kpts1", "conf"):
            np.testing.assert_array_equal(got[p][k], one[p][k])


@pytest.mark.cuda
def test_layer_spans_agree_with_module_hooks():
    """Over one 832 px step of the engine (8 pairs, the fine stage on) and
    one refinement chunk (512 tracks of 16 slots at window 15, the r4
    weights), under a torch profiler: the program's spans
    `matcher/backbone`, `matcher/coarse_transformer`, `refiner/s2dnet`
    and `refiner/transformer` read within 2% of the CUDA events that
    portbench/timing.py's ModuleTimer records in forward hooks around the
    same calls; `matcher/dual_softmax` and `matcher/fine` read a device
    time too."""
    _needs_cuda()
    import sys

    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile

    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner, RefinerConfig)
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_matcher_params, load_refiner_params)
    from detectorfreesfm_tpu_torch.utils.profiler import snapshot
    from portbench.timing import ModuleTimer

    dev = torch.device("cuda", 0)
    imgs = generate_scene(1, SyntheticConfig(size=832, n_views=3))[0]
    names = [f"v{i}" for i in range(3)]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = [(names[i % 3], names[(i + 1) % 3]) for i in range(8)]
    cfg = EngineConfig(img_resize=832, batch_size=8, fine_enabled=True)
    engine = PairMatchingEngine(
        cfg, load_matcher_params(WEIGHTS, cfg.matcher_config()), device=dev)

    rng = np.random.default_rng(5)
    t, v = 512, 16
    mask = rng.uniform(size=(t, v)) > 0.5
    mask[:, :2] = True
    inputs = [torch.as_tensor(a, device=dev) for a in (
        rng.uniform(0, 1, (v, 624, 832, 1)).astype(np.float32),
        rng.integers(0, v, (t, v)),
        rng.uniform(20, 600, (t, v, 2)).astype(np.float32),
        rng.uniform(0.8, 1.25, (t, v)).astype(np.float32), mask)]
    rcfg = RefinerConfig(crop_size=19, window=15)
    refiner = MultiviewRefiner(rcfg)
    refiner.load_state_dict(load_refiner_params(
        os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack"),
        rcfg, dev))
    refiner = refiner.to(dev).eval()

    def step():
        engine.match_pairs(pairs, images)
        with torch.no_grad():
            refiner(*inputs)

    step()  # warm-up: cuDNN's choices
    timer = ModuleTimer({
        "matcher/backbone": [engine.model.backbone],
        "matcher/coarse_transformer": [engine.model.coarse_transformer],
        "refiner/s2dnet": [refiner.backbone],
        "refiner/transformer": [refiner.transformer]}, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step()
    hooks = timer.total_ms()
    timer.remove()
    spans = snapshot()["spans"]
    for name, ms in hooks.items():
        assert spans[name]["calls"] == 1, name
        assert abs(spans[name]["device_ms"] - ms) <= 0.02 * ms, (
            name, spans[name], ms)
    assert spans["matcher/dual_softmax"]["device_ms"] > 0
    assert spans["matcher/fine"]["device_ms"] > 0


# --- ASpan's flow expectation (ops/flow_expectation.py) ---------------------


def _aspan_inputs(size, n_pairs, take):
    """{layer: take[layer](module, args)}: what the bundled ASpan model's
    layers named in `take` are called with on n_pairs pairs of a
    synthetic scene at size px, as each function of `take` reads it."""
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)
    from detectorfreesfm_tpu_torch.models import build_matcher
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_arch_params

    model = build_matcher("aspan")
    model.load_state_dict(load_arch_params(
        os.path.join(REPO, "weights", "demo_aspan_bf16.msgpack"), "aspan"))
    model = model.cuda().eval()
    n_views = 5 if n_pairs > 1 else 2
    imgs = generate_scene(0, SyntheticConfig(size=size, n_views=n_views))[0]
    pairs = [(i, j) for i in range(n_views)
             for j in range(i + 1, n_views)][:n_pairs]
    x = torch.from_numpy(imgs[..., None]).cuda()
    got, hooks = {}, []
    for name, fn in take.items():
        def hook(mod, args, _out, name=name, fn=fn):
            got[name] = fn(mod, args)
        hooks.append(getattr(model, name).register_forward_hook(hook))
    with torch.no_grad():
        model(x[[a for a, _ in pairs]], x[[b for _, b in pairs]])
    for h in hooks:
        h.remove()
    return got


def _flow_projections(size, n_pairs, heads=("flow0_0", "flow0_3")):
    """{head: (q, k, w)}: the fp32 projections that the bundled ASpan
    model's flow heads of rounds 0 and 3 (direction 0) take on n_pairs
    pairs of a synthetic scene at size px."""
    def take(mod, args):
        xx, src, hw = args
        return (mod.proj_q(xx).float().contiguous(),
                mod.proj_k(src).float().contiguous(), hw[1])

    return _aspan_inputs(size, n_pairs, {name: take for name in heads})


def _flow_errors(q, k, w):
    """Largest |difference| in cells of the kernel from the plain version
    and of both from the float64 expectation, and the device memory the
    kernel's call took above what was allocated before it."""
    from detectorfreesfm_tpu_torch.ops import flow_expectation as fe

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = fe.launches["flow_expectation"]
    got = fe.flow_expectation(q, k, w)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert fe.launches["flow_expectation"] == before + 1
    plain = fe.flow_expectation_plain(q, k, w)
    grid = fe.grid_xy(k.shape[1], w, q.device).double()
    ref = torch.cat([torch.matmul(torch.softmax(torch.bmm(
        q[i:i + 1].double(), k[i:i + 1].double().transpose(1, 2)) / 8.0,
        dim=-1), grid) for i in range(q.shape[0])])
    return dict(kernel=(got - plain).abs().max().item(),
                kernel_f64=(got.double() - ref).abs().max().item(),
                plain_f64=(plain.double() - ref).abs().max().item(),
                extra_bytes=extra)


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["float32", "bf16_valued"])
def test_flow_kernel_on_the_cells_projections(values):
    """832 px, B = 8 pairs (L = 10 816, w = 104), the bundled weights'
    projections of rounds 0 and 3 (logits up to ~41), as they are or
    rounded to bf16 values: the kernel within 1e-3 cells of the plain
    version (read 4.3e-4 to 5.4e-4; the plain version itself lies
    4.4e-4 to 5.6e-4 from the float64 expectation), no farther from the
    float64 expectation than the plain version plus 5e-5 cells (read
    0.8e-4 to 1.7e-4 against its 4.4e-4 to 5.6e-4), and no (B, L, L)
    tensor: the call allocates under 100 MB (the plain version's
    similarity alone is 3.74 GB)."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (q, k, w) in _flow_projections(832, 8).items():
        if values == "bf16_valued":
            q, k = q.bfloat16().float(), k.bfloat16().float()
        assert q.shape == (8, 10816, 64) and w == 104
        e = _flow_errors(q, k, w)
        assert e["kernel"] <= 1e-3, (name, e)
        assert e["kernel_f64"] <= e["plain_f64"] + 5e-5, (name, e)
        assert e["extra_bytes"] < 100e6, (name, e)


@pytest.mark.cuda
def test_flow_kernel_at_1600px_batch_1():
    """1600 px, one pair (L = 40 000, w = 200, 313 tiles of 128 keys),
    the bundled weights' round-3 projections: within 1e-3 cells of the
    plain version (read 4.4e-4), no farther from the float64 expectation
    than it plus 5e-5 cells (read 3.2e-4 against 5.0e-4)."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, w = _flow_projections(1600, 1, heads=("flow0_3",))["flow0_3"]
    assert q.shape == (1, 40000, 64) and w == 200
    e = _flow_errors(q, k, w)
    assert e["kernel"] <= 1e-3, e
    assert e["kernel_f64"] <= e["plain_f64"] + 5e-5, e
    assert e["extra_bytes"] < 100e6, e


@pytest.mark.cuda
def test_flow_kernel_on_a_ragged_grid():
    """13 x 17 (L = 221: one full tile of 128 keys and one of 93, rows
    past L in the last row tile), two pairs of random projections (logits
    up to ~5): within 5e-5 cells of the plain version (read 2.9e-6, a
    few ulps of the coordinates)."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k = (torch.randn(2, 221, 64, device="cuda", generator=g)
            for _ in "qk")
    e = _flow_errors(q, k, 17)
    assert e["kernel"] <= 5e-5, e


@pytest.mark.cuda
def test_flow_kernel_keeps_a_running_max():
    """Logits far beyond exp's range, which a softmax without the running
    max would overflow: (a) every query 40 times one key (logits ~580,
    one-hot): each expectation is that key's cell within 1e-5 cells (read
    9.5e-7, an ulp of 16); (b) projections offset by 30 (logits ~7 700,
    the largest key tile after tile): within 5e-5 cells of the plain
    version (read 1.9e-6)."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.ops import flow_expectation as fe

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    k = torch.randn(2, 221, 64, device="cuda", generator=g)
    perm = torch.randperm(221, device="cuda", generator=g)
    q = (40.0 * k[:, perm]).contiguous()
    got = fe.flow_expectation(q, k, 17)
    want = fe.grid_xy(221, 17, "cuda")[perm].expand(2, -1, -1)
    assert (got - want).abs().max().item() <= 1e-5
    q, k = (torch.randn(2, 221, 64, device="cuda", generator=g) * 3 + 30
            for _ in "qk")
    e = _flow_errors(q, k, 17)
    assert e["kernel"] <= 5e-5, e


@pytest.mark.cuda
def test_flow_function_gradients_equal_autograd_through_plain():
    """The autograd Function (kernel forward, recomputing backward) on a
    32 x 32 grid, two pairs: dq and dk within 1e-5 of the largest
    gradient of autograd through the plain version (read 6.6e-7 and
    3.6e-7: sums in another order)."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.ops import flow_expectation as fe

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k = (torch.randn(2, 1024, 64, device="cuda", generator=g) * 1.5
            for _ in "qk")
    weight = torch.randn(2, 1024, 2, device="cuda", generator=g)
    grads = []
    for fn in (fe.flow_expectation, fe.flow_expectation_plain):
        qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
        (fn(qa, ka, 32) * weight).sum().backward()
        grads.append((qa.grad, ka.grad))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_flow_head_counts_its_queries_through_the_kernel():
    """A FlowHead on the card under a profiler: every query counted as
    computed by the kernel (the share flow_fused_pct reads), one launch."""
    _needs_cuda()
    from torch.profiler import ProfilerActivity, profile

    from detectorfreesfm_tpu_torch.models.aspan import FlowHead
    from detectorfreesfm_tpu_torch.ops import flow_expectation as fe
    from detectorfreesfm_tpu_torch.utils import profiler

    torch.manual_seed(0)
    head = FlowHead(256).cuda().eval()
    x, src = (torch.randn(2, 13 * 17, 256, device="cuda") for _ in "xs")
    before = fe.launches["flow_expectation"]
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        head(x, src, (13, 17))
    counters = profiler.snapshot()["counters"]
    assert counters["aspan/flow_queries"] == 2 * 221
    assert counters["aspan/flow_fused"] == 2 * 221
    assert fe.launches["flow_expectation"] == before + 1


# --- ASpan's window attention (ops/span_attention.py) -----------------------


def _span_errors(q, k, v, cells):
    """The kernel's message against the plain chain's: the largest
    |difference|, the largest |plain| value, the share of elements that
    differ, and the device memory the kernel's call took above what was
    allocated before it, beside its message's bytes."""
    from detectorfreesfm_tpu_torch.ops import span_attention as sa

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = sa.launches["span_attention"]
    got = sa.span_attention(q, k, v, cells, 8)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert sa.launches["span_attention"] == before + 1
    assert got.dtype == v.dtype and got.shape == v.shape
    plain = sa.span_attention_plain(q, k, v, cells, 8)
    diff = (got.float() - plain.float()).abs()
    return dict(kernel=diff.max().item(), scale=plain.abs().max().item(),
                differ=(diff > 0).float().mean().item(), extra_bytes=extra,
                out_bytes=got.numel() * got.element_size())


def _edge_clamps(cells, h, w):
    """How many windows repeat a column at the left and right edges and a
    row at the top and bottom."""
    c = cells.reshape(*cells.shape[:2], 5, 5)
    return dict(left=(c[..., :, 0] == c[..., :, 1]).all(-1).sum().item(),
                right=(c[..., :, 3] == c[..., :, 4]).all(-1).sum().item(),
                top=(c[..., 0, :] == c[..., 1, :]).all(-1).sum().item(),
                bottom=(c[..., 3, :] == c[..., 4, :]).all(-1).sum().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_kernel_on_a_ragged_grid(dtype):
    """13 x 17 (L = 221, not a multiple of the block's 8 queries), two
    pairs of random q, k, v (logits up to ~5), flows of up to 12 cells
    that clamp windows at all four edges: fp32 within 1e-5 of the plain
    chain; bf16 within one bf16 ulp of the largest value (sums in another
    order flip a rounding of a probability or of the message)."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.models.aspan import FlowCrossAttention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(2, 221, 256, device="cuda", generator=g).to(dt)
               for _ in "qkv")
    flow = (torch.rand(2, 221, 2, device="cuda", generator=g) - 0.5) * 24
    cells = FlowCrossAttention(256, 8, 2).window_cells(flow, (13, 17))
    assert min(_edge_clamps(cells, 13, 17).values()) > 0
    e = _span_errors(q, k, v, cells)
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * e["scale"]
    assert e["kernel"] <= tol, e


@pytest.mark.cuda
def test_span_kernel_on_the_cells_projections():
    """832 px, B = 8 pairs (L = 10 816), the bundled weights' fp32
    projections and windows of the cross layers of rounds 0 and 3
    (direction 0): within 1e-5 of the largest value of the plain chain
    (read 9.4e-6 and 1.26e-5 against largest values of 13.3 and 14.2:
    sums in another order), and no gathered tensor: the call allocates
    its message and nothing more (the plain chain gathers 2.2 GB for k
    and for v)."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False

    def take(mod, args):
        x, src, hw, flow = args
        return (mod.q_proj(x), mod.k_proj(src), mod.v_proj(src),
                mod.window_cells(flow, hw))

    got = _aspan_inputs(832, 8, {n: take for n in ("cross0_0", "cross0_3")})
    for name, (q, k, v, cells) in got.items():
        assert q.shape == (8, 10816, 256) and q.dtype == torch.float32
        e = _span_errors(q, k, v, cells)
        assert e["kernel"] <= 1e-5 * e["scale"], (name, e)
        assert e["extra_bytes"] <= e["out_bytes"] + 2 ** 20, (name, e)


@pytest.mark.cuda
def test_span_function_gradients_equal_autograd_through_plain():
    """The autograd Function (kernel forward, recomputing backward) on a
    32 x 32 grid, two pairs: dq, dk and dv within 1e-5 of the largest
    gradient of autograd through the plain chain (the gathers' backward
    adds with atomics, in no fixed order)."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.models.aspan import FlowCrossAttention
    from detectorfreesfm_tpu_torch.ops import span_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(2, 1024, 256, device="cuda", generator=g)
               for _ in "qkv")
    flow = (torch.rand(2, 1024, 2, device="cuda", generator=g) - 0.5) * 8
    cells = FlowCrossAttention(256, 8, 2).window_cells(flow, (32, 32))
    weight = torch.randn(2, 1024, 256, device="cuda", generator=g)
    grads = []
    for fn in (sa.span_attention, sa.span_attention_plain):
        qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
        (fn(qa, ka, va, cells, 8) * weight).sum().backward()
        grads.append((qa.grad, ka.grad, va.grad))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_flow_cross_attention_counts_its_queries_through_the_kernel():
    """A FlowCrossAttention on the card under a profiler: every window
    query counted as computed by the kernel (the share span_fused_pct
    reads), one launch."""
    _needs_cuda()
    from torch.profiler import ProfilerActivity, profile

    from detectorfreesfm_tpu_torch.models.aspan import FlowCrossAttention
    from detectorfreesfm_tpu_torch.ops import span_attention as sa
    from detectorfreesfm_tpu_torch.utils import profiler

    torch.manual_seed(0)
    layer = FlowCrossAttention(256, 8, 2).cuda().eval()
    x, src = (torch.randn(2, 13 * 17, 256, device="cuda") for _ in "xs")
    flow = torch.randn(2, 13 * 17, 2, device="cuda") * 3
    before = sa.launches["span_attention"]
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        layer(x, src, (13, 17), flow)
    counters = profiler.snapshot()["counters"]
    assert counters["aspan/window_queries"] == 2 * 221
    assert counters["aspan/span_fused"] == 2 * 221
    assert sa.launches["span_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width", "window"])
def test_span_kernel_refuses_other_sizes(case):
    """The plain chain takes any head layout and window; on the card the
    kernel's 256 channels, 8 heads and 25 cells, or a ValueError."""
    _needs_cuda()
    from detectorfreesfm_tpu_torch.ops import span_attention as sa

    d, kk = (128, 25) if case == "width" else (256, 9)
    q, k, v = (torch.randn(1, 35, d, device="cuda") for _ in "qkv")
    cells = torch.randint(0, 35, (1, 35, kk), device="cuda")
    with pytest.raises(ValueError, match="the kernel is built for"):
        sa.span_attention(q, k, v, cells, 8)
