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
