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
    """Ragged shapes (not multiples of the 64-row tile): lse within 2e-3
    (0.05 with fast exp, whose ±3% depends on each sum's shift), argmax
    agreement >= 0.995, one launch counted per call."""
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    f0, f1, m0, m1 = _features(2, 1000, 777, 256)
    w0, w1 = m0.float(), m1.float()
    scale = 1.0 / (256 * 0.1)
    before = dict(fused_dsm.launches)
    lse = fused_dsm.dsm_row_lse(f0, f1, w0, w1, scale, fast_exp)
    ref = fused_dsm.row_lse_plain(f0, f1, w0, w1, scale, fast_exp)
    assert (lse - ref)[m0].abs().max().item() <= (0.05 if fast_exp else 2e-3)
    lse_c = fused_dsm.row_lse_plain(f1, f0, w1, w0, scale)  # bias over s
    mx, arg = fused_dsm.dsm_row_argmax(f0, f1, w0, w1, lse_c, scale)
    pmx, parg = fused_dsm.row_argmax_plain(f0, f1, w0, w1, lse_c, scale)
    assert (arg == parg)[m0].float().mean().item() >= 0.995
    assert fused_dsm.launches["dsm_row_lse"] == before["dsm_row_lse"] + 1
    assert (fused_dsm.launches["dsm_row_argmax"]
            == before["dsm_row_argmax"] + 1)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernel_cannot_take():
    _needs_cuda()
    f0, f1, m0, m1 = _features(1, 64, 64, 256)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dsm.dsm_row_lse(f0.transpose(1, 2).contiguous().transpose(1, 2),
                              f1, m0.float(), m1.float(), 1.0)
    g0, g1 = f0[..., :254].contiguous(), f1[..., :254].contiguous()
    with pytest.raises(ValueError, match="C % 4"):
        fused_dsm.dsm_row_lse(g0, g1, m0.float(), m1.float(), 1.0)


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
