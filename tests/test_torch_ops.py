"""The port's ops and host helpers against their JAX counterparts, on the
same seeded numpy inputs (fp32 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorfreesfm_tpu.ops import attention as jax_attention
from detectorfreesfm_tpu.ops import dsnt as jax_dsnt
from detectorfreesfm_tpu.ops import dual_softmax as jax_dsm
from detectorfreesfm_tpu_torch.ops import attention, dsnt, dual_softmax


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _qkv(seed, b=2, l=37, s=29, h=4, d=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, l, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    qm = rng.uniform(size=(b, l)) > 0.2
    km = rng.uniform(size=(b, s)) > 0.2
    return q, k, v, qm, km


@pytest.mark.parametrize("kind", ["linear_attention", "full_attention"])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_jax(kind, masked):
    q, k, v, qm, km = _qkv(seed=1 + masked)
    masks = (qm, km) if masked else (None, None)
    ref = getattr(jax_attention, kind)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *(None if m is None else jnp.asarray(m) for m in masks))
    ours = getattr(attention, kind)(
        _t(q), _t(k), _t(v), *(None if m is None else _t(m) for m in masks))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def _features(seed, b=2, l=150, s=130, c=32):
    rng = np.random.default_rng(seed)
    f0 = rng.normal(0, 1, (b, l, c)).astype(np.float32)
    f1 = rng.normal(0, 1, (b, s, c)).astype(np.float32)
    for bb in range(b):
        f1[bb, :40] = f0[bb, :40] + rng.normal(0, 0.05, (40, c))
    m0 = rng.uniform(size=(b, l)) > 0.1
    m1 = rng.uniform(size=(b, s)) > 0.1
    return f0 * 3, f1 * 3, m0, m1


def _pairs(m, b):
    v = np.asarray(m.valid[b])
    return set(zip(np.asarray(m.idx0[b])[v].tolist(),
                   np.asarray(m.idx1[b])[v].tolist()))


def test_dual_softmax_confidence_and_topk_match_jax():
    f0, f1, m0, m1 = _features(0)
    ref = jax_dsm.dual_softmax_confidence(*map(jnp.asarray, (f0, f1, m0, m1)))
    ours = dual_softmax.dual_softmax_confidence(*map(_t, (f0, f1, m0, m1)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(
        dual_softmax.mutual_nearest_mask(ours).numpy(),
        np.asarray(jax_dsm.mutual_nearest_mask(ref)))
    # k=16 cuts through ties at conf ~1, which lax.top_k and torch.topk
    # may order differently: there only the kept values must agree. 400 > L
    # takes the padded-capacity branch.
    for k in (16, 64, 400):
        jm = jax_dsm.extract_topk_matches(ref, 0.1, k)
        tm = dual_softmax.extract_topk_matches(ours, 0.1, k)
        assert tm.idx0.shape == (2, k) and tm.idx0.dtype == torch.int32
        for b in range(2):
            assert len(_pairs(tm, b)) == len(_pairs(jm, b)) >= min(k, 30)
            if k > 16:
                assert _pairs(tm, b) == _pairs(jm, b)
        np.testing.assert_allclose(
            np.sort(tm.conf.numpy(), 1), np.sort(np.asarray(jm.conf), 1),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("valid", [None, ((14, 20), (20, 9))])
def test_border_mask_matches_jax(valid):
    h, w, border = 20, 24, 2
    if valid is None:
        ref = np.asarray(jax_dsm.border_mask(h, w, border))
        ours = dual_softmax.border_mask(h, w, border)
    else:
        vh = np.array([v[0] for v in valid])
        vw = np.array([v[1] for v in valid])
        ref = np.stack([np.asarray(jax_dsm.border_mask(h, w, border, a, b))
                        for a, b in zip(vh, vw)])
        ours = dual_softmax.border_mask(h, w, border, _t(vh), _t(vw))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_soft_argmax_refine_matches_jax():
    rng = np.random.default_rng(3)
    corr = rng.normal(0, 2, (3, 7, 5, 5)).astype(np.float32)
    for normalized in (True, False):
        rc, rs = jax_dsnt.soft_argmax_refine(jnp.asarray(corr), 0.7,
                                             normalized)
        oc, os_ = dsnt.soft_argmax_refine(_t(corr), 0.7, normalized)
        np.testing.assert_allclose(oc.numpy(), np.asarray(rc), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(os_.numpy(), np.asarray(rs), rtol=0,
                                   atol=1e-5)
    ref = jax_dsnt.spatial_expectation2d(jnp.asarray(corr))
    np.testing.assert_allclose(
        dsnt.spatial_expectation2d(_t(corr)).numpy(), np.asarray(ref),
        rtol=0, atol=1e-5)


def test_grid_merge_equals_jax_copy():
    from detectorfreesfm_tpu.ops.grid_merge import (
        merge_matches_to_keypoints as jax_merge,
    )
    from detectorfreesfm_tpu_torch.ops.grid_merge import (
        merge_matches_to_keypoints,
    )

    rng = np.random.default_rng(5)
    pm = {}
    for a, b in [("a", "b"), ("a", "c"), ("b", "c"), ("c", "d")]:
        n = int(rng.integers(0, 60))
        pm[(a, b)] = {
            "kpts0": np.round(rng.uniform(0, 40, (n, 2)) / 4) * 4,
            "kpts1": rng.uniform(0, 40, (n, 2)).astype(np.float32),
            "conf": rng.uniform(0.2, 1, n).astype(np.float32),
        }
    ref = jax_merge(pm)
    ours = merge_matches_to_keypoints(pm)
    for r, o in zip(ref, ours):
        assert r.keys() == o.keys()
        for k in r:
            np.testing.assert_array_equal(o[k], r[k])


def test_position_table_equals_jax_copy():
    from detectorfreesfm_tpu.models.position_encoding import (
        _pe_table as jax_table,
        add_position_encoding as jax_add,
    )
    from detectorfreesfm_tpu_torch.models.position_encoding import (
        _pe_table,
        add_position_encoding,
    )

    np.testing.assert_array_equal(_pe_table(256, 13, 17),
                                  jax_table(256, 13, 17))
    feat = np.random.default_rng(0).normal(0, 1, (2, 13, 17, 64)).astype(
        np.float32)
    np.testing.assert_array_equal(add_position_encoding(_t(feat)).numpy(),
                                  np.asarray(jax_add(jnp.asarray(feat))))


def test_pairs_and_image_helpers_equal_jax(tmp_path):
    from PIL import Image

    from detectorfreesfm_tpu.data import images as jax_images
    from detectorfreesfm_tpu.match import pairs as jax_pairs
    from detectorfreesfm_tpu_torch.data import images
    from detectorfreesfm_tpu_torch.match import pairs

    names = [f"n{i}" for i in range(6)]
    assert pairs.exhaustive_pairs(names) == jax_pairs.exhaustive_pairs(names)
    for loop in (False, True):
        assert (pairs.sequential_pairs(names, 2, loop)
                == jax_pairs.sequential_pairs(names, 2, loop))
    for w, h in [(640, 480), (333, 999), (100, 7)]:
        assert (images._resize_dims(w, h, 832, 8)
                == jax_images._resize_dims(w, h, 832, 8))
    path = str(tmp_path / "img.png")
    arr = np.random.default_rng(2).integers(0, 255, (90, 130), np.uint8)
    Image.fromarray(arr).save(path)
    # Both packages' default backend: the port's png path, the JAX
    # package's native loader where it builds.
    ours = images.load_gray(path, long_side=64, pad_to=64)
    ref = jax_images.load_gray(path, long_side=64, pad_to=64)
    np.testing.assert_array_equal(ours.data, ref.data)
    np.testing.assert_array_equal(ours.scale, ref.scale)
    assert (ours.orig_size, ours.valid_size) == (ref.orig_size,
                                                ref.valid_size)
