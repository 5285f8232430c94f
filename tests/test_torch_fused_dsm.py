"""The fused dual-softmax kernels' plain versions against the JAX Pallas
kernels (run in interpret mode), and the wrappers' CPU contract. The CUDA
kernels themselves are tested on a card by tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from detectorfreesfm_tpu.ops import pallas_dsm
from detectorfreesfm_tpu_torch.ops import _build, fused_dsm
from detectorfreesfm_tpu_torch.ops.dual_softmax import (
    dual_softmax_confidence,
    extract_topk_matches,
)


def _features(b=2, l=300, s=260, c=32, seed=0):
    """Multi-tile, non-divisible grids for the TPU kernel's tiles."""
    rng = np.random.default_rng(seed)
    f0 = rng.normal(0, 1, (b, l, c)).astype(np.float32)
    f1 = rng.normal(0, 1, (b, s, c)).astype(np.float32)
    for bb in range(b):
        dst = rng.choice(s, 40, replace=False)
        f1[bb, dst] = f0[bb, :40] + rng.normal(0, 0.05, (40, c))
    m0 = np.ones((b, l), bool)
    m1 = np.ones((b, s), bool)
    m0[:, -7:] = False
    m1[:, -5:] = False
    return f0 * 3, f1 * 3, m0, m1


def _match_set(m, b):
    v = np.asarray(m.valid[b])
    return set(zip(np.asarray(m.idx0[b])[v].tolist(),
                   np.asarray(m.idx1[b])[v].tolist()))


def _iou(a, b):
    return len(a & b) / max(len(a | b), 1)


@pytest.mark.parametrize("tile_l,tile_s", [(128, 64), (64, 128), (128, 128)])
def test_plain_stats_match_pallas_interpret(tile_l, tile_s):
    f0, f1, m0, m1 = _features(b=1)
    ref = [np.asarray(x) for x in pallas_dsm.dual_softmax_stats(
        *(jnp.asarray(x[0]) for x in (f0, f1, m0, m1)),
        tile_l=tile_l, tile_s=tile_s, interpret=True)]
    ours = [x[0].numpy() for x in fused_dsm.dual_softmax_stats_plain(
        *(torch.from_numpy(x) for x in (f0, f1, m0, m1)))]
    live0, live1 = m0[0], m1[0]
    np.testing.assert_allclose(ours[0][live0], ref[0][live0], rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(ours[1][live1], ref[1][live1], rtol=0,
                               atol=2e-3)
    assert (ours[3] == ref[3])[live0].mean() > 0.995
    assert (ours[5] == ref[5])[live1].mean() > 0.995
    # max of 2z - lse: values of order 2z, compared relative to their size
    np.testing.assert_allclose(ours[2][live0], ref[2][live0], rtol=1e-4,
                               atol=5e-3)
    assert ours[3].dtype == np.int32 and ours[5].dtype == np.int32


@pytest.mark.parametrize("fast_exp,min_iou", [(False, 0.95), (True, 0.90)])
def test_fused_matches_equal_pallas_and_dense(fast_exp, min_iou):
    f0, f1, m0, m1 = _features(seed=3 + fast_exp)
    ref = pallas_dsm.fused_extract_matches(
        *map(jnp.asarray, (f0, f1, m0, m1)), 0.1, 64, tile_l=128, tile_s=128,
        interpret=True, fast_exp=fast_exp)
    args = [torch.from_numpy(x) for x in (f0, f1, m0, m1)]
    ours = fused_dsm.fused_extract_matches(*args, 0.1, 64, fast_exp=fast_exp)
    dense = extract_topk_matches(dual_softmax_confidence(*args), 0.1, 64)
    for b in range(2):
        assert len(_match_set(ours, b)) > 20
        assert _iou(_match_set(ours, b), _match_set(ref, b)) > min_iou
        assert _iou(_match_set(ours, b), _match_set(dense, b)) > min_iou


def test_fast_exp_equals_pallas_bits():
    x = np.linspace(-100, 100, 20001, dtype=np.float32)
    ref = np.asarray(pallas_dsm._fast_exp(jnp.asarray(x)))
    ours = fused_dsm.fast_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_cpu_wrappers_run_plain_and_count_no_launch():
    f0, f1, m0, m1 = (torch.from_numpy(x) for x in _features(l=50, s=40))
    before = dict(fused_dsm.launches)
    w0, w1 = m0.float(), m1.float()
    lse = fused_dsm.dsm_row_lse(f0, f1, w0, w1, 0.5)
    torch.testing.assert_close(lse, fused_dsm.row_lse_plain(f0, f1, w0, w1,
                                                            0.5))
    mx, arg = fused_dsm.dsm_row_argmax(f0, f1, w0, w1, w1 * 0, 0.5)
    assert mx.shape == arg.shape == (2, 50) and arg.dtype == torch.int32
    assert fused_dsm.launches == before


def test_plain_argmax_ties_take_the_first_index():
    a = torch.ones(1, 3, 4)
    b = torch.ones(1, 5, 4)
    ones = torch.ones(1, 5)
    mx, arg = fused_dsm.row_argmax_plain(a, b, torch.ones(1, 3), ones,
                                         ones * 0, 1.0)
    assert arg.tolist() == [[0, 0, 0]]
    # a fully masked row never exceeds the starting value: (NEG, 0)
    mx, arg = fused_dsm.row_argmax_plain(a, b, torch.zeros(1, 3), ones,
                                         ones * 0, 1.0)
    assert arg.tolist() == [[0, 0, 0]] and (mx == fused_dsm.NEG).all()


@pytest.mark.parametrize("bad", ["shape", "dtype", "device_mix"])
def test_wrapper_rejects_bad_inputs(bad):
    f0 = torch.zeros(2, 8, 4)
    f1 = torch.zeros(2, 6, 4)
    m0, m1 = torch.ones(2, 8), torch.ones(2, 6)
    if bad == "shape":
        m1 = torch.ones(2, 5)
    elif bad == "dtype":
        f0 = f0.double()
    else:
        f1 = f1.to("meta")
    with pytest.raises(ValueError):
        fused_dsm.dsm_row_lse(f0, f1, m0, m1, 1.0)


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch):
    path = _build.library_path(fused_dsm.SOURCE)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdual_softmax_") and path.suffix == ".so"
    assert path == _build.library_path(fused_dsm.SOURCE)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
