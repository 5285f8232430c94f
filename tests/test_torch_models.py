"""The port's matcher modules with the r5 weights against the JAX modules
with the same weights, on the same seeded inputs (fp32 on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorfreesfm_tpu.models import backbone as jax_backbone
from detectorfreesfm_tpu.models import loftr as jax_loftr
from detectorfreesfm_tpu.models import transformer as jax_transformer
from detectorfreesfm_tpu.train.selfsup import load_matcher_params as jax_load
from detectorfreesfm_tpu_torch.models import backbone, loftr, transformer
from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")


@pytest.fixture(scope="module")
def weights():
    jax_vars = jax_load(WEIGHTS, img_size=64,
                        cfg=jax_loftr.MatcherConfig(fine_enabled=True))
    return jax_vars, load_matcher_params(WEIGHTS)


def _sub(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def _scene_pair(size, seed=0):
    from detectorfreesfm_tpu_torch.data.synthetic import (
        SyntheticConfig,
        generate_scene,
    )

    imgs = generate_scene(seed, SyntheticConfig(size=size, n_views=2))[0]
    return imgs[0:1, ..., None], imgs[1:2, ..., None]


def test_backbone_matches_jax(weights):
    jax_vars, state = weights
    img = _scene_pair(128)[0]
    ref_c, ref_f = jax_backbone.ResNetFPN_8_2().apply(
        {"params": jax_vars["params"]["backbone"],
         "batch_stats": jax_vars["batch_stats"]["backbone"]},
        jnp.asarray(img))
    net = backbone.ResNetFPN_8_2().eval()
    net.load_state_dict(_sub(state, "backbone."))
    with torch.no_grad():
        c, f = net(torch.from_numpy(img).permute(0, 3, 1, 2))
    for ours, ref in ((c, ref_c), (f, ref_f)):
        ref = np.asarray(ref)
        ours = ours.permute(0, 2, 3, 1).numpy()
        assert ours.shape == ref.shape
        assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["layer_0_self", "layer_1_cross"])
def test_encoder_layer_matches_jax(weights, name):
    jax_vars, state = weights
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 40, 256)).astype(np.float32)
    src = rng.normal(0, 1, (2, 33, 256)).astype(np.float32)
    xm = rng.uniform(size=(2, 40)) > 0.2
    sm = rng.uniform(size=(2, 33)) > 0.2
    p = jax_vars["params"]["coarse_transformer"][name]
    ref = jax_transformer.EncoderLayer(256, 8).apply(
        {"params": p}, *map(jnp.asarray, (x, src, xm, sm)))
    layer = transformer.EncoderLayer(256, 8).eval()
    layer.load_state_dict(_sub(state, f"coarse_transformer.{name}."))
    with torch.no_grad():
        ours = layer(*map(torch.from_numpy, (x, src, xm, sm)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def _match_rows(out, b=0):
    v = np.asarray(out.valid[b])
    c0 = np.asarray(out.coords0[b])[v]
    c1 = np.asarray(out.coords1[b])[v]
    conf = np.asarray(out.conf[b])[v]
    return {tuple(k): (x, c) for k, x, c in zip(c0.tolist(), c1, conf)}


@pytest.fixture(scope="module")
def jax_matches(weights):
    """The JAX matcher (dense, coarse_fine) at 256 px on a synthetic pair,
    with a live region narrower than the frame."""
    jax_vars, _ = weights
    img0, img1 = _scene_pair(256)
    hw = np.array([[256, 248]], np.int32)
    jcfg = jax_loftr.MatcherConfig(fine_enabled=True)
    ref = jax.jit(jax_loftr.DetectorFreeMatcher(jcfg).apply)(
        jax_vars, jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(hw),
        jnp.asarray(hw))
    return (img0, img1, hw), _match_rows(ref)


@pytest.mark.parametrize("fused", [False, True])
def test_matcher_coarse_fine_matches_jax(weights, jax_matches, fused):
    """The whole matcher: coarse match set IoU >= 0.95; on common matches
    fine coordinates within 0.1 px and confidences within 1e-4. The port
    runs dense or fused (the kernels' plain versions on the CPU)."""
    _, state = weights
    (img0, img1, hw), ref_rows = jax_matches
    model = loftr.DetectorFreeMatcher(
        loftr.MatcherConfig(fine_enabled=True, fused_matching=fused)).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        out = model(torch.from_numpy(img0), torch.from_numpy(img1),
                    torch.from_numpy(hw), torch.from_numpy(hw))
    ours_rows = _match_rows(out)
    assert len(ref_rows) > 100
    # Rows are keyed by image0's coarse cell. A different image1 cell puts
    # coords1 8 px apart less the two fine offsets (each under 4 px), which
    # the 0.1 px bound catches.
    common = set(ours_rows) & set(ref_rows)
    assert len(common) / len(set(ours_rows) | set(ref_rows)) >= 0.95
    d_xy = max(np.abs(ours_rows[k][0] - ref_rows[k][0]).max() for k in common)
    d_conf = max(abs(ours_rows[k][1] - ref_rows[k][1]) for k in common)
    assert d_xy <= 0.1 and d_conf <= 1e-4, (d_xy, d_conf)
