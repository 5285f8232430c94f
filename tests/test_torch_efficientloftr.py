"""The port's EfficientLoFTR matcher (models/efficientloftr.py) against the
plain reference (portbench/reference/efficientloftr.py) on the CPU, the
reference against transformers' EfficientLoFTRForKeypointMatching on the
same weights, the family's names and refusals, the engine, and its
checkpoints in both directions.

The port against the reference at a small configuration with the
published structure (RepVGG's [1, 2, 4, 14] blocks at widths 8/16/16/32,
one (self, cross) layer of 2 heads, 96 px frames), on seeded weights
whose BatchNorm statistics are those of the seed's frames, both set by the
reference (`seeded_weights`): every part within 1e-5 of
its largest value, keypoints within 1e-4 px. The reference against
transformers at the same widths with 8 heads (transformers' rotary
tables need d / 2 = head width x 4): features within 1e-5 of their
largest value, the same mutual matches, the same fine windows, and both
keypoints within 1e-4 px through transformers' second stage on the
original's first (transformers' own first stage takes its dual-softmax
over the match axis and gathers the window corner's offset for every
match).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from detectorfreesfm_tpu_torch.models import build_matcher  # noqa: E402
from detectorfreesfm_tpu_torch.models import efficientloftr as el  # noqa
from detectorfreesfm_tpu_torch.models.loftr import cells_to_xy  # noqa: E402
from detectorfreesfm_tpu_torch.utils import checkpoint  # noqa: E402
from portbench.reference import efficientloftr as R  # noqa: E402
from portbench.reference import nn as rnn  # noqa: E402
from portbench.reference import weights  # noqa: E402

SIZE = 96
W8, AGG = SIZE // 8, SIZE // 32
DIMS = (8, 16, 16, 32)
REF_CFG = dict(stage_blocks=[1, 2, 4, 14], stage_dims=list(DIMS),
               stage_strides=[2, 1, 2, 2], d_coarse=32, nhead=2,
               n_coarse_layers=1, q_aggregation=4, kv_aggregation=4,
               rope_theta=10000.0, d_mlp=64, fine_kernel=8, fine_slice=8,
               fine_temperature=10.0, dsoftmax_temperature=0.1,
               match_threshold=0.0, border=2, top_k=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs this file beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=3, size=SIZE, seed=3):
    from portbench.scene import frames, render_scene

    return frames(render_scene(seed, n, size, size * 3 // 4, "cpu"), size)


def _model(cfg, seed, frames, **overrides):
    """A port model of `cfg`'s widths, its weights drawn from `seed` and
    its BatchNorm statistics set on `frames`."""
    keys = dict(stage_dims=tuple(cfg["stage_dims"]),
                d_coarse=cfg["d_coarse"], nhead=cfg["nhead"],
                n_coarse_layers=cfg["n_coarse_layers"], d_mlp=cfg["d_mlp"],
                match_threshold=cfg["match_threshold"],
                max_matches=cfg["top_k"], border=cfg["border"])
    model = build_matcher("efficientloftr", **dict(keys, **overrides))
    model.load_state_dict(checkpoint.flax_variables_to_state_dict(
        R.seeded_weights(cfg, seed, frames[[0, 0]], frames[[1, 2]])))
    return model.eval()


def _save(model, path):
    checkpoint.save_checkpoint(
        str(path), checkpoint.state_dict_to_flax_variables(model.state_dict()))
    return str(path)


def _ref_weights(model, path):
    return weights.load(_save(model, path), "cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    frames = _frames()
    model = _model(REF_CFG, 2 ** 31 + 11, frames)
    W = _ref_weights(model, tmp_path_factory.mktemp("eloftr") / "w.msgpack")
    return model, W, frames


def _close(a, b, rel=1e-5):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rel * scale, (
        float((a - b).abs().max()), scale)


def test_repvgg_equals_reference(tiny):
    model, W, frames = tiny
    with torch.no_grad():
        views = model.encode_views(frames[..., None])
    ref = R.backbone(rnn.FP32, W, REF_CFG, frames[:, None])
    assert [tuple(v.shape) for v in views] == [
        (3, 32, W8, W8), (3, 16, 2 * W8, 2 * W8), (3, 16, 4 * W8, 4 * W8)]
    for got, want in zip(views, ref):
        _close(got, want)


@pytest.mark.parametrize("rope", [True, False])
def test_aggregated_attention_equals_reference(tiny, rope):
    """One module: self-attention with the rotary tables, and the same
    module as cross-attention (another source map, no rotation)."""
    model, W, _ = tiny
    g = torch.Generator().manual_seed(4)
    x, src = torch.randn(2, 1, 32, W8, W8, generator=g) * 3
    module = model.transformer.layers[0].self_attention
    p = W["params"]["transformer"]["layers"]["0"]["self_attention"]
    tables = el.rope_tables(AGG, AGG, 32, 10000.0, "cpu") if rope else None
    with torch.no_grad():
        got = module(x, x if rope else src, tables)
    want = R.aggregated_attention(
        rnn.FP32, p, x[0], (x if rope else src)[0], REF_CFG,
        R.rope(AGG, AGG, 32, 10000.0, "cpu") if rope else None)
    _close(got[0], want)
    for a, b in zip(tables or (), R.rope(AGG, AGG, 32, 10000.0, "cpu")):
        _close(a, b, 1e-6)


def test_transformer_is_sequential_and_equals_reference(tiny):
    """Image 1's cross-attention reads image 0's updated features: the
    port equals the reference, and differs from a step that hands image 1
    image 0's features from before the step."""
    model, W, frames = tiny
    with torch.no_grad():
        coarse = model.encode_views(frames[:2, ..., None]).coarse
        got = model.coarse_transformer(coarse, 1)
        layer = model.transformer.layers[0]
        x = layer.self_attention(
            coarse, coarse, el.rope_tables(AGG, AGG, 32, 10000.0, "cpu"))
        parallel = layer.cross_attention(x[1:], x[:1])
    want = R.transformer(rnn.FP32, W, REF_CFG, coarse[0], coarse[1])
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert float((parallel[0] - got[1]).abs().max()) > 1e-2


def test_fusion_and_both_fine_stages_equal_reference(tiny):
    """The full-resolution map, the windows at given cells (corners and
    the padded edge among them, where image 1's window leaves the map
    and the second stage's index wraps) and both keypoints."""
    model, W, frames = tiny
    idx0 = torch.tensor([[0, 13, 27, 143, 36, 11]])
    idx1 = torch.tensor([[143, 14, 27, 0, 50, 132]])
    with torch.no_grad():
        views = model.encode_views(frames[:2, ..., None])
        x = model.coarse_transformer(views.coarse, 1)
        fmap = model.fine_fusion(x / 32 ** 0.5, [views.quarter, views.half])
        w0 = el.windows(fmap[:1], idx0, W8, 8, 0)
        w1 = el.windows(fmap[1:], idx1, W8, 10, -1)
        kp0, kp1 = model.fine(w0, w1, cells_to_xy(idx0, W8),
                              cells_to_xy(idx1, W8))
    rmap = R.fusion(rnn.FP32, W, x, views.quarter, views.half)
    assert fmap.shape == (2, 16, SIZE, SIZE)
    _close(fmap, rmap)
    r0, r1 = R.fine_stage(rnn.FP32, REF_CFG, rmap[0], rmap[1], idx0[0],
                          idx1[0], W8)
    assert float((kp0[0] - r0).abs().max()) <= 1e-4
    assert float((kp1[0] - r1).abs().max()) <= 1e-4
    # The first stage moves image 0's keypoint off the cell's corner too.
    assert float((kp0[0] - cells_to_xy(idx0, W8)[0]).abs().min()) > 0


@pytest.mark.parametrize("pair", ["distinct", "self"])
def test_matcher_equals_reference(tiny, pair):
    """The whole forward (threshold 0, so that the pair matches): the same
    matches, both keypoints within 1e-4 px, confidences within 5e-4 (8e-5
    read: 1 / T = 10 scales the logits' rounding)."""
    model, W, frames = tiny
    i1 = 1 if pair == "distinct" else 0
    hw = torch.tensor([[SIZE * 3 // 4, SIZE]])
    with torch.no_grad():
        out = model(frames[:1, ..., None], frames[i1:i1 + 1, ..., None],
                    hw, hw)
    hw_ = (SIZE * 3 // 4, SIZE)
    ref = R.match_pair(rnn.FP32, W, REF_CFG, frames[0], frames[i1], hw_, hw_)
    v = out.valid[0]
    assert int(v.sum()) == len(ref["conf"]) > 3
    # Image 0's keypoint lies within 3.5 px of its cell's corner.
    cells = (out.coords0[0][v] / 8).round().long()
    got = {int(y * W8 + x): i for i, (x, y) in enumerate(cells.tolist())}
    for j, cell in enumerate(ref["idx0"].tolist()):
        i = got[cell]
        assert float((out.coords0[0][v][i] - ref["kpts0"][j]).abs().max()
                     ) <= 1e-4
        assert float((out.coords1[0][v][i] - ref["kpts1"][j]).abs().max()
                     ) <= 1e-4
        assert abs(float(out.conf[0][v][i] - ref["conf"][j])) <= 5e-4


def test_reference_equals_transformers(tmp_path):
    """transformers' EfficientLoFTRForKeypointMatching and the reference on
    the same weights, carried across by `from_published`."""
    pytest.importorskip("transformers")
    from transformers.models.efficientloftr import (
        modeling_efficientloftr as hf)

    cfg = dict(REF_CFG, nhead=8, border=0)
    frames = _frames()
    model = _model(cfg, 2 ** 31 + 13, frames)
    W = _ref_weights(model, tmp_path / "w.msgpack")
    hcfg = hf.EfficientLoFTRConfig(
        stage_num_blocks=cfg["stage_blocks"], out_features=list(DIMS),
        stage_stride=cfg["stage_strides"], hidden_size=32,
        num_attention_layers=1, num_attention_heads=8,
        coarse_matching_threshold=0.0, coarse_matching_border_removal=0)
    tm = hf.EfficientLoFTRForKeypointMatching(hcfg).eval()
    published = tm.state_dict()
    names = el.from_published({k: k for k in published})
    assert set(names) == set(model.state_dict())
    state = model.state_dict()
    missing, unexpected = tm.load_state_dict(
        {pub: state[port] for port, pub in names.items()}, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    assert set(el.from_published(published)) == set(state)

    x = frames[:2]
    with torch.no_grad():
        feats = tm.efficientloftr(x[None, :, None]).feature_maps
    coarse, quarter, half = R.backbone(rnn.FP32, W, cfg, x[:, None])
    _close(feats[1], half)
    _close(feats[2], quarter)
    c0, c1 = R.transformer(rnn.FP32, W, cfg, coarse[0], coarse[1])
    _close(feats[0][0, 0], c0)
    _close(feats[0][0, 1], c1)

    with torch.no_grad():
        kpts, scores, idx = tm._coarse_matching(feats[0], 8.0)
    ref = R.match_pair(rnn.FP32, W, cfg, x[0], x[1], (SIZE, SIZE),
                       (SIZE, SIZE))
    valid = idx[0, 0] > -1
    theirs = set(zip(idx[0, 0][valid].tolist(),
                     torch.nonzero(valid)[:, 0].tolist()))
    assert theirs == set(zip(ref["idx0"].tolist(), ref["idx1"].tolist()))
    assert len(theirs) > 3

    # transformers' first stage carries a batch axis that the original's
    # tensors lack: its dual-softmax runs over the match axis and image
    # 0's window, and its offsets are gathered along the match axis (the
    # window corner's for every match, given as many matches as window
    # cells). Its windows and its second stage are the original's: hold
    # the reference to them, on the original's first stage (a
    # dual-softmax of each match's two windows).
    conf = torch.rand(1, 64, 64, 64,
                      generator=torch.Generator().manual_seed(0))
    _, corner = tm._get_first_stage_fine_matching(
        conf, torch.zeros(1, 2, 64, 2), 64, 1.0)
    assert torch.all(corner == -3.5)
    i0, i1 = ref["idx0"], ref["idx1"]
    rmap = R.fusion(rnn.FP32, W, torch.stack([c0, c1]), quarter, half)
    with torch.no_grad():
        w0, w1 = tm.refinement_layer(feats[0] / 32 ** 0.5, feats[1:])
    f0, f1 = w0[0, i0], w1[0, i1]                 # (M, 64, C), (M, 100, C)
    u0 = torch.nn.functional.unfold(rmap[:1], 8, stride=8)
    u1 = torch.nn.functional.unfold(rmap[1:], 10, stride=8, padding=1)
    _close(f0, u0.reshape(16, 64, -1)[:, :, i0].permute(2, 1, 0))
    _close(f1, u1.reshape(16, 100, -1)[:, :, i1].permute(2, 1, 0))
    sim = (f0[..., :8] / 8 ** 0.5) @ (f1[..., :8] / 8 ** 0.5).transpose(1, 2)
    first = torch.softmax(sim, 1) * torch.softmax(sim, 2)
    best = first.reshape(-1, 64, 10, 10)[..., 1:-1, 1:-1].reshape(
        len(i0), -1).argmax(1)
    indices = torch.stack([best // 64, best % 64])[None, ..., None]
    off = torch.stack([indices % 8, indices // 8], -1)[..., 0, :] - 3.5
    xy = torch.stack([cells_to_xy(i0, W8), cells_to_xy(i1, W8)])[None]
    with torch.no_grad():
        got = tm._get_second_stage_fine_matching(
            indices, xy + off, f0[None, ..., 8:] @ (
                f1[None, ..., 8:] / 8 ** 0.5).transpose(-1, -2), 64, 1.0)
    assert float((got[0, 0] - ref["kpts0"]).abs().max()) <= 1e-4
    assert float((got[0, 1] - ref["kpts1"]).abs().max()) <= 1e-4


def test_names_widths_and_refusals():
    """build_matcher's names and the published widths (16.0 M
    parameters); bf16 refused by name; frames must be multiples of 32;
    the engine's matcher keeps the family's own fine window."""
    from detectorfreesfm_tpu_torch.match.engine import EngineConfig

    for name in ("efficientloftr", "eloftr", "EfficientLoFTR"):
        assert type(build_matcher(name)) is el.EfficientLoFTRMatcher
    m = build_matcher("efficientloftr")
    cfg = m.cfg
    assert (cfg.stage_blocks, cfg.stage_dims, cfg.stage_strides) == (
        (1, 2, 4, 14), (64, 64, 128, 256), (2, 1, 2, 2))
    assert (cfg.d_coarse, cfg.nhead, cfg.n_coarse_layers, cfg.q_aggregation,
            cfg.kv_aggregation, cfg.fine_kernel, cfg.d_mlp) == (
        256, 8, 4, 4, 4, 8, 512)
    assert sum(p.numel() for p in m.parameters()) == 16_025_216
    assert m.view_bytes(832, 832) == 4 * (104 ** 2 * 256 + 208 ** 2 * 128 +
                                          416 ** 2 * 64)
    with pytest.raises(ValueError, match="efficientloftr"):
        build_matcher("efficientloftr", compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="multiples of 32"):
        m.encode_views(torch.zeros(1, 72, 72, 1))
    ecfg = EngineConfig(matcher="efficientloftr")
    engine_model = build_matcher(ecfg.matcher,
                                 **dataclasses.asdict(ecfg.matcher_config()))
    assert engine_model.cfg.fine_kernel == 8


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The published-width model on seeded, calibrated weights, and its
    checkpoint."""
    cfg = dict(REF_CFG, stage_dims=[64, 64, 128, 256], d_coarse=256,
               nhead=8, n_coarse_layers=4, d_mlp=512, match_threshold=0.2,
               top_k=2048)
    frames = _frames()
    model = _model(cfg, 2 ** 31 + 17, frames, match_threshold=0.0)
    path = _save(model, tmp_path_factory.mktemp("eloftr_pub") / "w.msgpack")
    return model, path, frames


def test_engine_equals_forward_per_pair(published):
    """One match_pairs call (3 pairs, batch 2, through the view store)
    against the forward per pair: the same matches, keypoints within
    1e-4 px and confidences within 5e-5 (7e-6 read: convolutions over a
    batch of 2 and of 1 sum in another order)."""
    from detectorfreesfm_tpu_torch.data.images import LoadedImage
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)

    model, path, frames = published
    ecfg = EngineConfig(matcher="efficientloftr", img_resize=SIZE,
                        batch_size=2, match_threshold=0.0)
    engine = PairMatchingEngine(
        ecfg, checkpoint.load_arch_params(path, "efficientloftr"),
        device="cpu")
    wh = (SIZE, SIZE * 3 // 4)
    names = ["a", "b", "c"]
    images = {n: LoadedImage(frames[i].numpy(), np.ones(2, np.float32),
                             wh, wh) for i, n in enumerate(names)}
    pairs = [("a", "b"), ("a", "c"), ("b", "c")]
    out = engine.match_pairs(pairs, images)
    hw = torch.tensor([[wh[1], wh[0]]])
    for a, b in pairs:
        with torch.no_grad():
            m = model(frames[[names.index(a)], ..., None],
                      frames[[names.index(b)], ..., None], hw, hw)
        v = m.valid[0]
        assert int(v.sum()) == len(out[(a, b)]["conf"]) > 0
        np.testing.assert_allclose(out[(a, b)]["kpts0"],
                                   m.coords0[0][v].numpy(), atol=1e-4)
        np.testing.assert_allclose(out[(a, b)]["kpts1"],
                                   m.coords1[0][v].numpy(), atol=1e-4)
        np.testing.assert_allclose(out[(a, b)]["conf"], m.conf[0][v].numpy(),
                                   atol=5e-5)


def test_checkpoint_loads_strictly_both_ways(published, tmp_path):
    """The family's checkpoint loads into its model bit for bit; it is
    refused as another family's, and another family's is refused as
    this one's."""
    model, path, _ = published
    state = checkpoint.load_arch_params(path, "efficientloftr")
    mine = model.state_dict()
    assert set(state) == set(mine)
    assert all(torch.equal(state[k], mine[k]) for k in mine)
    with pytest.raises(ValueError):
        checkpoint.load_arch_params(path, "matchformer")
    other = _save(build_matcher("matchformer"), tmp_path / "mf.msgpack")
    with pytest.raises(ValueError):
        checkpoint.load_arch_params(other, "efficientloftr")


def test_verb_matches_through_the_engine(published, tmp_path, monkeypatch):
    """reconstruct --matcher-arch efficientloftr --matcher-ckpt CKPT loads
    the checkpoint strictly and matches the scene's pairs through
    PairMatchingEngine with this family (seeded weights match little, so
    the mapper may register nothing: exit 0 or 1)."""
    import chip_smoke
    from detectorfreesfm_tpu_torch import cli
    from detectorfreesfm_tpu_torch.match.engine import PairMatchingEngine

    _, path, _ = published
    calls = []
    match_pairs = PairMatchingEngine.match_pairs

    def spy(self, pairs, images):
        calls.append((type(self.model), len(pairs)))
        return match_pairs(self, pairs, images)

    monkeypatch.setattr(PairMatchingEngine, "match_pairs", spy)
    scene = tmp_path / "scene"
    chip_smoke.write_scene(str(scene), size=SIZE, n_views=3)
    rc = cli.main(["reconstruct", "--scene", str(scene), "--output",
                   str(tmp_path / "out"), "--device", "cpu", "--img-resize",
                   str(SIZE), "--refine-iters", "0", "--matcher-arch",
                   "efficientloftr", "--matcher-ckpt", path])
    assert rc in (0, 1)
    assert calls == [(el.EfficientLoFTRMatcher, 3)]
