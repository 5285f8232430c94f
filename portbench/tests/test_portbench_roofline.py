"""The operation and byte counters against hand counts and against
torch's FlopCounterMode on the references at small shapes (it counts
convolutions and products, two operations a multiply-add, as they do)."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline
from portbench.reference import loftr, nn, refiner, weights
from portbench.tests.conftest import ROOT

CONFIGS = os.path.join(ROOT, "portbench", "configs")


def _config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def _count(fn, *args):
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return fc.get_total_flops(), out


def test_hand_counts():
    assert roofline.conv(1, 1, 3, 4, 4) == 2 * 9 * 16
    assert roofline.conv(2, 3, 1, 5, 7) == 2 * 2 * 3 * 35
    # one layer: q (l x d x d), k and v (s x d x d), kv (s x d x dh), the
    # denominator (l x d), the output (l x d x dh), merge (l x d x d),
    # mlp1 (l x 2d x 2d), mlp2 (l x 2d x d); two operations each
    l, s, d, h = 3, 5, 8, 2
    dh = d // h
    hand = 2 * (l * d * d + 2 * s * d * d + s * d * dh + l * d +
                l * d * dh + l * d * d + l * 4 * d * d + l * 2 * d * d)
    assert roofline.encoder(l, s, d, h) == hand
    assert roofline.transformer(3, 5, 8, 2, 2) == 2 * (
        roofline.encoder(3, 3, 8, 2) + roofline.encoder(5, 5, 8, 2) +
        roofline.encoder(3, 5, 8, 2) + roofline.encoder(5, 3, 8, 2))
    flops, nbytes = roofline.dual_softmax(10, 20, 4)
    assert flops == 2 * 10 * 20 * 4
    assert nbytes == 4 * 30 * 4 + 4 * 30 + 8 * 30
    assert roofline.live_cells(72, 96, 2) == (9 - 4) * (12 - 4)
    assert roofline.s2dnet(3, 4) == (
        roofline.conv(1, 64, 3, 3, 3) + roofline.conv(64, 64, 3, 3, 3) +
        roofline.conv(64, 128, 3, 2, 2) + roofline.conv(128, 128, 3, 2, 2) +
        roofline.conv(128, 256, 3, 1, 1) +
        2 * roofline.conv(256, 256, 3, 1, 1) +
        roofline.conv(64, 4, 1, 3, 3) + roofline.conv(4, 4, 5, 3, 3) +
        roofline.conv(256, 4, 1, 1, 1) + roofline.conv(4, 4, 5, 1, 1))


def test_roofline_share_takes_the_longer_bound():
    # 989 GFLOP take 1 ms at the peak; 3.35 GB take 1 ms
    assert roofline.roofline_share(989e9, 0, 4e-3) == pytest.approx(25.0)
    assert roofline.roofline_share(0, 3.35e9, 2e-3) == pytest.approx(50.0)
    assert roofline.roofline_share(989e9, 6.7e9, 4e-3) == pytest.approx(50)


@pytest.fixture(scope="module")
def matcher():
    return weights.load(os.path.join(ROOT, "weights",
                                     "demo_matcher_r5_bf16.msgpack"), "cpu")


def test_backbone_and_encoder_match_the_flop_counter(matcher):
    x = torch.rand(1, 1, 64, 48)
    n, _ = _count(loftr.backbone, nn.FP32, matcher, x)
    assert n == roofline.resnetfpn_8_2(64, 48)
    p = matcher["params"]["coarse_transformer"]["layer_1_cross"]
    f0, f1 = torch.rand(1, 7, 256), torch.rand(1, 11, 256)
    n, _ = _count(nn.encoder_layer, nn.FP32, p, f0, f1, None, None, 8, 0.1)
    assert n == roofline.encoder(7, 11, 256, 8)


def test_loftr_pair_matches_the_flop_counter(matcher):
    cfg = _config("loftr_ds_r5")
    g = torch.Generator().manual_seed(0)
    img = torch.rand(2, 96, 96, generator=g)
    img[:, 72:] = 0
    hw = (72, 96)
    img[1, :, 8:] = img[0, :, :-8]          # something to match
    with nn.exact_fp32():
        n, out = _count(loftr.match_pair, nn.FP32, matcher, cfg, img[0],
                        img[1], hw, hw)
    k = len(out["kpts0"])
    assert k > 0
    assert n == roofline.loftr_pair(cfg, 96, hw, hw, k)


def test_refiner_track_matches_the_flop_counter():
    cfg = _config("mvrefiner_r4")
    W = weights.load(os.path.join(ROOT, "weights",
                                  "demo_refiner_r4_bf16.msgpack"), "cpu")
    g = torch.Generator().manual_seed(0)
    images = torch.rand(3, 40, 50, generator=g)
    for n_nodes, window in ((3, 11), (2, 7)):
        node_img = torch.arange(n_nodes)[None] % 3
        node_xy = torch.full((1, n_nodes, 2), 20.0)
        scale = torch.ones(1, n_nodes)
        mask = torch.ones(1, n_nodes, dtype=torch.bool)
        n, _ = _count(refiner.refine, nn.FP32, W, cfg, images, node_img,
                      node_xy, scale, mask, window)
        assert n == roofline.refiner_track(cfg, n_nodes, window)
