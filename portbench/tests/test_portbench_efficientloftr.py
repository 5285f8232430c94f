"""The EfficientLoFTR cell on the CPU at tiny shapes: the program's engine
(through its view store of RepVGG's maps) against the plain reference
(`reference/efficientloftr.py`) on seeded weights; faults of the timed
path read `correct` false at the committed limits; the cell's five
readers on a synthetic context; `roofline_efficientloftr.py`'s counts
against hand counts and torch's FlopCounterMode; the new files found by
name."""

import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, roofline, roofline_efficientloftr as rl
from portbench.reference import efficientloftr, nn, weights
from portbench.tests.conftest import ROOT

CELL = "efficientloftr.scene16_832"
TINY = dict(n_views=3, width=96, height=72, frame=96, pairs_per_call=3,
            batch_size=2, sample=3)
READERS = ("repvgg_ms_per_pair", "agg_attn_ms_per_pair",
           "fine_fusion_ms_per_pair", "roofline.fine_fusion",
           "agg_fused_pct")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs this file beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver(seed, cell=None, **config):
    spec = dict(harness.load_json("workloads", CELL), **dict(TINY,
                                                             **(cell or {})))
    return harness.load_driver(spec["driver"])(
        spec, dict(harness.load_json("configs", "efficientloftr"), **config),
        seed, torch.device("cpu"), harness.ROOT)


def _window(d, units=1):
    d.setup(False)
    for i in range(units):
        d.run_unit(i)
    d.release()
    return d


def test_program_equals_reference():
    """Seeded weights, threshold 0 so that the pairs match: the same
    matches, no flip, the keypoints at every slot within 1e-4 px and the
    features within 1e-3 (2e-4 read; features ~25 at most). A second
    call, which wraps around the list, keeps no pair twice."""
    d = _window(_driver(2 ** 31 + 23, match_threshold=0.0), units=2)
    keys = sorted(d.outputs)
    assert len(keys) == 3 and not d.held and not d.staged
    assert sum(len(d.outputs[k]["conf"]) for k in keys) > 30
    got = {c["name"]: c["value"] for c in
           d.compare(d.outputs, d.reference(keys))}
    assert got["match_set_gap"] == 0.0 and got["fine_gap_px"] == 0.0
    assert got["slot_flips"] == 0 and got["slot_gap_px"] <= 1e-4
    assert 0 < got["feat_gap"] <= 1e-3


def test_only_the_sample_is_kept():
    """A sample of 2 of the 3 pairs: the window keeps those 2 alone, the
    pairs that a window keeping every pair would sample, and the check
    compares them."""
    from portbench.drivers.engine_pairs import Driver as PairsDriver

    d = _window(_driver(2 ** 31 + 31, cell={"sample": 2}), units=2)
    every = types.SimpleNamespace(outputs=dict.fromkeys(d.pairs),
                                  cell=d.cell, seed=d.seed)
    assert len(d.outputs) == 2
    assert d.sample() == sorted(d.outputs) == PairsDriver.sample(every)


def test_rows_are_named_by_their_frames(monkeypatch):
    """An engine that runs a call's pairs in another order still gives
    each pair its own values: the driver names a step's rows by the
    frames RepVGG was handed, not by the engine's schedule."""
    from detectorfreesfm_tpu_torch.match.engine import PairMatchingEngine

    match_pairs = PairMatchingEngine.match_pairs
    monkeypatch.setattr(PairMatchingEngine, "match_pairs",
                        lambda self, pairs, images:
                        match_pairs(self, pairs[::-1], images))
    d = _window(_driver(2 ** 31 + 29))
    keys = sorted(d.outputs)
    got = {c["name"]: c["value"] for c in
           d.compare(d.outputs, d.reference(keys))}
    assert len(keys) == 3 and got["slot_flips"] == 0
    assert 0 < got["feat_gap"] <= 1e-3


def _run(seed=2 ** 31 + 101):
    return harness.run(CELL, seed, 0, False, device="cpu", overrides=TINY,
                       out=io.StringIO())


def _break_matcher(monkeypatch, fault):
    from detectorfreesfm_tpu_torch.models import efficientloftr as el

    M = el.EfficientLoFTRMatcher
    if fault == "bf16_features":         # the transformer's output in bf16
        forward = el.AggregatedAttention.forward
        monkeypatch.setattr(
            el.AggregatedAttention, "forward",
            lambda self, *a: forward(self, *a).bfloat16().float())
    elif fault == "no_rope":             # RoPE left out
        monkeypatch.setattr(el, "rotate", lambda x, rope: x)
    elif fault == "old_features":        # image 1 reads image 0's old map
        def parallel(self, x, b):
            h, w = (s // self.cfg.q_aggregation for s in x.shape[2:])
            rope = el.rope_tables(h, w, x.shape[1], self.cfg.rope_theta,
                                  x.device)
            for layer in self.transformer.layers:
                x = layer.self_attention(x, x, rope)
                x = torch.cat([layer.cross_attention(x[:b], x[b:]),
                               layer.cross_attention(x[b:], x[:b])])
            return x

        monkeypatch.setattr(M, "coarse_transformer", parallel)
    elif fault == "bn_dropped":          # the fusion's first BN left out
        match_views = M.match_views

        def dropped(self, *args, **kw):
            blk = self.fine_fusion.out_conv_layers[0]
            bn, blk["batch_norm"] = blk["batch_norm"], torch.nn.Identity()
            try:
                return match_views(self, *args, **kw)
            finally:
                blk["batch_norm"] = bn

        monkeypatch.setattr(M, "match_views", dropped)
    elif fault == "stage2_skipped":      # a uniform 3x3: no second stage
        forward = el.FineMatching.forward

        def skipped(self, *args):
            temp, self.temp = self.temp, float("inf")
            try:
                return forward(self, *args)
            finally:
                self.temp = temp

        monkeypatch.setattr(el.FineMatching, "forward", skipped)
    elif fault == "unscaled_fusion":     # coarse features not over sqrt(C)
        forward = el.FineFusion.forward
        monkeypatch.setattr(
            el.FineFusion, "forward",
            lambda self, coarse, res: forward(
                self, coarse * coarse.shape[1] ** 0.5, res))
    elif fault == "moved_1px":           # image 1's keypoints 1 px right
        forward = el.FineMatching.forward

        def moved(self, *args):
            kp0, kp1 = forward(self, *args)
            return kp0, kp1 + torch.tensor([1.0, 0.0])

        monkeypatch.setattr(el.FineMatching, "forward", moved)


def test_sound_run_is_correct():
    assert _run()["correct"] is True


@pytest.mark.parametrize("fault", [
    "bf16_features", "no_rope", "old_features", "bn_dropped",
    "stage2_skipped", "unscaled_fusion", "moved_1px"])
def test_faults_are_caught(monkeypatch, fault):
    _break_matcher(monkeypatch, fault)
    result = _run()
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_seeded_weights_are_drawn_from_the_seed():
    """Every parameter from the seed, none at the program's init (no
    LayerNorm or BatchNorm at identity, no zero kernel or bias); the same
    seed the same tree; the BatchNorm statistics those of the seed's
    frames, not (0, 1)."""
    cfg = harness.load_json("configs", "efficientloftr")

    def leaves(tree):
        for k, v in tree.items():
            yield from (leaves(v) if isinstance(v, dict) else [(k, v)])

    a, b, c = (dict(enumerate(leaves(
        efficientloftr.seeded_tree(cfg, s)["params"])))
        for s in (2 ** 31 + 5, 2 ** 31 + 5, 6))
    assert all(torch.equal(a[i][1], b[i][1]) for i in a)
    assert not any(torch.equal(a[i][1], c[i][1]) for i in a)
    for name, t in a.values():
        if name == "scale":
            assert (t != 1).all() and 0.5 < float(t.mean()) < 1.5
        else:   # a normal draw of exactly 0 is rare, not impossible
            assert float((t != 0).float().mean()) > 0.999
    d = _driver(2 ** 31 + 5)
    d.setup(False)
    d.release()
    W = weights.load(d.weights, "cpu")

    def stats(tree):
        for k, v in tree.items():
            if "mean" in v:
                yield v
            else:
                yield from stats(v)

    found = list(stats(W["batch_stats"]))
    # conv1 and conv2 of 21 blocks, 18 identities, the fusion's 2
    assert len(found) == 2 * 21 + 18 + 2
    for s in found:
        assert not torch.equal(s["mean"], torch.zeros_like(s["mean"]))
        assert not torch.equal(s["var"], torch.ones_like(s["var"]))


def test_readers_on_a_synthetic_context(monkeypatch):
    from detectorfreesfm_tpu_torch.utils import profiler

    readers = harness.load_metrics()
    snap = {"spans": {"matcher/repvgg": {"device_ms": 160.0},
                      "matcher/aggregated_attention": {"device_ms": 320.0},
                      "matcher/fine_fusion": {"device_ms": 640.0}},
            "counters": {"engine/pairs": 64, "eloftr/attn_queries": 400,
                         "eloftr/attn_fused": 300}}
    monkeypatch.setattr(profiler, "snapshot", lambda: snap)
    # 9.89 TFLOP take 10 ms at the peak; 6.7 GB take 2 ms
    ctx = types.SimpleNamespace(counters={"traced_fusion_flops": 9.89e12,
                                          "traced_fusion_bytes": 6.7e9})
    got = {n: readers[n].read(ctx) for n in READERS}
    assert got == pytest.approx({
        "repvgg_ms_per_pair": 2.5, "agg_attn_ms_per_pair": 5.0,
        "fine_fusion_ms_per_pair": 10.0,
        "roofline.fine_fusion": 100.0 * 10.0 / 640.0, "agg_fused_pct": 75.0})
    # Off the card (no device time), or with no EfficientLoFTR run, nothing.
    snap["spans"] = {n: {"device_ms": None} for n in snap["spans"]}
    snap["counters"] = {"engine/pairs": 64}
    assert all(readers[n].read(ctx) is None for n in READERS)


def test_hand_counts():
    cfg = {"stage_blocks": [1, 2], "stage_dims": [4, 8],
           "stage_strides": [2, 2]}
    assert rl.repvgg(cfg, 16, 16) == (
        roofline.conv(1, 4, 3, 8, 8) + roofline.conv(1, 4, 1, 8, 8) +
        roofline.conv(4, 8, 3, 4, 4) + roofline.conv(4, 8, 1, 4, 4) +
        roofline.conv(8, 8, 3, 4, 4) + roofline.conv(8, 8, 1, 4, 4))
    cfg = {"d_coarse": 8, "q_aggregation": 4, "kv_aggregation": 4,
           "d_mlp": 16, "n_coarse_layers": 2, "stage_dims": [2, 2, 4, 8],
           "fine_kernel": 8, "border": 1}
    n = 4   # an 8 x 8 grid aggregated to 2 x 2
    # depthwise; q, k, v, o; QK and AV; the MLP over 64 cells
    module = (2 * 8 * 16 * n + 2 * 4 * n * 8 * 8 + 4 * n * n * 8 +
              2 * 64 * 16 * 16 + 2 * 64 * 16 * 8)
    assert rl.attention_module(cfg, 8, 8) == module
    assert rl.transformer(cfg, 64) == 2 * 2 * 2 * module
    flops, nbytes = rl.fusion(cfg, 64)
    assert flops == 2 * (roofline.conv(8, 8, 1, 8, 8) +
                         roofline.conv(4, 8, 1, 16, 16) +
                         roofline.conv(8, 8, 3, 16, 16) +
                         roofline.conv(8, 4, 3, 16, 16) +
                         roofline.conv(2, 4, 1, 32, 32) +
                         roofline.conv(4, 4, 3, 32, 32) +
                         roofline.conv(4, 2, 3, 32, 32))
    assert nbytes == 2 * 4 * (64 * 8 + 256 * 4 + 1024 * 2 + 4096 * 2)
    assert rl.fine(cfg, 3) == 3 * 2 * 64 * 100 * 2
    assert rl.pair(cfg, 64, (64, 48), (64, 48), 3) == (
        rl.transformer(cfg, 64) + 2 * 24 * 24 * 8 + flops + rl.fine(cfg, 3))


def test_counts_match_the_flop_counter(tmp_path):
    """One 64 px pair of the reference on seeded weights (threshold 0, so
    that its fine stage runs at its matches)."""
    from portbench.drivers.efficientloftr_pairs import seeded_checkpoint

    cfg = dict(harness.load_json("configs", "efficientloftr"),
               match_threshold=0.0)
    img = torch.rand(3, 64, 64, generator=torch.Generator().manual_seed(0))
    W = weights.load(seeded_checkpoint(str(tmp_path / "w.msgpack"), cfg, 7,
                                       img), "cpu")
    hw = (48, 64)
    with nn.exact_fp32(), FlopCounterMode(display=False) as fc:
        out = efficientloftr.match_pair(nn.FP32, W, cfg, img[0], img[1], hw,
                                        hw)
    assert len(out["kpts0"]) > 0
    assert fc.get_total_flops() == (2 * rl.repvgg(cfg, 64, 64) + rl.pair(
        cfg, 64, hw, hw, len(out["kpts0"])))


def test_the_new_files_are_found_by_name():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.load_json("workloads", CELL)
    config = harness.load_json("configs", cell["config"])
    assert harness.load_driver(cell["driver"]).END_TO_END[0] == "pairs_per_s"
    assert (cell["config"], config["name"], config["reduced"]) == (
        "efficientloftr", "efficientloftr", [])
    readers = harness.load_metrics()
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL]
            assert readers[m["name"]].MOVES == "pairs_per_s"
    assert {m["name"] for m in bench["per_layer"]} >= set(READERS)
    assert CELL in {w["name"] for w in bench["workloads"]}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, {!r}); "
            "from portbench.reference import efficientloftr; "
            "from portbench import roofline_efficientloftr; "
            "print(json.dumps(sorted({{m.split('.')[0] "
            "for m in sys.modules}})))").format(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "detectorfreesfm_tpu",
                        "detectorfreesfm_tpu_torch", "transformers"}
