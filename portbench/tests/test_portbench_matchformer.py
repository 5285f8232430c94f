"""The MatchFormer cell on the CPU at tiny shapes: the program's engine
(through its view store of frames) against the plain reference
(`reference/matchformer.py`) on seeded weights; faults of the timed path
read `correct` false at the committed limits; the cell's four readers on
a synthetic context; `roofline_matchformer.py`'s counts against hand
counts and torch's FlopCounterMode; the new files found by name."""

import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, roofline, roofline_matchformer
from portbench.reference import matchformer, nn, weights
from portbench.tests.conftest import ROOT

CELL = "matchformer.scene16_832"
TINY = dict(n_views=3, width=96, height=72, frame=96, pairs_per_call=3,
            batch_size=2, sample=3)
READERS = ("sr_attn_ms_per_pair", "encoder_ms_per_pair", "roofline.sr_attn",
           "sr_logits_gb_per_pair")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs this file beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver(seed, **config):
    spec = dict(harness.load_json("workloads", CELL), **TINY)
    return harness.load_driver(spec["driver"])(
        spec, dict(harness.load_json("configs", "matchformer"), **config),
        seed, torch.device("cpu"), harness.ROOT)


def _window(d, units=1):
    d.setup(False)
    for i in range(units):
        d.run_unit(i)
    d.release()
    return d


def test_program_equals_reference():
    """Seeded weights, threshold 0 so that the pairs match: the same
    matches, and the last stage's features within 1e-5 (2.4e-6 read; the
    features are LayerNorm outputs, ~4 at most). A second call, which
    wraps around the list, keeps no pair twice."""
    d = _window(_driver(2 ** 31 + 23, match_threshold=0.0), units=2)
    keys = sorted(d.outputs)
    assert len(keys) == 3 and not d.held
    assert sum(len(d.outputs[k]["conf"]) for k in keys) > 30
    got = {c["name"]: c["value"] for c in
           d.compare(d.outputs, d.reference(keys))}
    assert got["match_set_gap"] == 0.0
    assert 0 < got["feat_gap"] <= 1e-5


def test_rows_are_named_by_their_frames(monkeypatch):
    """An engine that runs a call's pairs in another order still gives
    each pair its own features: the driver names a step's rows by the
    frames the matcher was handed, not by the engine's schedule."""
    from detectorfreesfm_tpu_torch.match.engine import PairMatchingEngine

    match_pairs = PairMatchingEngine.match_pairs
    monkeypatch.setattr(PairMatchingEngine, "match_pairs",
                        lambda self, pairs, images:
                        match_pairs(self, pairs[::-1], images))
    d = _window(_driver(2 ** 31 + 29))
    keys = sorted(d.outputs)
    got = {c["name"]: c["value"] for c in
           d.compare(d.outputs, d.reference(keys))}
    assert len(keys) == 3 and 0 < got["feat_gap"] <= 1e-5


def _run(seed=2 ** 31 + 101):
    return harness.run(CELL, seed, 0, False, device="cpu", overrides=TINY,
                       out=io.StringIO())


class _Skip(torch.nn.Module):
    def forward(self, x, source_map):
        return x


def _break_matcher(monkeypatch, fault):
    from detectorfreesfm_tpu_torch.models.loftr import MatchOutput
    from detectorfreesfm_tpu_torch.models.matchformer import (
        MatchFormerMatcher, SRAttention)

    if fault == "scaled":                # the last features 0.1% high
        forward = SRAttention.forward

        def scaled(self, x, source_map):
            out = forward(self, x, source_map)
            return out * 1.001 if self.dim == 256 else out

        monkeypatch.setattr(SRAttention, "forward", scaled)
    elif fault == "skipped":             # one block left out
        match_views = MatchFormerMatcher.match_views

        def skipped(self, *args, **kw):
            block, self.s1_b1_self = self.s1_b1_self, _Skip()
            try:
                return match_views(self, *args, **kw)
            finally:
                self.s1_b1_self = block

        monkeypatch.setattr(MatchFormerMatcher, "match_views", skipped)
    elif fault in ("ln_bias", "ln_scale"):   # one LayerNorm's bias or
        match_views = MatchFormerMatcher.match_views   # scale left out

        def dropped(self, *args, **kw):
            ln = self.s1_b0_self.ln
            p = ln.bias if fault == "ln_bias" else ln.weight
            kept = p.data.clone()
            p.data.fill_(0.0 if fault == "ln_bias" else 1.0)
            try:
                return match_views(self, *args, **kw)
            finally:
                p.data.copy_(kept)

        monkeypatch.setattr(MatchFormerMatcher, "match_views", dropped)
    elif fault == "spurious":            # a match where there is none
        forward = MatchFormerMatcher.forward

        def spurious(self, *args, **kw):
            c0, c1, conf, valid = (t.clone() for t in
                                   forward(self, *args, **kw))
            valid[0, 0] = True
            return MatchOutput(c0, c1, conf, valid)

        monkeypatch.setattr(MatchFormerMatcher, "forward", spurious)


def test_sound_run_is_correct():
    assert _run()["correct"] is True


@pytest.mark.parametrize("fault", ["scaled", "skipped", "spurious",
                                   "ln_bias", "ln_scale"])
def test_faults_are_caught(monkeypatch, fault):
    _break_matcher(monkeypatch, fault)
    result = _run()
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_seeded_weights_are_drawn_from_the_seed():
    """Every leaf from the seed, none at the program's init: no LayerNorm
    at identity, no zero bias; the same seed the same tree."""
    from portbench.drivers.matchformer_pairs import seeded_tree

    cfg = harness.load_json("configs", "matchformer")

    def leaves(tree):
        for k, v in tree.items():
            yield from (leaves(v) if isinstance(v, dict) else [(k, v)])

    a, b, c = (dict(enumerate(leaves(seeded_tree(cfg, s))))
               for s in (2 ** 31 + 5, 2 ** 31 + 5, 6))
    assert all(torch.equal(a[i][1], b[i][1]) for i in a)
    assert not any(torch.equal(a[i][1], c[i][1]) for i in a)
    for name, t in a.values():
        if name == "scale":
            assert (t != 1).all() and 0.5 < float(t.mean()) < 1.5
        else:
            assert (t != 0).all()


def test_bf16_compute_is_caught():
    d = _window(_driver(2 ** 31 + 101, compute_dtype="bfloat16"))
    assert d.outputs[d.pairs[0]]["feat0"].dtype == torch.bfloat16
    got = {c["name"]: c for c in d.check()}
    assert got["feat_gap"]["value"] > got["feat_gap"]["limit"]
    assert d.failed_answers() >= 1


def test_readers_on_a_synthetic_context(monkeypatch):
    from detectorfreesfm_tpu_torch.utils import profiler

    readers = harness.load_metrics()
    snap = {"spans": {"matcher/sr_attention": {"device_ms": 640.0},
                      "matcher/encoder": {"device_ms": 960.0}},
            "counters": {"engine/pairs": 64,
                         "matchformer/logit_bytes": 128e9}}
    monkeypatch.setattr(profiler, "snapshot", lambda: snap)
    # 9.89 TFLOP take 10 ms at the peak; 6.7 GB take 2 ms
    ctx = types.SimpleNamespace(counters={"traced_sr_attn_flops": 9.89e12,
                                          "traced_sr_attn_bytes": 6.7e9})
    got = {n: readers[n].read(ctx) for n in READERS}
    assert got == pytest.approx({
        "sr_attn_ms_per_pair": 10.0, "encoder_ms_per_pair": 15.0,
        "roofline.sr_attn": 100.0 * 10.0 / 640.0,
        "sr_logits_gb_per_pair": 2.0})
    # Off the card (no device time), or with no MatchFormer run, nothing.
    snap["spans"] = {n: {"device_ms": None} for n in snap["spans"]}
    snap["counters"] = {"engine/pairs": 64}
    assert all(readers[n].read(ctx) is None for n in READERS)


def test_hand_counts():
    n, m, c = 6, 4, 8
    assert roofline_matchformer.attention_products(n, m, c) == 2 * (
        n * m * c + n * m * c)
    assert roofline_matchformer.attention_bytes(n, m, c) == 4 * (
        n * c + m * c + m * c + n * c)
    # q; k and v; q.k and attn.v; proj; mlp1; mlp2
    assert roofline_matchformer.layer(n, m, c) == 2 * (
        n * c * c + 2 * m * c * c + 2 * n * m * c + n * c * c +
        n * c * 2 * c + n * 2 * c * c)
    cfg = {"stage_dims": [4, 8], "stage_blocks": [1, 2], "sr_ratios": [4, 2],
           "border": 1}
    assert roofline_matchformer.stages(cfg, 32) == [(16, 4, 1, 16),
                                                    (8, 8, 2, 16)]
    assert roofline_matchformer.sr_attention(cfg, 32) == (
        4 * roofline_matchformer.attention_products(256, 16, 4) +
        8 * roofline_matchformer.attention_products(64, 16, 8),
        4 * roofline_matchformer.attention_bytes(256, 16, 4) +
        8 * roofline_matchformer.attention_bytes(64, 16, 8))
    assert roofline_matchformer.pair(cfg, 32, (32, 24), (32, 24)) == (
        2 * (roofline.conv(1, 4, 3, 16, 16) + roofline.conv(4, 8, 3, 8, 8) +
             2 * roofline_matchformer.layer(256, 16, 4) +
             4 * roofline_matchformer.layer(64, 16, 8)) +
        2 * 2 * 2 * 8)                   # 2 x 2 live cells, width 8


def test_counts_match_the_flop_counter(tmp_path):
    """One 64 px pair of the reference on seeded weights."""
    from portbench.drivers.matchformer_pairs import seeded_checkpoint

    cfg = harness.load_json("configs", "matchformer")
    W = weights.load(seeded_checkpoint(str(tmp_path / "w.msgpack"), cfg, 7),
                     "cpu")
    img = torch.rand(2, 64, 64, generator=torch.Generator().manual_seed(0))
    hw = (56, 64)
    with nn.exact_fp32(), FlopCounterMode(display=False) as fc:
        matchformer.match_pair(nn.FP32, W, cfg, img[0], img[1], hw, hw)
    assert fc.get_total_flops() == roofline_matchformer.pair(cfg, 64, hw,
                                                             hw)


def test_the_new_files_are_found_by_name():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.load_json("workloads", CELL)
    config = harness.load_json("configs", cell["config"])
    assert harness.load_driver(cell["driver"]).END_TO_END[0] == "pairs_per_s"
    assert (cell["config"], config["name"], config["reduced"]) == (
        "matchformer", "matchformer", [])
    readers = harness.load_metrics()
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL]
            assert readers[m["name"]].MOVES == "pairs_per_s"
    assert {m["name"] for m in bench["per_layer"]} >= set(READERS)
    assert CELL in {w["name"] for w in bench["workloads"]}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, {!r}); "
            "from portbench.reference import matchformer; "
            "from portbench import roofline_matchformer; "
            "print(json.dumps(sorted({{m.split('.')[0] "
            "for m in sys.modules}})))").format(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "detectorfreesfm_tpu",
                        "detectorfreesfm_tpu_torch"}
