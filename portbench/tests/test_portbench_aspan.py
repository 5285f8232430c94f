"""The ASpan cell on the CPU at tiny shapes: the program's engine (through
its view store) against the plain reference (`reference/aspan.py`) on the
bundled weights and on seeded random ones; faults of the timed path read
`correct` false at the committed limits; the cell's four readers on a
synthetic context; `roofline_aspan.py`'s counts against hand counts and
torch's FlopCounterMode."""

import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, roofline, roofline_aspan
from portbench.reference import aspan, nn, weights
from portbench.tests.conftest import ROOT

CELL = "aspan_r4.scene16_832"
TINY = dict(n_views=3, width=96, height=72, frame=96, pairs_per_call=3,
            batch_size=2, sample=3)
ASPAN = os.path.join(ROOT, "weights", "demo_aspan_bf16.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs this file beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver(seed, config):
    spec = dict(harness.load_json("workloads", CELL), **TINY)
    return harness.load_driver(spec["driver"])(
        spec, config, seed, torch.device("cpu"), harness.ROOT)


def _random_weights(path, seed):
    """A checkpoint of the ASpan matcher whose rounds (self, flow and span
    layers) are drawn from `seed` as flax draws them, behind the bundled
    backbone: random convolutions give every cell nearly the same feature,
    and nothing would match."""
    from detectorfreesfm_tpu_torch.models import build_matcher
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        flax_init_, load_arch_params, save_checkpoint,
        state_dict_to_flax_variables)

    state = flax_init_(build_matcher("aspan"),
                       torch.Generator().manual_seed(seed)).state_dict()
    state.update((k, v) for k, v in load_arch_params(ASPAN, "aspan").items()
                 if k.startswith("backbone."))
    save_checkpoint(str(path), state_dict_to_flax_variables(state))
    return str(path)


@pytest.mark.parametrize("kind", ["bundled", "random"])
def test_program_equals_reference(kind, tmp_path):
    """The same matches; confidences within what the fp32 summation order
    moves (1/T = 10 scales a feature's rounding in the exponent; 2.5e-6 to
    6e-6 read). Random rounds match little above the threshold, so that
    run keeps every mutual match."""
    config = harness.load_json("configs", "aspan_r4")
    if kind == "random":
        config.update(weights=_random_weights(tmp_path / "w.msgpack", 3),
                      match_threshold=0.0)
    d = _driver(2 ** 31 + 23, config)
    d.setup(False)
    d.run_unit(0)
    d.release()
    keys = sorted(d.outputs)
    assert sum(len(d.outputs[k]["conf"]) for k in keys) > 30
    got = {c["name"]: c["value"] for c in
           d.compare(d.outputs, d.reference(keys))}
    assert got["match_set_gap"] == 0.0
    assert got["conf_gap"] <= 5e-5


def _run(seed=2 ** 31 + 101):
    return harness.run(CELL, seed, 0, False, device="cpu", overrides=TINY,
                       out=io.StringIO())


def _break_matcher(monkeypatch, fault):
    from detectorfreesfm_tpu_torch.models.aspan import ASpanMatcher
    from detectorfreesfm_tpu_torch.models.loftr import MatchOutput

    forward = ASpanMatcher.forward

    def broken(self, *args, **kw):
        c0, c1, conf, valid = (t.clone() for t in forward(self, *args, **kw))
        b = valid.shape[0]
        if fault == "unmatched":         # half the pairs of a step skipped
            valid[b // 2:] = False
        elif fault == "moved":           # one match moved a cell
            c1[0, int(valid[0].nonzero()[0, 0])] += 8.0
        elif fault == "conf":            # the confidences 1% high
            conf = conf * 1.01
        return MatchOutput(c0, c1, conf, valid)

    monkeypatch.setattr(ASpanMatcher, "forward", broken)


def test_sound_run_is_correct():
    assert _run()["correct"] is True


@pytest.mark.parametrize("fault", ["unmatched", "moved", "conf"])
def test_faults_are_caught(monkeypatch, fault):
    _break_matcher(monkeypatch, fault)
    result = _run()
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_readers_on_a_synthetic_context(monkeypatch):
    from detectorfreesfm_tpu_torch.utils import profiler

    readers = harness.load_metrics()
    names = ("flow_head_ms_per_pair", "span_attn_ms_per_pair",
             "roofline.flow_head", "span_clamped_pct")
    snap = {"spans": {"matcher/flow_head": {"device_ms": 640.0},
                      "matcher/span_attention": {"device_ms": 960.0}},
            "counters": {"engine/pairs": 64, "aspan/window_queries": 800,
                         "aspan/window_clamped": 60}}
    monkeypatch.setattr(profiler, "snapshot", lambda: snap)
    # 9.89 TFLOP take 10 ms at the peak; 6.7 GB take 2 ms
    ctx = types.SimpleNamespace(counters={"traced_flow_flops": 9.89e12,
                                          "traced_flow_bytes": 6.7e9})
    got = {n: readers[n].read(ctx) for n in names}
    assert got == pytest.approx({
        "flow_head_ms_per_pair": 10.0, "span_attn_ms_per_pair": 15.0,
        "roofline.flow_head": 100.0 * 10.0 / 640.0, "span_clamped_pct": 7.5})
    # Off the card (no device time), or with no ASpan run, nothing.
    snap["spans"] = {n: {"device_ms": None} for n in snap["spans"]}
    snap["counters"] = {"engine/pairs": 64}
    assert all(readers[n].read(ctx) is None for n in names)


def test_hand_counts():
    l, d, df, k = 6, 8, 4, 9
    assert roofline_aspan.flow_products(l, df) == 2 * (l * l * df +
                                                       l * l * 2)
    assert roofline_aspan.flow_bytes(l, df) == 4 * (l * df * 2 + l * 2)
    assert roofline_aspan.flow_head(l, d, df) == 2 * (
        2 * l * d * df + l * l * df + l * l * 2 + l * d * 2)
    # q, k, v; q.k and attn.v over k cells; merge; mlp1; mlp2
    assert roofline_aspan.span_layer(l, d, k) == 2 * (
        3 * l * d * d + 2 * l * k * d + l * d * d + l * 4 * d * d +
        l * 2 * d * d)
    cfg = {"n_flow_layers": 4, "d_flow": 64}
    assert roofline_aspan.flow_heads(cfg, 32) == (
        8 * roofline_aspan.flow_products(16, 64),
        8 * roofline_aspan.flow_bytes(16, 64))


def _count(fn, *args):
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return fc.get_total_flops(), out


def test_counts_match_the_flop_counter():
    """The port's coarse-only backbone, and one pair of the reference,
    whose imported backbone also runs the top-down path to 1/2 that ASpan
    discards (the counts leave it out)."""
    from detectorfreesfm_tpu_torch.models.backbone import ResNetFPN_8_2

    n, _ = _count(lambda x: ResNetFPN_8_2()(x, fine=False),
                  torch.rand(1, 1, 64, 48))
    assert n == roofline_aspan.backbone_coarse(64, 48)
    cfg = harness.load_json("configs", "aspan_r4")
    W = weights.load(ASPAN, "cpu")
    g = torch.Generator().manual_seed(0)
    img = torch.rand(2, 64, 64, generator=g)
    hw = (56, 64)
    with nn.exact_fp32():
        n, out = _count(aspan.match_pair, nn.FP32, W, cfg, img[0], img[1],
                        hw, hw)
    assert n == (2 * roofline.resnetfpn_8_2(64, 64) +
                 roofline_aspan.pair(cfg, 64, hw, hw))


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, {!r}); "
            "from portbench.reference import aspan; "
            "from portbench import roofline_aspan; "
            "print(json.dumps(sorted({{m.split('.')[0] "
            "for m in sys.modules}})))").format(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "detectorfreesfm_tpu",
                        "detectorfreesfm_tpu_torch"}
