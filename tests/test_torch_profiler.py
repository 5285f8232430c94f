"""The port's profiler (utils/profiler.py) and the scopes of its engine and
refinement against the JAX package's, the port's own spans and counters
(recorded only while a profiler runs), the remaining small names
(plot_matches, the package re-exports, the selfsup loaders), and a walk
over both packages' public names. Counts and names are compared exactly;
the match plot by its image size."""

import copy
import glob
import importlib
import importlib.util
import inspect
import json
import os
import pkgutil
import sys

import jax
import numpy as np
import pytest
import torch

import detectorfreesfm_tpu
import detectorfreesfm_tpu_torch
from detectorfreesfm_tpu.utils import profiler as JPR
from detectorfreesfm_tpu_torch.utils import profiler as TPR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")
REFINER = os.path.join(REPO, "weights", "demo_refiner_r4_bf16.msgpack")
ENGINE_SCOPES = ("engine/load_images", "engine/match_forward",
                 "engine/keypoint_merge")
REFINE_SCOPES = ("refine/pack_tracks", "refine/multiview_match",
                 "refine/geometry_refinement")
SIZE = 64  # the engine's frame: scope counts do not depend on it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- utils/profiler.py ------------------------------------------------------


@pytest.mark.parametrize("prof", [JPR, TPR], ids=["jax", "port"])
def test_profiler_scopes(prof):
    """tests/test_aux.py's test_profiler_scopes, run against both modules."""
    p = prof.SimpleProfiler()
    with p.record_function("phase_a"):
        x = sum(range(1000))
    with p.record_function("phase_a"):
        x += sum(range(1000))
    s = p.summary()
    assert "phase_a" in s
    assert p.counts["phase_a"] == 2
    assert prof.get_profiler(None).summary() == ""


def test_profiler_kinds_and_summaries_equal_jax():
    """get_profiler gives the same classes for the same kinds and refuses
    the same, but for "advanced" (JAX's cProfile per scope), which the
    port refuses: no verb, smoke or benchmark read it, and the port's
    spans and `trace_to` give each scope's host time. SimpleProfiler's
    table is JAX's for the same totals."""
    for kind in (None, "", "pass", "passthrough", "simple"):
        assert (type(TPR.get_profiler(kind)).__name__
                == type(JPR.get_profiler(kind)).__name__)
    assert type(JPR.get_profiler("advanced")).__name__ == "AdvancedProfiler"
    with pytest.raises(ValueError):
        TPR.get_profiler("advanced")
    for prof in (JPR, TPR):
        with pytest.raises(ValueError):
            prof.get_profiler("xprof")
    j, t = JPR.SimpleProfiler(), TPR.SimpleProfiler()
    for p in (j, t):
        p.totals.update({"engine/match_forward": 1.25, "b": 3.5})
        p.counts.update({"engine/match_forward": 3, "b": 7})
    assert t.summary() == j.summary()


# --- the engine's scopes -----------------------------------------------------


def _scene():
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)

    imgs = generate_scene(2, SyntheticConfig(size=SIZE, n_views=3))[0]
    return [f"v{i}" for i in range(3)], imgs


def _write_pngs(tmp, names, imgs):
    from detectorfreesfm_tpu_torch.data.png import write_png

    paths = {}
    for n, im in zip(names, imgs):
        paths[n] = os.path.join(tmp, n + ".png")
        write_png(paths[n], np.round(im * 255).astype(np.uint8))
    return paths


def _port_engine(profiler):
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_matcher_params

    cfg = EngineConfig(img_resize=SIZE, batch_size=2)
    return PairMatchingEngine(cfg, load_matcher_params(WEIGHTS), device="cpu",
                              profiler=profiler)


def _jax_engine(profiler):
    import jax.numpy as jnp
    from flax import serialization

    from detectorfreesfm_tpu.match.engine import EngineConfig
    from detectorfreesfm_tpu.match.engine import PairMatchingEngine
    from detectorfreesfm_tpu.parallel.mesh import make_mesh

    with open(WEIGHTS, "rb") as f:
        raw = serialization.msgpack_restore(f.read())["params"]
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                    raw)
    return PairMatchingEngine(EngineConfig(img_resize=SIZE, batch_size=2),
                              params=params,
                              mesh=make_mesh(1, devices=jax.devices()[:1]),
                              profiler=profiler)


def _drive(engine, pairs, paths):
    """match_scene (all three scopes), then match_pairs once more."""
    out = engine.match_scene(pairs, paths)
    engine.match_pairs(pairs[:1], engine.load_images(
        {n: paths[n] for n in pairs[0]}))
    return out


def test_engine_scopes_equal_jax_engine(tmp_path):
    """The engine with a SimpleProfiler records JAX's scope names and
    counts on the same pairs: match_forward once per match_pairs call,
    load_images once per load_images call, keypoint_merge once per
    match_scene."""
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs

    names, imgs = _scene()
    paths = _write_pngs(str(tmp_path), names, imgs)
    pairs = exhaustive_pairs(names)
    tp, jp = TPR.SimpleProfiler(), JPR.SimpleProfiler()
    kp, _s, _mi, raw = _drive(_port_engine(tp), pairs, paths)
    _drive(_jax_engine(jp), pairs, paths)
    assert dict(tp.counts) == dict(jp.counts) == {
        "engine/load_images": 2, "engine/match_forward": 2,
        "engine/keypoint_merge": 1}
    assert set(raw) == set(pairs) and set(kp) == set(names)
    assert all(t >= 0 for t in tp.totals.values())
    assert all(n in tp.summary() for n in ENGINE_SCOPES)


# --- the recorder: spans and counters while a profiler runs ----------------

ENGINE_STEPS = ("engine/stage", "engine/launch", "engine/wait",
                "engine/unpack")
MATCHER_SPANS = ("matcher/backbone", "matcher/coarse_transformer",
                 "matcher/dual_softmax")


def _frames():
    from detectorfreesfm_tpu_torch.data.images import from_array

    names, imgs = _scene()
    return names, {n: from_array(im) for n, im in zip(names, imgs)}


def _refiner_forward(seed=0):
    """A 4-view, 6-track forward of a small refiner (random weights):
    its node mask."""
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner, RefinerConfig)

    rng = np.random.default_rng(seed)
    t, v = 6, 4
    mask = torch.from_numpy(rng.uniform(size=(t, v)) > 0.4)
    mask[:, 0] = True
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MultiviewRefiner(RefinerConfig(
            crop_size=11, window=7, d_model=32, n_layers=1)).eval()
    with torch.no_grad():
        model(torch.from_numpy(rng.uniform(0, 1, (2, 48, 48, 1)).astype(
                  np.float32)),
              torch.from_numpy(rng.integers(0, 2, (t, v))),
              torch.from_numpy(rng.uniform(8, 40, (t, v, 2)).astype(
                  np.float32)),
              torch.ones(t, v), mask)
    return mask


def _session():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_spans_record_nothing_without_a_profiler(monkeypatch):
    """With no profiler running, an engine call and a refiner forward
    leave the snapshot empty and open no record_function range."""
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    names, images = _frames()
    TPR.reset()
    _port_engine(None).match_pairs([(names[0], names[1])], images)
    _refiner_forward()
    assert TPR.snapshot() == {"spans": {}, "counters": {}}
    assert opened == []
    with TPR.span("probe", device="cpu"):
        pass
    assert TPR.snapshot()["spans"] == {} and opened == []


def test_engine_spans_and_counters_in_a_session():
    """3 pairs at batch 2: two steps, each staged, launched, waited for
    and unpacked once, and one view store, staged and launched once: the
    3 views padded to 4 frames, in two per-image batches; 3 real pairs, 1
    repeat and 6 sides read from the store; the matcher's spans twice
    (the backbone once a per-image batch, the others once a step), with no
    device time off the card; the existing scope once. The engine's first
    step shape and first per-image shape count as new, a repeat does
    not."""
    from detectorfreesfm_tpu_torch.match.engine import _SHAPES_RUN

    names, images = _frames()
    engine = _port_engine(None)
    pairs = [(names[0], names[1]), (names[0], names[2]),
             (names[1], names[2])]
    _SHAPES_RUN.clear()
    with _session():
        engine.match_pairs(pairs, images)
    snap = TPR.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    calls = {"engine/stage": 3, "engine/launch": 3}
    for name in ENGINE_STEPS + MATCHER_SPANS:
        assert spans[name]["calls"] == calls.get(name, 2), name
        assert spans[name]["host_ms"] > 0 and \
            spans[name]["device_ms"] is None, name
    assert "matcher/fine" not in spans          # coarse_only
    assert spans["engine/match_forward"]["calls"] == 1
    assert counters == {"engine/pairs": 3, "engine/pad_pairs": 1,
                        "engine/new_shapes": 2, "engine/views": 4,
                        "engine/view_uses": 6}
    launch = spans["engine/launch"]["host_ms"]
    assert sum(spans[n]["host_ms"] for n in MATCHER_SPANS) <= launch


def test_refiner_counts_its_slots():
    """A refiner forward counts T x V slots and node_mask.sum() live ones,
    one chunk, and spans its S2DNet and its transformer once."""
    with _session():
        mask = _refiner_forward(seed=3)
    snap = TPR.snapshot()
    assert snap["counters"] == {"refiner/chunks": 1, "refiner/slots": 24,
                                "refiner/live_slots": int(mask.sum())}
    assert 0 < int(mask.sum()) < 24
    assert {n: s["calls"] for n, s in snap["spans"].items()} == {
        "refiner/s2dnet": 1, "refiner/transformer": 1}


ASPAN_SPANS = ("matcher/self_attention", "matcher/flow_head",
               "matcher/span_attention")


def test_aspan_spans_and_counters_only_in_a_session():
    """A 64 px ASpan pair (random weights, an 8 x 8 grid): under a
    profiler each of the 4 rounds spans its self layers, flow heads and
    window cross-attentions once, the backbone and the dual-softmax are
    spanned once, and the counters hold 2 directions x 4 rounds x 64
    queries, of which those whose 5 x 5 window crosses the grid's edge
    are clamped (most, on so small a grid; cells 2 from every edge
    cannot be unless their flow moves them), none of them through the
    card's window kernel, and as many flow-head queries, none of them
    through the card's flow kernel. With no profiler
    the same forward records nothing."""
    from detectorfreesfm_tpu_torch.models import build_matcher

    torch.manual_seed(0)
    model = build_matcher("aspan").eval()
    x0, x1 = (torch.from_numpy(im)[None, ..., None]
              for im in _scene()[1][:2])
    TPR.reset()
    with torch.no_grad():
        model(x0, x1)
    assert TPR.snapshot() == {"spans": {}, "counters": {}}
    with _session(), torch.no_grad():
        model(x0, x1)
    snap = TPR.snapshot()
    assert {n: s["calls"] for n, s in snap["spans"].items()} == dict(
        {n: 4 for n in ASPAN_SPANS}, **{"matcher/backbone": 1,
                                        "matcher/dual_softmax": 1})
    assert all(s["device_ms"] is None for s in snap["spans"].values())
    counters = snap["counters"]
    assert set(counters) == {"aspan/window_queries", "aspan/window_clamped",
                             "aspan/span_fused", "aspan/flow_queries",
                             "aspan/flow_fused"}
    assert counters["aspan/window_queries"] == 2 * 4 * 64
    assert counters["aspan/span_fused"] == 0
    assert counters["aspan/flow_queries"] == 2 * 4 * 64
    assert counters["aspan/flow_fused"] == 0
    assert 0 < counters["aspan/window_clamped"] < 2 * 4 * 64


def test_matchformer_spans_and_counter_only_in_a_session():
    """A 64 px MatchFormer pair (random weights): under a profiler the
    encoder and the dual-softmax are spanned once and the attention core
    once a layer, 2 x (1 + 2 + 2) = 10; the counters hold the queries of
    every layer (2B x N), none through the kernel (the CPU runs the plain
    chain), and the fp32 logits the chain wrote, 2B x 8 heads x N x M x 4
    bytes: stage grids of 32, 16 and 8 cells a side, each pooled to 4 x 4
    keys. With no profiler the same forward records nothing."""
    from detectorfreesfm_tpu_torch.models import build_matcher

    torch.manual_seed(0)
    model = build_matcher("matchformer").eval()
    x0, x1 = (torch.from_numpy(im)[None, ..., None]
              for im in _scene()[1][:2])
    TPR.reset()
    with torch.no_grad():
        model(x0, x1)
    assert TPR.snapshot() == {"spans": {}, "counters": {}}
    with _session(), torch.no_grad():
        model(x0, x1)
    snap = TPR.snapshot()
    assert {n: s["calls"] for n, s in snap["spans"].items()} == {
        "matcher/encoder": 1, "matcher/sr_attention": 10,
        "matcher/dual_softmax": 1}
    assert all(s["device_ms"] is None for s in snap["spans"].values())
    layers = {32 * 32: 2, 16 * 16: 4, 8 * 8: 4}
    assert snap["counters"] == {
        "matchformer/logit_bytes": sum(
            2 * 8 * n * 16 * 4 * k for n, k in layers.items()),
        "matchformer/sr_queries": sum(2 * n * k for n, k in layers.items()),
        "matchformer/sr_fused": 0}


def test_a_session_holds_only_its_own_spans():
    """Engine calls in two profiler sessions, and between them: the second
    session's snapshot holds its own call alone."""
    names, images = _frames()
    engine = _port_engine(None)
    two = [(names[0], names[1]), (names[0], names[2])]
    with _session():
        engine.match_pairs(two, images)
    assert TPR.snapshot()["counters"]["engine/pairs"] == 2
    engine.match_pairs(two, images)
    with _session():
        engine.match_pairs(two[:1], images)
    snap = TPR.snapshot()
    assert snap["counters"] == {"engine/pairs": 1, "engine/pad_pairs": 1,
                                "engine/new_shapes": 0, "engine/views": 2,
                                "engine/view_uses": 2}
    assert {n: snap["spans"][n]["calls"] for n in ENGINE_STEPS} == {
        "engine/stage": 2, "engine/launch": 2, "engine/wait": 1,
        "engine/unpack": 1}


# --- trace_to: the engine and the refinement in one trace -------------------


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    """One trace_to of the port's engine (match_scene on 3 views) and one
    refinement iteration of a small model (the port's mapper on
    tests/test_mapper.py's 5-view scene, r4 refiner at window 7) on the
    CPU: the trace file's events and the refinement's report."""
    from test_mapper import _multi_view_scene, _scene_to_matches

    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.refine.loop import (RefineConfig,
                                                       refine_reconstruction)
    from detectorfreesfm_tpu_torch.sfm.mapper import (IncrementalMapper,
                                                      MapperConfig)
    from detectorfreesfm_tpu_torch.utils.checkpoint import load_refiner_params

    tmp = str(tmp_path_factory.mktemp("trace"))
    names, imgs = _scene()
    paths = _write_pngs(tmp, names, imgs)
    engine = _port_engine(None)
    _pts, K, _poses, uvs, visible = _multi_view_scene(5, n_pts=200, seed=21)
    keypoints, matches = _scene_to_matches(5, uvs, visible)
    mapper = IncrementalMapper(MapperConfig(abs_pose_min_num_inliers=15),
                               device="cpu")
    rec = mapper.run(keypoints, matches, {n: (640, 480) for n in keypoints},
                     {n: K for n in keypoints})
    rng = np.random.default_rng(5)
    big = np.kron(rng.uniform(0, 1, (60, 80)).astype(np.float32),
                  np.ones((8, 8), np.float32))
    images = {i: np.roll(big, 3 * i, axis=1) for i in rec.images}
    info = {}
    logdir = os.path.join(tmp, "logs")
    with TPR.trace_to(logdir):
        engine.match_scene(exhaustive_pairs(names), paths)
        refine_reconstruction(
            copy.deepcopy(rec), images, load_refiner_params(REFINER,
                                                            device="cpu"),
            RefineConfig(n_iters=1, windows=(7,), chunk_tracks=256,
                         max_track_length=4), mapper=mapper, device="cpu",
            info=info)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(logdir, "spans.json")) as f:
        spans = json.load(f)
    return events, info, spans


def _ranges(events):
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    return {n: names.count(n) for n in names}


def test_trace_holds_the_engine_scopes(trace):
    """trace_to writes one Chrome trace whose ranges hold the engine's
    three scopes, each once (the engine takes a PassThroughProfiler by
    default, which opens the same ranges)."""
    events, _info, _spans = trace
    ranges = _ranges(events)
    assert all(ranges.get(n) == 1 for n in ENGINE_SCOPES), ranges


def test_trace_holds_the_refinement_scopes(trace):
    """The refinement takes no profiler= argument (as in JAX) and still
    opens its three scopes, once per iteration, in that order."""
    events, info, _spans = trace
    assert info["iterations_completed"] == 1 and info["error"] is None
    ranges = _ranges(events)
    assert all(ranges.get(n) == 1 for n in REFINE_SCOPES), ranges
    start = {e["name"]: e["ts"] for e in events
             if e.get("name") in REFINE_SCOPES}
    assert sorted(REFINE_SCOPES, key=start.get) == list(REFINE_SCOPES)


def test_trace_to_writes_the_spans_beside_the_trace(trace):
    """spans.json, beside the Chrome trace, holds the block's snapshot:
    the engine's steps and the refinement's, each as often as its range
    is in the trace, and the engine's counters (3 pairs of 3 views)."""
    events, _info, snap = trace
    ranges = _ranges(events)
    steps = ENGINE_STEPS + ("refine/stage", "refine/launch", "refine/wait",
                            "refine/writeback")
    for name in steps + ENGINE_SCOPES + REFINE_SCOPES:
        assert snap["spans"][name]["calls"] == ranges[name] >= 1, name
    assert snap["counters"]["engine/pairs"] == 3
    assert snap["counters"]["refiner/chunks"] == \
        snap["spans"]["refine/launch"]["calls"]


def test_reconstruct_trace_dir_runs_the_verb_in_trace_to(tmp_path,
                                                         monkeypatch):
    """`cli reconstruct --trace-dir DIR` runs the verb under a profiler and
    leaves the Chrome trace and spans.json, with the verb's spans, in
    DIR."""
    from detectorfreesfm_tpu_torch import cli

    seen = []

    def verb(args):
        seen.append(torch.autograd.profiler._is_profiler_enabled)
        with TPR.span("verb/probe"):
            pass
        return {"status": "ok"}

    monkeypatch.setattr(cli, "_run_scene", verb)
    logdir = tmp_path / "trace"
    assert cli.main(["reconstruct", "--images", str(tmp_path), "--output",
                     str(tmp_path / "out"), "--device", "cpu",
                     "--trace-dir", str(logdir)]) == 0
    assert seen == [True]
    assert len(glob.glob(str(logdir / "*.pt.trace.json"))) == 1
    with open(logdir / "spans.json") as f:
        assert json.load(f)["spans"]["verb/probe"]["calls"] == 1


# --- the remaining names ----------------------------------------------------


def test_plot_matches_writes_jax_s_figure(tmp_path):
    """The same PNG size as JAX's on the same inputs."""
    from PIL import Image

    from detectorfreesfm_tpu.utils.vis import plot_matches as jax_plot
    from detectorfreesfm_tpu_torch.utils.vis import plot_matches

    rng = np.random.default_rng(0)
    im0, im1 = rng.random((48, 64)), rng.random((40, 56))
    k0 = rng.uniform(0, 40, (30, 2))
    k1 = rng.uniform(0, 40, (30, 2))
    conf = rng.random(30)
    plot_matches(im0, im1, k0, k1, conf, path=str(tmp_path / "port.png"))
    jax_plot(im0, im1, k0, k1, conf, path=str(tmp_path / "jax.png"))
    with Image.open(tmp_path / "port.png") as a, \
            Image.open(tmp_path / "jax.png") as b:
        assert a.size == b.size and a.size[0] > 0


def test_plot_matches_names_matplotlib_when_missing(monkeypatch):
    from detectorfreesfm_tpu_torch.utils.vis import plot_matches

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_matches(np.zeros((8, 8)), np.zeros((8, 8)), np.zeros((0, 2)),
                     np.zeros((0, 2)))


def test_package_re_exports(monkeypatch):
    """reconstruct_scene and build_matcher at the package level, lazy."""
    from detectorfreesfm_tpu_torch import models, pipeline

    seen = {}
    monkeypatch.setattr(pipeline, "reconstruct_scene",
                        lambda *a, **k: seen.update(a=a, k=k) or "rec")
    assert detectorfreesfm_tpu_torch.reconstruct_scene(
        "images", "out", device="cpu") == "rec"
    assert seen == {"a": ("images", "out"), "k": {"device": "cpu"}}
    m = detectorfreesfm_tpu_torch.build_matcher("matchformer")
    assert type(m) is type(models.build_matcher("matchformer"))


def test_selfsup_loaders_delegate_to_checkpoint():
    """load_matcher_params and load_refiner_params at JAX's module paths
    and signatures give utils/checkpoint.py's state_dicts."""
    from detectorfreesfm_tpu_torch.train.refiner_selfsup import (
        load_refiner_params,
    )
    from detectorfreesfm_tpu_torch.train.selfsup import load_matcher_params
    from detectorfreesfm_tpu_torch.utils import checkpoint

    got = load_matcher_params(WEIGHTS, 416)
    ref = checkpoint.load_matcher_params(WEIGHTS)
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    got = load_refiner_params(REFINER, None, 64, 4, 8, device="cpu")
    ref = checkpoint.load_refiner_params(REFINER, device="cpu")
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)


# JAX names that have no counterpart in the port, each with its reason.
ALLOWED_MISSING = {
    # The Pallas kernels: ported as ops/fused_dsm.py (dsm_pass1, dsm_pass2)
    # over csrc/dual_softmax.cu.
    "detectorfreesfm_tpu.ops.pallas_dsm": "*",
    # jit and device-placement helpers of XLA; the port's geometry runs
    # eagerly on the device it is given.
    "detectorfreesfm_tpu.core.precision": {
        "geometry_jit", "keep_geometry_on_default_device",
        "prefer_accelerator_geometry", "with_highest_matmul_precision"},
    # pytrees of JAX's functional state: the port keeps BA's state and the
    # trainer's parameters and optimizer in torch objects.
    "detectorfreesfm_tpu.sfm.ba": {"BAState"},
    "detectorfreesfm_tpu.train.matcher_trainer": {"MatcherTrainState"},
    # Whether JAX's optional imports succeeded: the port imports neither
    # h5py nor PIL.
    "detectorfreesfm_tpu.data.h5io": {"HAS_H5PY"},
    "detectorfreesfm_tpu.data.images": {"HAS_PIL"},
    # cProfile per scope: no verb, smoke or benchmark read it; the port's
    # spans (utils/profiler.py) give each scope's host time in a trace.
    "detectorfreesfm_tpu.utils.profiler": {"AdvancedProfiler"},
}


def _public_names(module):
    """Functions and classes defined in the module, and its upper-case
    constants; no imported names."""
    out = set()
    for k, v in vars(module).items():
        if k.startswith("_") or inspect.ismodule(v):
            continue
        if inspect.isfunction(v) or inspect.isclass(v):
            if v.__module__ == module.__name__:
                out.add(k)
        elif k.isupper():
            out.add(k)
    return out


def test_every_jax_name_has_a_counterpart():
    """Every public module-level name of the JAX package is in the port's
    module of the same path, but for ALLOWED_MISSING."""
    missing = {}
    for info in pkgutil.walk_packages(detectorfreesfm_tpu.__path__,
                                      "detectorfreesfm_tpu."):
        allowed = ALLOWED_MISSING.get(info.name, set())
        if allowed == "*":
            continue
        jm = importlib.import_module(info.name)
        port_name = info.name.replace("detectorfreesfm_tpu",
                                      "detectorfreesfm_tpu_torch", 1)
        try:
            pm = importlib.import_module(port_name)
        except ModuleNotFoundError:
            missing[info.name] = ["<module>"]
            continue
        gone = sorted(n for n in _public_names(jm) - allowed
                      if not hasattr(pm, n))
        if gone:
            missing[info.name] = gone
    for name in ("reconstruct_scene", "build_matcher"):
        if not hasattr(detectorfreesfm_tpu_torch, name):
            missing.setdefault("detectorfreesfm_tpu", []).append(name)
    assert not missing, missing
    # The allowlist names only what is missing.
    for mod, names in ALLOWED_MISSING.items():
        if names == "*":
            port = mod.replace("detectorfreesfm_tpu",
                               "detectorfreesfm_tpu_torch", 1)
            assert importlib.util.find_spec(port) is None, mod
        else:
            pm = importlib.import_module(mod.replace(
                "detectorfreesfm_tpu", "detectorfreesfm_tpu_torch", 1))
            assert not any(hasattr(pm, n) for n in names), mod
