"""The engine's view-reuse share (metrics/engine_view_reuse_pct.py) from
the program's `engine/views` and `engine/view_uses` counters: nothing
without them, and in a traced run of the scene cell at its tiny size on
the CPU, the share of pair sides that its calls read from the store
without computing them."""

import types

import pytest
from torch.profiler import ProfilerActivity, profile

from detectorfreesfm_tpu_torch.utils import profiler
from portbench import harness
from portbench.tests.test_portbench_spans import _traced


def _read(**counters):
    """The metric over a profiler session that counted `counters`."""
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for name, value in counters.items():
            profiler.count(name, value)
    return harness.load_metrics()["engine_view_reuse_pct"].read(
        types.SimpleNamespace(trace=None, counters={}, hook_ms={}))


def test_reads_nothing_without_the_counters():
    assert _read() is None
    assert _read(**{"engine/pairs": 64}) is None
    assert _read(**{"engine/views": 16}) is None


def test_reads_the_share_of_sides_read_from_the_store():
    assert _read(**{"engine/views": 16,
                    "engine/view_uses": 128}) == pytest.approx(87.5)
    assert _read(**{"engine/views": 32,
                    "engine/view_uses": 32}) == pytest.approx(0.0)


def test_scene_cell_reports_the_reuse():
    """3 views, calls of their 3 pairs at batch 2: 4 frames (one a
    repeat) for 6 sides a call."""
    result, _info = _traced("loftr_ds_r5.scene16_832")
    metric = result["metrics"]["engine_view_reuse_pct"]
    assert metric == {"value": pytest.approx(100.0 * (1 - 4 / 6)),
                      "unit": "%"}
