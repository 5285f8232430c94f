"""The span attention's kernel share (metrics/span_fused_pct.py) from the
program's `aspan/window_queries` and `aspan/span_fused` counters: nothing
without them (as from a program that counts no kernel queries), else the
share of window queries that the kernel computed."""

import types

import pytest
from torch.profiler import ProfilerActivity, profile

from detectorfreesfm_tpu_torch.utils import profiler
from portbench import harness


def _read(**counters):
    """The metric over a profiler session that counted `counters`."""
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for name, value in counters.items():
            profiler.count(name, value)
    return harness.load_metrics()["span_fused_pct"].read(
        types.SimpleNamespace(trace=None, counters={}, hook_ms={}))


def test_reads_nothing_without_the_counters():
    assert _read() is None
    assert _read(**{"engine/pairs": 64, "aspan/window_queries": 800,
                    "aspan/window_clamped": 4}) is None
    assert _read(**{"aspan/span_fused": 800}) is None
    assert _read(**{"aspan/flow_queries": 800,
                    "aspan/flow_fused": 800}) is None


def test_reads_the_share_of_queries_through_the_kernel():
    assert _read(**{"aspan/window_queries": 800,
                    "aspan/span_fused": 800}) == pytest.approx(100.0)
    assert _read(**{"aspan/window_queries": 800,
                    "aspan/span_fused": 0}) == pytest.approx(0.0)
