"""Profiling: named phase scopes, in-program spans and counters, and
torch.profiler traces.

Port of the JAX package's utils/profiler.py, with torch.profiler in place
of XProf. The engine (match/engine.py: `engine/load_images`,
`engine/match_forward`, `engine/keypoint_merge`) and the refinement
(refine/loop.py: `refine/pack_tracks`, `refine/multiview_match`,
`refine/geometry_refinement`) open the same scopes as the JAX package's.

Beside them, the program records spans and counters where the work
happens (the engine's staging, launch, wait and unpack; the matcher's and
the refiner's layers; the refinement loop's steps) through the
module-level `span` and `count`. They record only while a torch profiler
runs: with none running, a span reads one flag and does nothing else, so
untraced runs pay nothing. While one runs, a span opens a
`torch.profiler.record_function` range of its name (it sits in the Chrome
trace beside the card's kernels), adds its host time to its total and, if
given a CUDA device, records a pair of CUDA events on that device's
current stream. Nothing synchronises until `snapshot()` resolves the
events and reads counters held on the card. The totals restart when a
profiler session starts, so a snapshot taken after a session holds that
session alone. The scopes of the profilers below open spans too, so they
land in the same totals.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


class _SpanTotal:
    __slots__ = ("calls", "host_ns", "device_ms", "events")

    def __init__(self):
        self.calls = 0
        self.host_ns = 0
        self.device_ms = None   # None until a CUDA span has been resolved
        self.events = []        # unresolved (start, end) CUDA event pairs

    def resolve(self) -> Optional[float]:
        if self.events:
            for _, end in self.events:
                end.synchronize()
            ms = sum(a.elapsed_time(b) for a, b in self.events)
            self.device_ms = (self.device_ms or 0.0) + ms
            self.events = []
        return self.device_ms


class _Span:
    __slots__ = ("recorder", "name", "stream", "range", "start", "t0")

    def __init__(self, recorder, name, stream):
        self.recorder, self.name, self.stream = recorder, name, stream

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        total = self.recorder.spans[self.name]
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            total.events.append((self.start, end))
        self.range.__exit__(*exc)
        total.calls += 1
        total.host_ns += host_ns
        return False


class SpanRecorder:
    """Span totals and counters of the current profiler session."""

    def __init__(self):
        self.spans: Dict[str, _SpanTotal] = defaultdict(_SpanTotal)
        self.counters: Dict[str, list] = {}   # the values added
        self.live = False   # whether the last check found a profiler

    def recording(self) -> bool:
        """Whether a torch profiler runs. The first check that finds one,
        after one that found none (a span, a count or a snapshot), starts
        the totals afresh."""
        on = _autograd_profiler._is_profiler_enabled
        if on is not self.live:
            if on:
                self.reset()
            self.live = on
        return on

    def reset(self) -> None:
        self.spans.clear()
        self.counters.clear()

    def span(self, name: str, device=None):
        """Context manager: the block's host time under `name` and, where
        `device` is a CUDA device, its device time on that device's
        current stream; a no-op unless a profiler runs."""
        if not self.recording():
            return _OFF
        stream = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
        return _Span(self, name, stream)

    def count(self, name: str, value) -> None:
        """Add `value` (a number, a tensor, which stays on its device until
        `snapshot()`, or a callable giving either, called only while a
        profiler runs) to the counter `name`."""
        if not self.recording():
            return
        if callable(value):
            value = value()
        self.counters.setdefault(name, []).append(value)

    def snapshot(self) -> dict:
        """{"spans": {name: {"calls", "host_ms", "device_ms"}},
        "counters": {name: value}}; `device_ms` is None where no CUDA
        events were recorded. Waits for the recorded events. Read after a
        session, it ends the session's totals: the next span or count
        under a profiler starts them afresh."""
        self.recording()
        for name, values in self.counters.items():
            self.counters[name] = [sum(
                v.item() if isinstance(v, torch.Tensor) else v
                for v in values)]
        return {"spans": {name: {"calls": s.calls,
                                 "host_ms": s.host_ns * 1e-6,
                                 "device_ms": s.resolve()}
                          for name, s in self.spans.items()},
                "counters": {name: values[0]
                             for name, values in self.counters.items()}}


RECORDER = SpanRecorder()
span = RECORDER.span
count = RECORDER.count
snapshot = RECORDER.snapshot
reset = RECORDER.reset


class PassThroughProfiler:
    """No-op profiler (the default): only the span."""

    def record_function(self, name: str):
        return span(name)

    def summary(self) -> str:
        return ""


class SimpleProfiler(PassThroughProfiler):
    """Accumulates wall-clock per named action. Note: CUDA launches are
    asynchronous, and a scope does not synchronise (that would stall the
    engine's 1-deep pipeline): a scope's time is the host's, up to the last
    point inside it that waits for the card. Use trace_to() for device
    time."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def record_function(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        lines = ["action              | total s  | calls | mean ms"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<20}| {t:8.3f} | {c:5d} | {t / c * 1e3:7.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a torch.profiler trace of the host and, when a card is
    present, its kernels; written as a Chrome-trace JSON file
    (`*.pt.trace.json`) into `logdir` when the block ends (open it in
    chrome://tracing, Perfetto or TensorBoard), with `spans.json` beside
    it: the `snapshot()` of the block's spans and counters."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)):
            reset()
            yield
    finally:
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump(snapshot(), f, indent=1, sort_keys=True)


def get_profiler(kind: Optional[str]):
    if kind in (None, "", "pass", "passthrough"):
        return PassThroughProfiler()
    if kind == "simple":
        return SimpleProfiler()
    raise ValueError(kind)
