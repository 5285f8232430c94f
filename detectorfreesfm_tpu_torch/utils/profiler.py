"""Profiling: named phase scopes + wall-clock / torch.profiler traces.

Port of the JAX package's utils/profiler.py, with torch.profiler in place
of XProf: every phase is wrapped in a `torch.profiler.record_function`
range (where JAX opens a `jax.profiler.TraceAnnotation`), so phases show
up in the Chrome traces that `trace_to(...)` writes, beside the card's
kernels. The engine (match/engine.py: `engine/load_images`,
`engine/match_forward`, `engine/keypoint_merge`) and the refinement
(refine/loop.py: `refine/pack_tracks`, `refine/multiview_match`,
`refine/geometry_refinement`) open the same scopes as the JAX package's.
"""

from __future__ import annotations

import cProfile
import contextlib
import io
import pstats
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PassThroughProfiler:
    """No-op profiler (the default): only the trace range."""

    @contextlib.contextmanager
    def record_function(self, name: str):
        with torch.profiler.record_function(name):
            yield

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
        with torch.profiler.record_function(name):
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        lines = ["action              | total s  | calls | mean ms"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<20}| {t:8.3f} | {c:5d} | {t / c * 1e3:7.2f}")
        return "\n".join(lines)


class AdvancedProfiler(PassThroughProfiler):
    """cProfile per action (host-side Python cost)."""

    def __init__(self):
        self.profilers: Dict[str, cProfile.Profile] = {}

    @contextlib.contextmanager
    def record_function(self, name: str):
        prof = self.profilers.setdefault(name, cProfile.Profile())
        prof.enable()
        try:
            yield
        finally:
            prof.disable()

    def summary(self) -> str:
        out = io.StringIO()
        for name, prof in self.profilers.items():
            out.write(f"==== {name} ====\n")
            pstats.Stats(prof, stream=out).sort_stats(
                "cumulative").print_stats(12)
        return out.getvalue()


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a torch.profiler trace of the host and, when a card is
    present, its kernels; written as a Chrome-trace JSON file
    (`*.pt.trace.json`) into `logdir` when the block ends (open it in
    chrome://tracing, Perfetto or TensorBoard)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def get_profiler(kind: Optional[str]):
    if kind in (None, "", "pass", "passthrough"):
        return PassThroughProfiler()
    if kind == "simple":
        return SimpleProfiler()
    if kind == "advanced":
        return AdvancedProfiler()
    raise ValueError(kind)
