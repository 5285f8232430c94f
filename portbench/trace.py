"""Reading a torch.profiler Chrome trace: the device's busy and idle time
over the traced stretch, device time by kernel name, and the longest idle
gaps labelled by what the host was doing.

The stretch is the span of the harness's `portbench/unit` ranges; the
device is busy where any kernel, memcpy or memset runs (their union).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

UNIT_RANGE = "portbench/unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclasses.dataclass
class TraceSummary:
    window_s: float                    # the traced stretch
    busy_s: float                      # union of device intervals in it
    kernel_s: Dict[str, float]         # device seconds by op name
    gaps: List[Tuple[str, float]]      # longest idle gaps, longest first

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]

    def seconds_of(self, *names: str) -> float:
        """Device seconds of the ops whose name holds any of `names`."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def _label(host, t):
    """The innermost host event open at time t, or `host idle`."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host idle"


def summarize(events: list, n_gaps: int = 10) -> TraceSummary:
    """events: a Chrome trace's `traceEvents` (times in microseconds)."""
    units = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == UNIT_RANGE]
    if not units:
        raise ValueError(f"trace holds no {UNIT_RANGE} range")
    lo = min(e["ts"] for e in units)
    hi = max(e["ts"] + e["dur"] for e in units)
    dev, kernel_s = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a, b = e["ts"], e["ts"] + e.get("dur", 0)
            if b > lo and a < hi:
                dev.append((a, b))
                name = e.get("name", "?")
                kernel_s[name] = kernel_s.get(name, 0.0) + \
                    (min(b, hi) - max(a, lo)) * 1e-6
    busy = merge(_clip(dev, lo, hi))
    busy_us = sum(b - a for a, b in busy)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    holes.sort(key=lambda ab: ab[0] - ab[1])
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?"))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != UNIT_RANGE]
    gaps = [(_label(host, 0.5 * (a + b)), (b - a) * 1e-6)
            for a, b in holes[:n_gaps]]
    return TraceSummary((hi - lo) * 1e-6, busy_us * 1e-6, kernel_s, gaps)


def read(path: str) -> TraceSummary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
