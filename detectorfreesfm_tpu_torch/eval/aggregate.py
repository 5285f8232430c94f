"""Cross-scene metric aggregation (IMC bag grouping + pretty report).

A copy of the JAX package's eval/aggregate.py (pure Python; the port
imports nothing of that package). Per-scene metric dicts are averaged
metric-by-metric; IMC-style scenes whose names carry bag markers ("3bag",
"5bag", "10bag", "25bag") additionally aggregate per bag; unequal metric
counts across scenes produce a warning, not an error.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

BAG_PATTERN = re.compile(r"(\d+)bag")


def average_metrics(per_scene: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Mean of every metric key over scenes that report it."""
    keys = sorted({k for m in per_scene.values() for k in m})
    out = {}
    counts = {}
    for k in keys:
        vals = [m[k] for m in per_scene.values() if k in m]
        out[k] = sum(vals) / len(vals) if vals else float("nan")
        counts[k] = len(vals)
    if len(set(counts.values())) > 1:
        out["_warning_unequal_counts"] = 1.0
    return out


def aggregate_multi_scene_metrics(
    per_scene: Dict[str, Dict[str, float]],
    group_bags: bool = False,
) -> Dict[str, Dict[str, float]]:
    """Returns {"all": averaged, "<N>bag": averaged-per-bag (if grouping)}."""
    result = {"all": average_metrics(per_scene)}
    if group_bags:
        bags: Dict[str, Dict[str, Dict[str, float]]] = {}
        for scene, metrics in per_scene.items():
            m = BAG_PATTERN.search(scene)
            if m:
                bags.setdefault(f"{m.group(1)}bag", {})[scene] = metrics
        for bag, scenes in sorted(bags.items(), key=lambda kv: int(kv[0][:-3])):
            result[bag] = average_metrics(scenes)
    return result


def format_report(
    aggregated: Dict[str, Dict[str, float]],
    per_scene: Optional[Dict[str, Dict[str, float]]] = None,
    title: str = "metrics",
) -> str:
    lines: List[str] = [f"==== {title} ===="]
    for group, metrics in aggregated.items():
        lines.append(f"[{group}]")
        for k, v in sorted(metrics.items()):
            if k.startswith("_"):
                lines.append(f"  (warning: {k[1:]})")
            else:
                lines.append(f"  {k}: {v:.4f}")
    if per_scene:
        lines.append("---- per scene ----")
        for scene in sorted(per_scene):
            body = ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(per_scene[scene].items())
            )
            lines.append(f"  {scene}: {body}")
    return "\n".join(lines)
