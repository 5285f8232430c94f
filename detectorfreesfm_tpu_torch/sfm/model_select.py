"""Reconstruction model selection + quality stats.

Parity with reference src/utils/colmap/eval_helper.py:143
(get_best_colmap_index: COLMAP can emit several disconnected sub-models;
pick the one with most registered images). Our mapper produces one model per
run, but multi-attempt flows (several init pairs / restarts) reuse this to
pick the best result, and dataset drivers use it on dirs of models.

Port: a copy of the JAX package's sfm/model_select.py.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..data import colmap_io
from .reconstruction import Reconstruction


def model_stats(rec: Reconstruction) -> Dict[str, float]:
    n_obs = rec.n_observations()
    track_lens = [len(p["track"]) for p in rec.points.values()]
    errs = [p["error"] for p in rec.points.values() if p["error"] >= 0]
    return {
        "n_registered": float(len(rec.registered_images)),
        "n_points": float(len(rec.points)),
        "n_observations": float(n_obs),
        "mean_track_length": float(np.mean(track_lens)) if track_lens else 0.0,
        "mean_reproj_error": float(np.mean(errs)) if errs else float("nan"),
    }


def best_model(recs: Sequence[Optional[Reconstruction]]) -> Optional[int]:
    """Index of the reconstruction with most registered images (ties: most
    observations). None entries (failed attempts) are skipped."""
    best_i, best_key = None, (-1, -1)
    for i, rec in enumerate(recs):
        if rec is None:
            continue
        key = (len(rec.registered_images), rec.n_observations())
        if key > best_key:
            best_i, best_key = i, key
    return best_i


def best_model_dir(parent_dir: str) -> Optional[str]:
    """Among COLMAP model subdirs ('0', '1', ...), pick the most-registered
    one (the on-disk variant of get_best_colmap_index)."""
    best_path, best_n = None, -1
    for d in sorted(os.listdir(parent_dir)):
        path = os.path.join(parent_dir, d)
        if not os.path.isdir(path):
            continue
        try:
            _, images, _ = colmap_io.read_model(path)
        except Exception:
            continue
        if len(images) > best_n:
            best_path, best_n = path, len(images)
    return best_path
