"""Keypoint grid-cell merging (integer-pixel NMS over match endpoints).

A copy of the JAX package's ops/grid_merge.py (numpy only).

Host-side glue between matching and SfM, with the same semantics as the
reference's agg_groupby_2d / keypoint_worker (src/coarse_match/utils/
merge_kpts.py:4-59, coarse_match_worker.py:151-245): every match endpoint is
quantized to its integer pixel cell, a cell's score is the sum of the
confidences of all endpoints that land in it, cells are ranked by score, and
each endpoint is remapped to its cell's keypoint index.

Implemented as vectorized numpy (unique + bincount), deterministic: ties in
score break by cell coordinate, not insertion order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def merge_to_grid_cells(
    coords: np.ndarray, confs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group endpoints by rounded pixel and rank cells by aggregate score.

    Args:
      coords: (M, 2) float endpoint coordinates (original image pixels).
      confs:  (M,) confidences.

    Returns:
      kpts:   (K, 2) float32 keypoint coordinates (cell centers), ranked by
              descending score (ties broken by (x, y) ascending).
      scores: (K,) float32 aggregate score per keypoint.
      endpoint_to_kpt: (M,) int32 keypoint index for every input endpoint.
    """
    if len(coords) == 0:
        return (
            np.zeros((0, 2), np.float32),
            np.zeros((0,), np.float32),
            np.zeros((0,), np.int32),
        )
    cells = np.round(coords).astype(np.int64)
    # Collision-free composite key (image dims far below 2^24)
    key = (cells[:, 0] + 1 << 24) + cells[:, 1] + 1
    uniq, inv = np.unique(key, return_inverse=True)
    scores = np.bincount(inv, weights=confs.astype(np.float64), minlength=len(uniq))
    xs = (uniq >> 24) - 1
    ys = (uniq & ((1 << 24) - 1)) - 1
    # Rank by score desc; np.unique sorted uniq ascending gives deterministic ties
    order = np.argsort(-scores, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    kpts = np.stack([xs[order], ys[order]], axis=-1).astype(np.float32)
    return kpts, scores[order].astype(np.float32), rank[inv].astype(np.int32)


def merge_matches_to_keypoints(
    pair_matches: Dict[Tuple[str, str], dict],
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[Tuple[str, str], np.ndarray]]:
    """Scene-level keypoint merge.

    Args:
      pair_matches: {(name0, name1): {"kpts0": (M,2), "kpts1": (M,2),
                                      "conf": (M,)}} per-pair match arrays in
                    original pixel coordinates (variable M, invalid rows
                    already dropped).

    Returns:
      keypoints: {name: (K, 2) float32} ranked keypoint coordinates.
      scores:    {name: (K,) float32}.
      match_indices: {(name0, name1): (M, 2) int32} matches as keypoint-index
                     pairs into the two images' keypoint arrays.
    """
    per_image: Dict[str, List[np.ndarray]] = {}
    per_image_conf: Dict[str, List[np.ndarray]] = {}
    spans: Dict[Tuple[str, str], tuple] = {}
    for (n0, n1), m in pair_matches.items():
        for name, kp in ((n0, m["kpts0"]), (n1, m["kpts1"])):
            per_image.setdefault(name, [])
            per_image_conf.setdefault(name, [])
        start0 = sum(len(a) for a in per_image[n0])
        per_image[n0].append(np.asarray(m["kpts0"], np.float64))
        per_image_conf[n0].append(np.asarray(m["conf"], np.float64))
        start1 = sum(len(a) for a in per_image[n1])
        per_image[n1].append(np.asarray(m["kpts1"], np.float64))
        per_image_conf[n1].append(np.asarray(m["conf"], np.float64))
        spans[(n0, n1)] = (start0, start1, len(m["conf"]))

    keypoints: Dict[str, np.ndarray] = {}
    scores: Dict[str, np.ndarray] = {}
    endpoint_maps: Dict[str, np.ndarray] = {}
    for name in sorted(per_image):
        coords = np.concatenate(per_image[name]) if per_image[name] else np.zeros((0, 2))
        confs = np.concatenate(per_image_conf[name]) if per_image_conf[name] else np.zeros((0,))
        kpts, sc, e2k = merge_to_grid_cells(coords, confs)
        keypoints[name] = kpts
        scores[name] = sc
        endpoint_maps[name] = e2k

    match_indices: Dict[Tuple[str, str], np.ndarray] = {}
    for (n0, n1), (s0, s1, m) in spans.items():
        i0 = endpoint_maps[n0][s0 : s0 + m]
        i1 = endpoint_maps[n1][s1 : s1 + m]
        idx = np.stack([i0, i1], axis=-1).astype(np.int32)
        # Grid quantization can alias two matches to the same cell pair; keep
        # unique pairs (deterministic order by index).
        if len(idx):
            idx = np.unique(idx, axis=0)
        match_indices[(n0, n1)] = idx
    return keypoints, scores, match_indices
