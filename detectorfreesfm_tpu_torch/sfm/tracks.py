"""Feature-track graph: union-find over match endpoints.

Port of the JAX package's sfm/tracks.py. Endpoints are (image, keypoint)
nodes, verified matches are edges, connected components become candidate
tracks. Components holding two different keypoints of the same image are
inconsistent and lose that image's observations (COLMAP discards
conflicting correspondences).

The union-find runs in C++ (csrc/trackbuilder.cpp, the port's copy of
native/trackbuilder.cpp), built with g++ at first use into the gitignored
build/native/ at the repo root (never into native/), or in Python with
identical semantics. `last_builder` names the one the last call ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "trackbuilder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_native_lib: Optional[ctypes.CDLL] = None
_native_error: Optional[str] = None
last_builder: Optional[str] = None


def library_path() -> Path:
    """build/native/libtrackbuilder_<hash of source and flags>.so"""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtrackbuilder_{h.hexdigest()[:16]}.so"


def _load_native() -> Optional[ctypes.CDLL]:
    """Build (once, temp file + atomic rename) and load the C++ union-find;
    None if g++ or the load fails (the reason stays in _native_error)."""
    global _native_lib, _native_error
    with _lock:
        if _native_lib is not None or _native_error is not None:
            return _native_lib
        so = library_path()
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True, timeout=120)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed: {proc.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.uf_build.argtypes = [
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]
            lib.uf_build.restype = None
            _native_lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _native_error = f"{type(e).__name__}: {e}"
        return _native_lib


class Track:
    """A candidate 3D point: list of (image_id, kpt_idx) observations."""

    __slots__ = ("observations",)

    def __init__(self, observations: List[Tuple[int, int]]):
        self.observations = observations

    def __len__(self):
        return len(self.observations)

    def __repr__(self):
        return f"Track({self.observations})"


def _find(parent: np.ndarray, i: int) -> int:
    root = i
    while parent[root] != root:
        root = parent[root]
    while parent[i] != root:  # path compression
        parent[i], i = root, parent[i]
    return root


def build_tracks(
    n_kpts: Dict[int, int],
    match_indices: Dict[Tuple[int, int], np.ndarray],
    min_track_length: int = 2,
    max_track_length: int | None = None,
    builder: str = "auto",
) -> List[Track]:
    """Build tracks from per-pair keypoint-index matches.

    Args:
      n_kpts: {image_id: number of keypoints}.
      match_indices: {(img_a, img_b): (M, 2) int32 keypoint index pairs}.
      min_track_length: drop components observed in fewer images.
      max_track_length: optionally truncate tracks (keep deterministic prefix
        sorted by image id) — mirrors the reference's max_track_length=16 cap
        (src/post_optimization/post_optimization.py:25).
      builder: "native" (the C++ union-find; raises if it cannot be built),
        "python", or "auto" (native when it builds, else Python).

    Returns list of Tracks ordered deterministically (by smallest node id).
    """
    images = sorted(n_kpts)
    offset: Dict[int, int] = {}
    total = 0
    for im in images:
        offset[im] = total
        total += n_kpts[im]

    edges_a: List[np.ndarray] = []
    edges_b: List[np.ndarray] = []
    for (a, b) in sorted(match_indices):
        m = match_indices[(a, b)]
        if len(m) == 0:
            continue
        edges_a.append(offset[a] + m[:, 0].astype(np.int64))
        edges_b.append(offset[b] + m[:, 1].astype(np.int64))
    ea = np.concatenate(edges_a) if edges_a else np.zeros(0, np.int64)
    eb = np.concatenate(edges_b) if edges_b else np.zeros(0, np.int64)

    global last_builder
    if builder not in ("auto", "native", "python"):
        raise ValueError(f"unknown builder {builder!r}")
    lib = None if builder == "python" else _load_native()
    if builder == "native" and lib is None:
        raise RuntimeError(f"native track builder unavailable: {_native_error}")
    last_builder = "python" if lib is None else "native"
    if lib is not None:
        roots = np.empty(total, dtype=np.int64)
        ea_c = np.ascontiguousarray(ea)
        eb_c = np.ascontiguousarray(eb)
        lib.uf_build(
            total,
            ea_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            eb_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ea_c),
            roots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    else:  # pure Python, identical semantics
        parent = np.arange(total, dtype=np.int64)
        for x, y in zip(ea, eb):
            rx, ry = _find(parent, x), _find(parent, y)
            if rx != ry:
                r = min(rx, ry)  # smallest-id root keeps ordering stable
                parent[rx] = r
                parent[ry] = r
        roots = np.empty(total, dtype=np.int64)
        for i in range(total):
            roots[i] = _find(parent, i)

    # Node -> (image, kpt)
    img_of = np.empty(total, dtype=np.int64)
    kpt_of = np.empty(total, dtype=np.int64)
    for im in images:
        o, k = offset[im], n_kpts[im]
        img_of[o : o + k] = im
        kpt_of[o : o + k] = np.arange(k)

    order = np.argsort(roots, kind="stable")
    roots_sorted = roots[order]
    boundaries = np.flatnonzero(np.diff(roots_sorted)) + 1
    groups = np.split(order, boundaries)

    tracks: List[Track] = []
    for g in groups:
        if len(g) < min_track_length:
            continue
        obs = [(int(img_of[i]), int(kpt_of[i])) for i in g]
        # Drop images observed more than once in this component (conflict)
        counts: Dict[int, int] = {}
        for im, _ in obs:
            counts[im] = counts.get(im, 0) + 1
        obs = [(im, kp) for im, kp in obs if counts[im] == 1]
        if len(obs) < min_track_length:
            continue
        obs.sort()
        if max_track_length is not None and len(obs) > max_track_length:
            obs = obs[:max_track_length]
        tracks.append(Track(obs))
    return tracks
