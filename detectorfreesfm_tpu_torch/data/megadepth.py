"""MegaDepth-style multiview training tuples and scene-balanced sampling.

Port of the JAX package's data/megadepth.py:

  * per-scene index files (.npz) hold image/depth paths, intrinsics,
    world-to-camera poses and precomputed image tuples (column 0 is the
    reference view);
  * scenes are sharded over processes (`shard_scenes`) and sampled
    scene-balanced with replacement, n samples per scene per epoch;
  * images resize to a square static frame (long side, /8 divisor, zero
    padding) with the intrinsics rescaled; depths resize, nearest, onto
    the same grid.

Images decode through the port's `load_gray` (PNG without PIL). Depths are
read from `.npy` (an array) or `.npz` (key "depth"), as in JAX; any other
file raises, naming the reader it would need. JAX's loader instead returns
a 2x2 map of zeros when `h5py` is missing or the read fails, which trains
on no supervision at all; the port does not copy that.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .images import load_gray


@dataclasses.dataclass
class SceneIndex:
    root: str
    image_paths: List[str]
    depth_paths: List[str]
    K: np.ndarray       # (N, 3, 3)
    qvec: np.ndarray    # (N, 4) world->cam
    tvec: np.ndarray    # (N, 3)
    tuples: np.ndarray  # (M, V) image indices; column 0 = reference view


def load_scene_index(path: str, root: Optional[str] = None) -> SceneIndex:
    z = np.load(path, allow_pickle=True)
    return SceneIndex(
        root=root or os.path.dirname(path),
        image_paths=[str(p) for p in z["image_paths"]],
        depth_paths=[str(p) for p in z["depth_paths"]],
        K=np.asarray(z["K"], np.float64),
        qvec=np.asarray(z["qvec"], np.float64),
        tvec=np.asarray(z["tvec"], np.float64),
        tuples=np.asarray(z["tuples"], np.int64),
    )


def shard_scenes(scene_paths: Sequence[str], process_index: int,
                 process_count: int, seed: int = 66) -> List[str]:
    """Deterministic per-process scene shard: permute, pad to the world
    size, strided split."""
    rng = np.random.default_rng(seed)
    paths = list(scene_paths)
    perm = rng.permutation(len(paths))
    paths = [paths[i] for i in perm]
    while len(paths) % max(process_count, 1) != 0:
        paths.append(paths[len(paths) % len(paths)])
    return paths[process_index::process_count]


class SceneBalancedSampler:
    """Yields (scene_id, tuple_id) pairs: n_per_scene samples per scene per
    epoch, with replacement, shuffled across scenes."""

    def __init__(self, n_tuples_per_scene: Sequence[int],
                 n_per_scene: int = 250, seed: int = 0):
        self.n_tuples = list(n_tuples_per_scene)
        self.n_per_scene = n_per_scene
        self.seed = seed

    def epoch(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        out = []
        for s, n in enumerate(self.n_tuples):
            if n == 0:
                continue
            ids = rng.integers(0, n, self.n_per_scene)
            out.append(np.stack([np.full_like(ids, s), ids], -1))
        all_ids = np.concatenate(out) if out else np.zeros((0, 2), np.int64)
        return all_ids[rng.permutation(len(all_ids))]


def read_depth(path: str) -> np.ndarray:
    """A depth map from .npy or .npz ("depth"); anything else raises."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        return np.load(path)["depth"]
    raise ValueError(
        f"cannot read depth map {path}: only .npy and .npz are read "
        f"(an HDF5 depth map needs h5py, which the port does not use; "
        f"convert it to .npy)")


class MegaDepthTupleDataset:
    """Loads one tuple into the trainer's batch dict format."""

    def __init__(self, scene: SceneIndex, img_size: int = 832, df: int = 8):
        self.scene = scene
        self.img_size = img_size
        self.df = df

    def __len__(self):
        return len(self.scene.tuples)

    def _load_image(self, rel_path: str):
        li = load_gray(os.path.join(self.scene.root, rel_path),
                       long_side=self.img_size, df=self.df,
                       pad_to=self.img_size)
        return li.data, (float(li.scale[0]), float(li.scale[1]))

    def _load_depth(self, rel_path: str, scale):
        d = read_depth(os.path.join(self.scene.root, rel_path))
        h, w = d.shape
        nh = min(self.img_size, int(round(h / scale[1])))
        nw = min(self.img_size, int(round(w / scale[0])))
        # Nearest resize keeps the zeros of missing depth.
        yi = (np.arange(nh) * (h / nh)).astype(np.int64).clip(0, h - 1)
        xi = (np.arange(nw) * (w / nw)).astype(np.int64).clip(0, w - 1)
        out = np.zeros((self.img_size, self.img_size), np.float32)
        out[:nh, :nw] = d[yi][:, xi]
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sc = self.scene
        images, depths, Ks, qs, ts = [], [], [], [], []
        for vi in sc.tuples[idx]:
            img, scale = self._load_image(sc.image_paths[vi])
            dep = self._load_depth(sc.depth_paths[vi], scale)
            K = sc.K[vi].copy()
            K[0] /= scale[0]
            K[1] /= scale[1]
            images.append(img[..., None])
            depths.append(dep)
            Ks.append(K)
            qs.append(sc.qvec[vi])
            ts.append(sc.tvec[vi])
        return {
            "images": np.stack(images).astype(np.float32),
            "depths": np.stack(depths).astype(np.float32),
            "K": np.stack(Ks).astype(np.float32),
            "qvec": np.stack(qs).astype(np.float32),
            "tvec": np.stack(ts).astype(np.float32),
        }


def collate(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([b[k] for b in batch]) for k in batch[0]}
