"""Batched pair-matching engine on one GPU.

Port of the JAX package's match/engine.py. The mesh becomes a plain batch:
pairs are staged on the host into a fixed square frame, stacked into
batches of `batch_size` (the last one padded with repeats, whose results are
dropped), and run through one DetectorFreeMatcher forward each. Variable
match counts come back as fixed-capacity slots with validity masks; the
conversion to original pixels, the optional rounding to a pixel grid and
the scene-level keypoint merge (ops/grid_merge.py) run on the host.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.images import LoadedImage, load_gray
from ..device import compute_dtype, resolve_device
from ..models.loftr import DetectorFreeMatcher, MatcherConfig
from ..ops.grid_merge import merge_matches_to_keypoints


LOFTR_FAMILY = ("loftr", "loftr_official", "detectorfree")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    matcher: str = "loftr"         # the LoFTR family only (see __post_init__)
    img_resize: int = 832          # padded square frame (long-side cap)
    df: int = 8                    # divisor for the 1/8 grid
    batch_size: int = 1            # pairs per forward
    match_threshold: float = 0.2
    max_matches: int = 2048
    round_matches_ratio: Optional[int] = None  # quantize coords to N-px grid
    compute_dtype: str = "float32"  # or "bfloat16" (the matcher's compute)
    fused_matching: bool = False   # CUDA fused dual-softmax kernels
    fine_enabled: bool = False     # coarse_fine match type

    def __post_init__(self):
        # The JAX engine's other matchers are not ported: refuse rather
        # than run LoFTR in their place. A compute dtype other than
        # float32 and bfloat16 raises too (JAX would run it in fp32).
        if self.matcher not in LOFTR_FAMILY:
            raise NotImplementedError(
                f"matcher {self.matcher!r} is not ported yet (ROADMAP item "
                f"15); the port runs the LoFTR family {LOFTR_FAMILY}")
        compute_dtype(self.compute_dtype)

    def matcher_config(self) -> MatcherConfig:
        return MatcherConfig(
            match_threshold=self.match_threshold,
            max_matches=self.max_matches,
            compute_dtype=self.compute_dtype,
            fused_matching=self.fused_matching,
            fine_enabled=self.fine_enabled,
        )


class PairMatchingEngine:
    """Holds the matcher on its device; maps (name0, name1) pairs to
    original-pixel match arrays."""

    def __init__(self, cfg: EngineConfig = EngineConfig(), params=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # random init only; weights overwrite it
            self.model = DetectorFreeMatcher(cfg.matcher_config())
        if params is None:
            # Random weights give noise that looks like a pipeline bug
            # downstream; make it impossible to miss.
            print("WARNING: PairMatchingEngine initialized with RANDOM "
                  "matcher weights (params=None) - matches will be noise. "
                  "Pass trained params (utils.checkpoint."
                  "load_matcher_params).", file=sys.stderr)
        else:
            self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    # -- host-side data staging ---------------------------------------------

    def load_images(self, paths: Dict[str, str]) -> Dict[str, LoadedImage]:
        """Decode and resize all scene images with a host thread pool."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        names = list(paths)
        with ThreadPoolExecutor(max_workers=8) as pool:
            imgs = list(pool.map(
                lambda n: load_gray(paths[n], long_side=cfg.img_resize,
                                    df=cfg.df, pad_to=cfg.img_resize),
                names))
        return dict(zip(names, imgs))

    # -- matching -------------------------------------------------------------

    @torch.no_grad()
    def match_pairs(self, pairs: Sequence[Tuple[str, str]],
                    images: Dict[str, LoadedImage]
                    ) -> Dict[Tuple[str, str], dict]:
        """Run all pairs; returns {(n0, n1): {kpts0, kpts1, conf}} in
        original pixel coordinates with invalid slots dropped."""
        cfg = self.cfg
        step = cfg.batch_size
        out: Dict[Tuple[str, str], dict] = {}

        def to_dev(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        def dispatch(start):
            """Stage and launch one batch (asynchronous on the GPU)."""
            chunk = list(pairs[start:start + step])
            n = len(chunk)
            while len(chunk) < step:  # pad with repeats; results discarded
                chunk.append(chunk[-1])
            img0 = np.stack([images[a].data for a, _ in chunk])[..., None]
            img1 = np.stack([images[b].data for _, b in chunk])[..., None]
            hw0 = np.array([(images[a].valid_size[1], images[a].valid_size[0])
                            for a, _ in chunk], np.int64)
            hw1 = np.array([(images[b].valid_size[1], images[b].valid_size[0])
                            for _, b in chunk], np.int64)
            res = self.model(to_dev(img0), to_dev(img1), to_dev(hw0),
                             to_dev(hw1))
            return chunk, n, res

        def collect(chunk, n, res):
            c0, c1, conf, valid = (t.cpu().numpy() for t in res)
            for i, (a, b) in enumerate(chunk[:n]):
                v = valid[i]
                k0 = c0[i][v] * images[a].scale[None, :]
                k1 = c1[i][v] * images[b].scale[None, :]
                if cfg.round_matches_ratio:
                    r = float(cfg.round_matches_ratio)
                    k0 = np.round(k0 / r) * r
                    k1 = np.round(k1 / r) * r
                out[(a, b)] = {
                    "kpts0": k0.astype(np.float32),
                    "kpts1": k1.astype(np.float32),
                    "conf": conf[i][v].astype(np.float32),
                }

        # One-deep software pipeline: launch batch i+1 before bringing back
        # batch i's results, so host staging overlaps device compute.
        pending = None
        for start in range(0, len(pairs), step):
            nxt = dispatch(start)
            if pending is not None:
                collect(*pending)
            pending = nxt
        if pending is not None:
            collect(*pending)
        return out

    def match_scene(self, pairs: Sequence[Tuple[str, str]],
                    image_paths: Dict[str, str]):
        """Match all pairs, then merge endpoints into per-image ranked
        keypoints and index matches."""
        images = self.load_images(image_paths)
        raw = self.match_pairs(pairs, images)
        keypoints, scores, match_indices = merge_matches_to_keypoints(raw)
        return keypoints, scores, match_indices, raw
