"""Batched, mesh-sharded pair-matching engine.

Port of the JAX package's match/engine.py. Pairs are staged on the host
into a fixed square frame and stacked into steps of `batch_size` pairs per
"data" row of the mesh (parallel/mesh.py), the last step padded with
repeats whose results are dropped; each row's block runs through that
device's copy of the matcher, built by models.build_matcher from the
engine's config. Every block of a step is launched before any is brought
back, and a step is launched before the previous one is collected.
Variable match counts come back as fixed-capacity slots with validity
masks; the conversion to original pixels, the optional rounding to a
pixel grid and the scene-level keypoint merge (ops/grid_merge.py) run on
the host, in pair order.

Every matcher keeps the two-stage contract of models/loftr.py's
PairMatcher, and the engine knows nothing else of its family: it runs
the per-image stage (`encode_views`) once per view of a call, not once
per pair side. Each row computes the distinct views that its blocks
read, in batches of `batch_size` frames (the last padded with repeats),
into a view store, and each step gathers its sides' views from the
store, which the matcher's forward takes in place of frames (the pair
stage alone, `match_views`). The LoFTR family's views hold the coarse
and the fine maps, ASpan's the coarse map alone, MatchFormer's (its
encoder attends across the two images) the frames and EfficientLoFTR's
RepVGG's 1/8, 1/4 and 1/2 maps (77.5 MB a view at 832 px; its fine stage
moves both images' keypoints off the cell grid). The store lives for
one call and sizes itself by the matcher's bytes a view (`view_bytes`).
Where a call's views do not fit half the card's free memory
(CPU_STORE_VIEWS off the card), consecutive steps are taken in groups
whose views fit, the store freed between groups; the steps and the
results keep the call's order either way.

Under a torch profiler (utils/profiler.py) each step records the spans
`engine/stage` (the step's sides' store rows and sizes, sharded and
copied to the cards), `engine/launch` (enqueue each card's block),
`engine/wait` (the blocking copy of the results to the host) and
`engine/unpack` (rescale, rounding, the result dicts); a store records
`engine/stage` (its frames to the cards) and `engine/launch` (the
per-image stage) once per group. Counters: `engine/pairs` (real pairs),
`engine/pad_pairs` (the repeats that fill the last step),
`engine/new_shapes` (steps and per-image batches whose shape this
process had not run before: where cuDNN times its algorithms),
`engine/views` (frames through the per-image stage, padding included)
and `engine/view_uses` (pair sides read from the store, 2 x real pairs).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.images import LoadedImage, load_gray
from ..device import compute_dtype
from ..models import MATCHER_NAMES, build_matcher
from ..models.loftr import MatcherConfig
from ..ops.grid_merge import merge_matches_to_keypoints
from ..parallel.mesh import mesh_of, replicate_module, shard_leading_axis
from ..utils.profiler import PassThroughProfiler, count, span

# The shape of every step and every per-image batch this process has
# launched.
_SHAPES_RUN: set = set()

# Views a store off the card holds (a card's store takes half its free
# memory instead).
CPU_STORE_VIEWS = 64


def _take(feats, rows):
    """The store's features (the matcher's views, a NamedTuple of
    tensors) at `rows`."""
    return type(feats)(*(f.index_select(0, rows) for f in feats))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    matcher: str = "loftr"         # a models.build_matcher name
    img_resize: int = 832          # padded square frame (long-side cap)
    df: int = 8                    # divisor for the 1/8 grid
    batch_size: int = 1            # pairs per device per step
    match_threshold: float = 0.2
    max_matches: int = 2048
    round_matches_ratio: Optional[int] = None  # quantize coords to N-px grid
    compute_dtype: str = "float32"  # or "bfloat16" (the matcher's compute)
    fused_matching: bool = False   # CUDA fused dual-softmax kernels
    fine_enabled: bool = False     # coarse_fine match type

    def __post_init__(self):
        # An unknown matcher name raises here, before any work; so does a
        # compute dtype other than float32 and bfloat16 (JAX would run it
        # in fp32).
        if self.matcher.lower() not in MATCHER_NAMES:
            raise ValueError(f"unknown matcher '{self.matcher}'")
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
    """Holds one copy of the matcher per device of the mesh; maps (name0,
    name1) pairs to original-pixel match arrays.

    `mesh` (parallel/mesh.py) or `device` (a one-entry mesh); neither
    means the default mesh, every visible card (None: CUDA, which must
    be present)."""

    def __init__(self, cfg: EngineConfig = EngineConfig(), params=None,
                 device=None, profiler=None, mesh=None):
        self.profiler = (profiler if profiler is not None
                         else PassThroughProfiler())
        self.cfg = cfg
        self.mesh = mesh_of(device, mesh)
        self.device = self.mesh.first
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # random init only; weights overwrite it
            self.model = build_matcher(
                cfg.matcher, **dataclasses.asdict(cfg.matcher_config()))
        if params is None:
            # Random weights give noise that looks like a pipeline bug
            # downstream; make it impossible to miss.
            print("WARNING: PairMatchingEngine initialized with RANDOM "
                  "matcher weights (params=None) - matches will be noise. "
                  "Pass trained params (utils.checkpoint."
                  "load_matcher_params or load_arch_params).",
                  file=sys.stderr)
        else:
            self.model.load_state_dict(params)
        # The parameters replicated: one model per "data" row, one copy
        # per distinct device (self.model is the first device's).
        self.models = replicate_module(self.model.to(self.device).eval(),
                                       self.mesh)

    # -- host-side data staging ---------------------------------------------

    def load_images(self, paths: Dict[str, str]) -> Dict[str, LoadedImage]:
        """Decode and resize all scene images with a host thread pool."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        names = list(paths)
        with self.profiler.record_function("engine/load_images"), \
                ThreadPoolExecutor(max_workers=8) as pool:
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
        n_dev = len(self.models)
        step = cfg.batch_size * n_dev
        devs = tuple(self.mesh.data_devices)
        out: Dict[Tuple[str, str], dict] = {}
        steps = []
        for start in range(0, len(pairs), step):
            chunk = list(pairs[start:start + step])
            n = len(chunk)
            while len(chunk) < step:  # pad with repeats; discarded
                chunk.append(chunk[-1])
            steps.append((chunk, n))
        # The per-image stage runs once per view of a group of steps (the
        # view store).
        groups = self._view_groups(steps, images) if steps else []

        def dispatch(chunk, n, store):
            """Stage one step and launch each device's block (asynchronous
            on the GPU)."""
            with span("engine/stage"):
                hw0 = np.array([(images[a].valid_size[1],
                                 images[a].valid_size[0])
                                for a, _ in chunk], np.int64)
                hw1 = np.array([(images[b].valid_size[1],
                                 images[b].valid_size[0])
                                for _, b in chunk], np.int64)
                # The sides' rows in their device's store.
                rows = [store[j // cfg.batch_size][0] for j in range(step)]
                side0 = np.array([r[a] for r, (a, _) in zip(rows, chunk)],
                                 np.int64)
                side1 = np.array([r[b] for r, (_, b) in zip(rows, chunk)],
                                 np.int64)
                blocks = shard_leading_axis((side0, side1, hw0, hw1),
                                            self.mesh)
            shape = ("step", cfg, devs, step,
                     images[chunk[0][0]].data.shape)
            count("engine/new_shapes", int(shape not in _SHAPES_RUN))
            _SHAPES_RUN.add(shape)
            count("engine/pairs", n)
            count("engine/pad_pairs", step - n)
            with span("engine/launch"):
                count("engine/view_uses", 2 * n)
                # Each side's views by row.
                blocks = [(_take(feats, i0), _take(feats, i1), h0, h1)
                          for (i0, i1, h0, h1), (_, feats)
                          in zip(blocks, store)]
                res = [model(*blk) for model, blk in zip(self.models,
                                                         blocks)]
            return chunk, n, res

        def collect(chunk, n, res):
            with span("engine/wait"):
                c0, c1, conf, valid = (
                    np.concatenate([r[k].cpu().numpy() for r in res])
                    for k in range(4))
            with span("engine/unpack"):
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

        # One-deep software pipeline: launch step i+1 before bringing back
        # step i's results, so host staging overlaps device compute.
        pending = store = None
        with self.profiler.record_function("engine/match_forward"):
            for i, (chunk, n) in enumerate(steps):
                if groups and i == groups[0][0]:
                    store = None  # the last group's views go first
                    store = self._build_store(groups.pop(0)[1], images)
                nxt = dispatch(chunk, n, store)
                if pending is not None:
                    collect(*pending)
                pending = nxt
            if pending is not None:
                collect(*pending)
        return out

    # -- the view store -------------------------------------------------------

    def _store_capacity(self, frame: Tuple[int, int]) -> list:
        """Views each "data" row's store may hold, a multiple of
        `batch_size` and at least one step's 2 x `batch_size`: half the
        card's free memory (the caching allocator's spare blocks count as
        free), split between the rows on that card, over the bytes of what
        a view holds (the matcher's `view_bytes`); CPU_STORE_VIEWS off the
        card."""
        bs = self.cfg.batch_size
        view_bytes = self.model.view_bytes(*frame)
        devs = self.mesh.data_devices
        caps = []
        for dev in devs:
            if dev.type == "cuda":
                free = (torch.cuda.mem_get_info(dev)[0]
                        + torch.cuda.memory_reserved(dev)
                        - torch.cuda.memory_allocated(dev))
                views = free // 2 // devs.count(dev) // view_bytes
            else:
                views = CPU_STORE_VIEWS
            caps.append(max(views // bs * bs, 2 * bs))
        return caps

    def _view_groups(self, steps, images) -> list:
        """[(first step, each row's views)]: runs of consecutive steps
        whose distinct views fit every row's store, from the first step
        on; a row's views in the order its blocks first read them."""
        bs = self.cfg.batch_size
        caps = self._store_capacity(images[steps[0][0][0][0]].data.shape)
        groups = []
        for i, (chunk, _) in enumerate(steps):
            views = [dict.fromkeys(v for pair in chunk[d * bs:(d + 1) * bs]
                                   for v in pair)
                     for d in range(len(self.models))]
            if groups:
                merged = [{**h, **v} for h, v in zip(groups[-1][1], views)]
                if all(len(m) <= c for m, c in zip(merged, caps)):
                    groups[-1] = (groups[-1][0], merged)
                    continue
            groups.append((i, views))
        return groups

    def _build_store(self, rows, images) -> list:
        """Per "data" row: ({view: row}, the matcher's views of the rows)
        of the row's views, run through its device's per-image stage in
        batches of exactly `batch_size` frames (the last padded with
        repeats), so that each frame size has one per-image shape."""
        bs = self.cfg.batch_size
        store = []
        for model, dev, held in zip(self.models, self.mesh.data_devices,
                                    rows):
            names = list(held)
            names += names[-1:] * (-len(names) % bs)
            with span("engine/stage"):
                frames = torch.from_numpy(np.stack(
                    [images[v].data for v in names])).unsqueeze(-1).to(
                        dev, non_blocking=True)
            shape = ("views", self.cfg, dev, bs, frames.shape[1:])
            count("engine/new_shapes", int(shape not in _SHAPES_RUN))
            _SHAPES_RUN.add(shape)
            count("engine/views", len(names))
            feats = None
            with span("engine/launch"):
                for k in range(0, len(names), bs):
                    part = model.encode_views(frames[k:k + bs])
                    if feats is None:
                        feats = [f.new_empty((len(names),) + f.shape[1:])
                                 for f in part]
                    for f, p in zip(feats, part):
                        f[k:k + bs] = p
            store.append(({v: r for r, v in enumerate(held)},
                          type(part)(*feats)))
        return store

    def match_scene(self, pairs: Sequence[Tuple[str, str]],
                    image_paths: Dict[str, str]):
        """Match all pairs, then merge endpoints into per-image ranked
        keypoints and index matches."""
        images = self.load_images(image_paths)
        raw = self.match_pairs(pairs, images)
        with self.profiler.record_function("engine/keypoint_merge"):
            keypoints, scores, match_indices = merge_matches_to_keypoints(raw)
        return keypoints, scores, match_indices, raw
