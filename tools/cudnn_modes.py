#!/usr/bin/env python3
"""The match stage's cost of cuDNN's algorithm choice, by mode, dtype and
frame size, on a CUDA card.

    python3 tools/cudnn_modes.py [--sizes 832,1600] [--dtypes float32,bfloat16]
                                 [--modes benchmark,limit3,limit1,heuristic]

cuDNN keeps its algorithm choices per process, so every (size, dtype,
mode) runs in a child process of its own:

  benchmark  torch.backends.cudnn.benchmark = True with torch's default
             benchmark_limit (10): cuDNN times up to 10 algorithms for each
             new convolution shape
  limitN     benchmark mode with torch.backends.cudnn.benchmark_limit = N
  heuristic  benchmark mode off: cuDNN's heuristic picks each algorithm

Each child builds the port's engine as the `reconstruct` verb does on the
card (r5 matcher, coarse_fine, matches rounded to 4 px, one batch of 8
pairs, the fused kernels above 12 000 coarse tokens), sets the mode, and
matches the 6 pairs of generate_scene(seed=0, size, n_views=4): the first
batch's seconds (cuDNN's timing included), then the median of `--warm`
warm batches. The match rows go to build/cudnn_modes/; the parent says
whether each mode's match set equals benchmark mode's at the same size
and dtype (IoU per pair where it does not). One JSON line per child, and a
summary with the card's name and power limit as the last line; the whole
report in build/cudnn_modes/report.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, "build", "cudnn_modes")
WEIGHTS = os.path.join(REPO, "weights", "demo_matcher_r5_bf16.msgpack")


def _scene(size: int):
    """The 4 views of generate_scene(seed=0, size), rendered once."""
    from detectorfreesfm_tpu_torch.data.synthetic import (SyntheticConfig,
                                                          generate_scene)

    path = os.path.join(WORK, f"scene_{size}.npz")
    if not os.path.exists(path):
        imgs = generate_scene(0, SyntheticConfig(size=size, n_views=4))[0]
        np.savez(path, imgs=imgs)
    return np.load(path)["imgs"]


def _child(size: int, dtype: str, mode: str, warm: int) -> dict:
    import torch

    from detectorfreesfm_tpu_torch.data.images import from_array
    from detectorfreesfm_tpu_torch.match.engine import (EngineConfig,
                                                        PairMatchingEngine)
    from detectorfreesfm_tpu_torch.match.pairs import exhaustive_pairs
    from detectorfreesfm_tpu_torch.ops import fused_dsm
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_matcher_params)

    imgs = _scene(size)
    names = [f"view_{i}" for i in range(len(imgs))]
    images = {n: from_array(imgs[i]) for i, n in enumerate(names)}
    pairs = exhaustive_pairs(names)
    fused = (size // 8) ** 2 > 12000  # the verb's --fused auto
    engine = PairMatchingEngine(EngineConfig(
        img_resize=size, fine_enabled=True, round_matches_ratio=4,
        fused_matching=fused, batch_size=8, compute_dtype=dtype),
        load_matcher_params(WEIGHTS))
    # The engine's matcher has set its dtype's backends; the mode goes on
    # top of them.
    if mode == "heuristic":
        torch.backends.cudnn.benchmark = False
    else:
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.benchmark_limit = (
            int(mode[5:]) if mode.startswith("limit") else 10)
    for k in fused_dsm.launches:
        fused_dsm.launches[k] = 0

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = engine.match_pairs(pairs, images)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, raw

    first_s, raw = run()
    warm_s = sorted(run()[0] for _ in range(warm))
    rows = {f"{a}|{b}": np.concatenate([m["kpts0"], m["kpts1"]], 1)
            for (a, b), m in raw.items()}
    np.savez(os.path.join(WORK, f"{size}_{dtype}_{mode}.npz"), **rows)
    return dict(size=size, dtype=dtype, mode=mode, pairs=len(pairs),
                fused=fused, first_batch_s=first_s, warm_s=warm_s,
                warm_median_s=warm_s[len(warm_s) // 2],
                warm_pairs_per_s=len(pairs) / warm_s[len(warm_s) // 2],
                launches=dict(fused_dsm.launches),
                valid=int(sum(len(r) for r in rows.values())),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _same_matches(size, dtype, mode) -> dict:
    """Whether `mode`'s match rows equal benchmark mode's, pair by pair."""
    a = np.load(os.path.join(WORK, f"{size}_{dtype}_{mode}.npz"))
    b = np.load(os.path.join(WORK, f"{size}_{dtype}_benchmark.npz"))
    out = {"identical": sorted(a.files) == sorted(b.files) and all(
        np.array_equal(a[k], b[k]) for k in a.files)}
    if not out["identical"]:
        ious = {}
        for k in a.files:
            x = {tuple(r) for r in a[k].tolist()}
            y = {tuple(r) for r in b[k].tolist()}
            ious[k] = len(x & y) / max(len(x | y), 1)
        out["iou_min"] = min(ious.values())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="832,1600")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--modes", default="benchmark,limit3,limit1,heuristic")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds per child")
    args = ap.parse_args()
    os.makedirs(WORK, exist_ok=True)
    if args.child:
        size, dtype, mode = args.child.split(":")
        print(json.dumps(_child(int(size), dtype, mode, args.warm)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    results = []
    for size in map(int, args.sizes.split(",")):
        for dtype in args.dtypes.split(","):
            for mode in args.modes.split(","):
                t0 = time.time()
                out = None
                try:
                    out = subprocess.run(
                        [sys.executable, os.path.abspath(__file__),
                         "--child", f"{size}:{dtype}:{mode}",
                         "--warm", str(args.warm)], capture_output=True,
                        text=True, timeout=args.timeout)
                    res = json.loads(out.stdout.strip().splitlines()[-1])
                except (subprocess.TimeoutExpired, ValueError,
                        IndexError) as e:
                    res = dict(size=size, dtype=dtype, mode=mode,
                               error=repr(e)[:300],
                               stderr=out.stderr[-1500:] if out else None)
                res["process_s"] = time.time() - t0
                if "error" not in res and mode != "benchmark":
                    res["matches_vs_benchmark"] = _same_matches(size, dtype,
                                                                mode)
                print(json.dumps(res), flush=True)
                results.append(res)
    with open(os.path.join(WORK, "report.json"), "w") as f:
        json.dump({"card": smi, "results": results}, f, indent=1)
    print(json.dumps({"card": smi, "n": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
