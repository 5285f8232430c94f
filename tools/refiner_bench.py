#!/usr/bin/env python3
"""Time the port's multiview refiner forward on a CUDA card, by cuDNN mode.

    python3 tools/refiner_bench.py [--iters 5]

Runs one child process per mode (cuDNN's algorithms cache per process):

  benchmark  torch.backends.cudnn.benchmark = True: cuDNN times its
             algorithms at the first call of each shape
  heuristic  benchmark off: cuDNN's heuristic picks the algorithms

In each, the refiner with the bundled r4 weights runs chunks of the
refinement loop's shape (512 tracks x 16 views = 8 192 patches) at the two
iterations' crops (19 = window 15 + 4, then 15 = window 11 + 4), fp32 with
TF32 off, on random 832 px images. Reports the first call's ms and the
median of the next `--iters` calls with CUDA events. Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _child(mode: str, iters: int) -> dict:
    from detectorfreesfm_tpu_torch.core.precision import geometry_precision
    from detectorfreesfm_tpu_torch.models.multiview_matcher import (
        MultiviewRefiner,
        RefinerConfig,
    )
    from detectorfreesfm_tpu_torch.utils.checkpoint import (
        load_refiner_params,
    )

    params = load_refiner_params(os.path.join(
        REPO, "weights", "demo_refiner_r4_bf16.msgpack"))
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    T, V, size = 512, 16, 832
    images = torch.tensor(rng.uniform(0, 1, (4, size, size, 1)),
                          dtype=torch.float32, device=dev)
    batch = (torch.tensor(rng.integers(0, 4, (T, V)), device=dev),
             torch.tensor(rng.uniform(20, size - 20, (T, V, 2)),
                          dtype=torch.float32, device=dev),
             torch.tensor(rng.uniform(0.7, 1.4, (T, V)),
                          dtype=torch.float32, device=dev),
             torch.tensor(rng.uniform(size=(T, V)) > 0.7, device=dev))
    out = {}
    for window in (15, 11):
        model = MultiviewRefiner(RefinerConfig(crop_size=window + 4,
                                               window=window))
        model.load_state_dict(params)
        model.to(dev).eval()
        times = []
        for _ in range(iters + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with geometry_precision(), torch.backends.cudnn.flags(
                    enabled=True, benchmark=mode == "benchmark",
                    deterministic=False, allow_tf32=False), torch.no_grad():
                start.record()
                model(images, *batch)
                end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[f"crop_{window + 4}"] = dict(first_ms=times[0],
                                         median_ms=float(np.median(
                                             times[1:])))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--child", choices=("benchmark", "heuristic"))
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.child, args.iters)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"card": smi}
    for mode in ("heuristic", "benchmark"):
        proc = subprocess.run([sys.executable, __file__, "--child", mode,
                               "--iters", str(args.iters)],
                              capture_output=True, text=True, check=True)
        res[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
