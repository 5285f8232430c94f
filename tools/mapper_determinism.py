#!/usr/bin/env python3
"""Is the port's mapper the same from run to run on a CUDA card?

    python3 tools/mapper_determinism.py [--runs 2]

Runs the mapper on tests/data/torch/demo_cached_832 (chip_smoke.py's sfm
input (b)) `--runs` times with bundle adjustment's segment sums in torch's
deterministic mode (as sfm/ba.py runs them), then as many times with plain
`index_add_` (float atomics on CUDA), then deterministic again. Prints one
line per run: mode, points, mean reprojection error, wall and BA seconds.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from detectorfreesfm_tpu_torch.device import set_fp32_backends  # noqa: E402
from detectorfreesfm_tpu_torch.sfm import ba  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    set_fp32_backends()  # as chip_smoke.py runs the mapper
    kps, matches, side = chip_smoke.demo_caches()["b"]
    backend = chip_smoke.PortSfm("cuda")
    deterministic = ba._index_add
    for mode in ("deterministic", "atomic", "deterministic"):
        ba._index_add = deterministic if mode == "deterministic" else (
            lambda out, ids, data: out.index_add_(0, ids, data))
        for r in range(args.runs):
            mapper = backend.mapper(**chip_smoke.demo_mapper_kwargs(kps, side))
            t0 = time.time()
            rec = mapper.run(kps, matches,
                             {n: chip_smoke.DEMO_SIZES[n] for n in kps}, None)
            nums = chip_smoke.model_numbers(rec)
            print(mode, r, nums["n_points"], nums["mean_reproj_px"],
                  time.time() - t0, mapper.times["ba"], flush=True)
    ba._index_add = deterministic
    return 0


if __name__ == "__main__":
    sys.exit(main())
