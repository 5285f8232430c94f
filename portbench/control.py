#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, for many
seeds in one process (the benchmark's own runs never run this):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5

For each seed: the cell's set-up and a short window of the program, then
the same comparison a run makes, of the program (`program`) and of the
control (`control`): the plain reference computed in TF32, the precision
just below the configurations' float32, put in the program's place. One
JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(harness, cell, seed, seconds, device):
    import gc

    import torch

    spec = harness.load_json("workloads", cell)
    config = harness.load_json("configs", spec["config"])
    driver = harness.load_driver(spec["driver"])(spec, config, seed, device,
                                                 harness.ROOT)
    t0 = time.perf_counter()
    driver.setup(False)
    setup_s = time.perf_counter() - t0
    done, span, _, _, _ = harness.measure(driver, seconds, False, None)
    driver.release()
    gc.collect()
    torch.cuda.empty_cache()
    keys = driver.sample()
    t0 = time.perf_counter()
    ref = driver.reference(keys, "fp32")
    ref_s = time.perf_counter() - t0
    prog = driver.compare(driver.outputs, ref)
    ctrl = driver.compare(driver.as_program(driver.reference(keys, "tf32")),
                          ref)
    as_dict = lambda cs: {c["name"]: c["value"] for c in cs}  # noqa: E731
    return {"cell": cell, "seed": seed, "setup_s": setup_s,
            "rate": done / span, "compared": len(keys),
            "reference_s": ref_s, "program": as_dict(prog),
            "control": as_dict(ctrl)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(harness, args.workload, seed,
                                  args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
